"""K1 ``anchor_scores`` and K3 ``gather_decode_pairs``: the two kernels of
the tail that read the cell-layout heads.

K1 replaces ``viddet_tpu/ops/nms_gather_pallas.py:611`` ``anchor_scores``
(``_score_kernel``, ``:519``); its CUDA kernel is ``csrc/anchor_scores.cu``.
K3 replaces ``:698`` ``gather_decode_pairs`` (``_make_kernel``, ``:202``)
in its ``extract_m=0`` form, the one the deterministic ranking runs; its
CUDA kernel is ``csrc/gather_decode.cu``.  Each source's header says what
bounds it on an H100 and how its design answers that.  Each ``*_plain``
function is the same function in plain PyTorch: the wrapper runs it for a
CPU tensor, and for a CUDA tensor the wrapper launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from viddet_tpu_torch.kernels import build, require

MAX_SCALES = 3
MAX_ANCHORS = 8  # anchors per scale in csrc/gather_decode.cu's table


def anchor_scores_plain(cells: Sequence[torch.Tensor], na: int) -> torch.Tensor:
    """(B, N) float32 ``sigmoid(obj) * sigmoid(max_c cls)`` per anchor.

    ``cells``: per-scale (B, h*w, na*(5+C)) raw head tensors, deepest scale
    first; lane group ``[a*(5+C), (a+1)*(5+C))`` is anchor a.  The flat
    order is (scale, cell, anchor).  The max runs in the raw dtype.
    """
    b = cells[0].shape[0]
    out = []
    for x in cells:
        v = x.reshape(b, x.shape[1], na, x.shape[2] // na)
        obj = torch.sigmoid(v[..., 4].float())
        cls_max = torch.sigmoid(v[..., 5:].amax(dim=-1).float())
        out.append((obj * cls_max).reshape(b, -1))
    return torch.cat(out, dim=1)


def anchor_scores(cells: Sequence[torch.Tensor], na: int) -> torch.Tensor:
    """K1 wrapper: the kernel for CUDA tensors, the plain version on the CPU."""
    cells = tuple(cells)
    if cells[0].device.type == "cpu":
        return anchor_scores_plain(cells, na)
    if not 1 <= len(cells) <= MAX_SCALES:
        raise ValueError(f"anchor_scores takes 1..{MAX_SCALES} scales, got {len(cells)}")
    b, _, lanes = cells[0].shape
    if lanes % na or lanes // na < 6:
        raise ValueError(f"{lanes} lanes do not split into {na} anchors of 5+C")
    for i, x in enumerate(cells):
        require(x, f"cells[{i}]", (torch.bfloat16, torch.float32),
                shape=(b, x.shape[1], lanes), device=cells[0].device)
        if x.dtype != cells[0].dtype:
            raise TypeError("anchor_scores: all scales must share one dtype")
    n = sum(x.shape[1] for x in cells) * na
    out = torch.empty((b, n), dtype=torch.float32, device=cells[0].device)
    ptrs = [x.data_ptr() for x in cells] + [None] * (MAX_SCALES - len(cells))
    sizes = [x.shape[1] for x in cells] + [0] * (MAX_SCALES - len(cells))
    err = build.library().viddet_anchor_scores(
        *ptrs, *sizes, len(cells), b, na, lanes // na,
        int(cells[0].dtype == torch.bfloat16), out.data_ptr(), build.stream_of(out),
    )
    build.check(err, "anchor_scores")
    anchor_scores.launches += 1
    return out


anchor_scores.launches = 0


# ---------------------------------------------------------------------------
# K3: gather, late decode and pair scores of the stage-1 winners
# ---------------------------------------------------------------------------


def scale_constants(h: int, w: int, anchors, stride: int, device=None):
    """Per-scale decode constants in (row, col, anchor) order
    (``viddet_tpu/models/yolo3.py:75``): grid_xy (N, 2), anchor_wh (N, 2),
    strides (N, 1), float32, N = h*w*len(anchors)."""
    na = len(anchors)
    gy, gx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=device),
        torch.arange(w, dtype=torch.float32, device=device),
        indexing="ij",
    )
    grid_xy = torch.stack([gx, gy], dim=-1)[:, :, None, :].expand(h, w, na, 2).reshape(-1, 2)
    anchor_wh = (
        torch.tensor(anchors, dtype=torch.float32, device=device)
        .view(1, 1, na, 2).expand(h, w, na, 2).reshape(-1, 2)
    )
    strides = torch.full((h * w * na, 1), float(stride), dtype=torch.float32, device=device)
    return grid_xy, anchor_wh, strides


def decode_constants(meta, device=None):
    """Concatenated (grid_xy, anchor_wh, stride_n) over the scales of
    ``meta`` (per scale ``(cells, width, stride, anchors)``, deepest first)."""
    per = [scale_constants(cells // width, width, anchors, stride, device)
           for cells, width, stride, anchors in meta]
    return tuple(torch.cat([p[i] for p in per], dim=0) for i in range(3))


def decode_winners(raw_k, a_idx, grid_xy, anchor_wh, stride_n):
    """Late decode of the k winners' float32 head rows (B, k, 5+C):
    boxes (B, k, 4) and pair scores (B, k, C), in the reference's float
    expression order (``viddet_tpu/ops/nms.py:320-333``)."""
    xy_k, wh_k = raw_k[..., 0:2], raw_k[..., 2:4]
    center = (torch.sigmoid(xy_k) + grid_xy[a_idx]) * stride_n[a_idx]
    half = 0.5 * (torch.exp(wh_k) * anchor_wh[a_idx])
    boxes_k = torch.cat([center - half, center + half], dim=-1)
    obj_k = torch.sigmoid(raw_k[..., 4])
    pair_scores = obj_k[..., None] * torch.sigmoid(raw_k[..., 5:])
    return boxes_k, pair_scores


def gather_decode_pairs_plain(cells: Sequence[torch.Tensor], a_idx: torch.Tensor,
                              meta) -> Tuple[torch.Tensor, torch.Tensor]:
    """(boxes (B, k, 4), pair scores (B, k, C)) float32 of the winners.

    ``cells``: per-scale (B, h*w, na*(5+C)) raw head tensors, deepest scale
    first; ``a_idx`` (B, k) int64 flat (scale, cell, anchor) indices;
    ``meta``: per scale ``(cells, width, stride, anchors)``.
    """
    na = len(meta[0][3])
    b, k = a_idx.shape
    num_pred = cells[0].shape[-1] // na
    raw = torch.cat([x.reshape(b, -1, num_pred) for x in cells], dim=1)
    raw_k = raw.gather(1, a_idx[..., None].expand(b, k, num_pred)).float()
    grid_xy, anchor_wh, stride_n = decode_constants(meta, a_idx.device)
    return decode_winners(raw_k, a_idx, grid_xy, anchor_wh, stride_n)


def gather_decode_pairs(cells: Sequence[torch.Tensor], a_idx: torch.Tensor,
                        meta) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 wrapper: the kernel for CUDA tensors, the plain version on the CPU."""
    cells = tuple(cells)
    if cells[0].device.type == "cpu":
        return gather_decode_pairs_plain(cells, a_idx, meta)
    na = len(meta[0][3])
    if not 1 <= len(cells) == len(meta) <= MAX_SCALES:
        raise ValueError(f"gather_decode_pairs takes 1..{MAX_SCALES} scales, one per meta entry")
    if not 1 <= na <= MAX_ANCHORS or any(len(m[3]) != na for m in meta):
        raise ValueError(f"gather_decode_pairs needs 1..{MAX_ANCHORS} anchors on every scale")
    b, _, lanes = cells[0].shape
    if lanes % na or lanes // na < 6:
        raise ValueError(f"{lanes} lanes do not split into {na} anchors of 5+C")
    for i, (x, m) in enumerate(zip(cells, meta)):
        require(x, f"cells[{i}]", (torch.bfloat16, torch.float32),
                shape=(b, m[0], lanes), device=cells[0].device)
        if x.dtype != cells[0].dtype:
            raise TypeError("gather_decode_pairs: all scales must share one dtype")
    if a_idx.dim() != 2 or a_idx.shape[0] != b:
        raise ValueError(f"a_idx must be (B={b}, k), got {tuple(a_idx.shape)}")
    require(a_idx, "a_idx", torch.int64, device=cells[0].device)
    k, c = a_idx.shape[1], lanes // na - 5
    dev = cells[0].device
    boxes = torch.empty((b, k, 4), dtype=torch.float32, device=dev)
    pairs = torch.empty((b, k, c), dtype=torch.float32, device=dev)
    pad = MAX_SCALES - len(cells)
    strides = (ctypes.c_float * len(meta))(*(float(m[2]) for m in meta))
    anchors = (ctypes.c_float * (2 * na * len(meta)))(
        *(float(v) for m in meta for wh in m[3] for v in wh))
    err = build.library().viddet_gather_decode(
        *([x.data_ptr() for x in cells] + [None] * pad),
        *([m[0] for m in meta] + [0] * pad), *([m[1] for m in meta] + [1] * pad),
        ctypes.addressof(strides), ctypes.addressof(anchors), len(cells), b, k, na, lanes // na,
        int(cells[0].dtype == torch.bfloat16), a_idx.data_ptr(), boxes.data_ptr(),
        pairs.data_ptr(), build.stream_of(boxes),
    )
    build.check(err, "gather_decode_pairs")
    gather_decode_pairs.launches += 1
    return boxes, pairs


gather_decode_pairs.launches = 0
