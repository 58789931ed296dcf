"""K1 ``anchor_scores``, K3 ``gather_decode_pairs`` and K4
``finalize_candidates``: the kernels of the tail that read the cell-layout
heads and map the stage-2 winners back.

K1 replaces ``viddet_tpu/ops/nms_gather_pallas.py:611`` ``anchor_scores``
(``_score_kernel``, ``:519``); its CUDA kernel is ``csrc/anchor_scores.cu``.
K3 replaces ``:698`` ``gather_decode_pairs`` (``_make_kernel``, ``:202``)
in both forms, ``csrc/gather_decode.cu``: ``extract_m=0``, the one the
deterministic ranking runs (wrapper ``gather_decode_pairs``), and
``extract_m=m`` with ``hot_j``, the one the hierarchical ranking runs
(wrapper ``gather_decode_top_m``, which ``gather_decode_pairs`` calls when
``extract_m`` > 0).  K4 replaces ``:480`` ``finalize_candidates``
(``_finalize_kernel``, ``:387``), ``csrc/finalize.cu``.  Each source's
header says what bounds it on an H100 and how its design answers that.
Each ``*_plain`` function is the same function in plain PyTorch: the
wrapper runs it for a CPU tensor, and for a CUDA tensor the wrapper
launches the kernel or raises.  Each kernel is a custom op
(``viddet::anchor_scores``, ``viddet::gather_decode_pairs``,
``viddet::gather_decode_top_m``, ``viddet::finalize_candidates``;
``ops/__init__.py``) whose CUDA implementation launches it; K3's ``meta``
crosses the op as flat lists (``meta_args``).
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from viddet_tpu_torch.kernels import build, on_card, require

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
    on_card(cells[0], "anchor_scores")
    return torch.ops.viddet.anchor_scores(list(cells), int(na))


@torch.library.custom_op("viddet::anchor_scores", mutates_args=(), device_types="cpu")
def _anchor_scores_op(cells: List[torch.Tensor], na: int) -> torch.Tensor:
    return anchor_scores_plain(cells, na)


@_anchor_scores_op.register_kernel("cuda")
def _anchor_scores_cuda(cells, na):
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


@_anchor_scores_op.register_fake
def _(cells, na):
    return cells[0].new_empty((cells[0].shape[0], sum(x.shape[1] for x in cells) * na),
                              dtype=torch.float32)


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


def extract_top_m_plain(pairs: torch.Tensor, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row top-m of (B, k, C) pair scores by m argmax steps
    (``viddet_tpu/ops/nms_gather_pallas.py:127`` ``_extract_top_m``): each
    step takes the row's max and the lowest class index holding it, then
    masks that slot to -inf; steps past C give (-inf, 0).  Returns
    (v_m (B, k, m) float32, i_m (B, k, m) int64)."""
    c = pairs.shape[-1]
    iota = torch.arange(c, device=pairs.device)
    cur = pairs
    vals, idxs = [], []
    for _ in range(m):
        mx = cur.amax(dim=-1)
        im = torch.where(cur == mx[..., None], iota, c).amin(dim=-1)
        vals.append(mx)
        idxs.append(im)
        cur = torch.where(iota == im[..., None], float("-inf"), cur)
    return torch.stack(vals, dim=-1), torch.stack(idxs, dim=-1)


def hot_rows_plain(pairs: torch.Tensor, v_m: torch.Tensor, i_m: torch.Tensor,
                   hot_j: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pigeonhole repair set (``nms_gather_pallas.py:324-382``): the
    hot_j winners ranked highest by their m-th value (descending, lowest
    winner index first on ties, as the TPU kernel's all-pairs rank orders
    them), their full pair rows with their top-(m-1) classes set to -1.0.
    Returns (hot_flat (B, hot_j, C) float32, hot_idx (B, 1, hot_j) int64)."""
    b, k, c = pairs.shape
    m = v_m.shape[-1]
    # A stable descending sort orders exactly as the rank does.
    hot = torch.sort(v_m[..., m - 1], dim=1, descending=True, stable=True).indices[:, :hot_j]
    rows = pairs.gather(1, hot[..., None].expand(b, hot_j, c))
    top = i_m[..., : m - 1].gather(1, hot[..., None].expand(b, hot_j, m - 1))
    dup = torch.zeros_like(rows, dtype=torch.bool).scatter_(2, top, True)
    return torch.where(dup, -1.0, rows), hot[:, None, :]


def gather_decode_pairs_plain(cells: Sequence[torch.Tensor], a_idx: torch.Tensor, meta,
                              extract_m: int = 0, hot_j: int = 0):
    """The winners' boxes and pair scores, float32.

    ``cells``: per-scale (B, h*w, na*(5+C)) raw head tensors, deepest scale
    first; ``a_idx`` (B, k) int64 flat (scale, cell, anchor) indices;
    ``meta``: per scale ``(cells, width, stride, anchors)``.

    Returns, as ``nms_gather_pallas.py:721-725`` documents: with
    ``extract_m`` == 0, (boxes (B, k, 4), pairs (B, k, C)); with
    ``extract_m`` = m > 0, (boxes, v_m (B, k, m), i_m (B, k, m) int64,
    hot_flat (B, hot_j, C), hot_idx (B, 1, hot_j) int64), the inputs of
    the hierarchical stage 2.
    """
    na = len(meta[0][3])
    b, k = a_idx.shape
    num_pred = cells[0].shape[-1] // na
    raw = torch.cat([x.reshape(b, -1, num_pred) for x in cells], dim=1)
    raw_k = raw.gather(1, a_idx[..., None].expand(b, k, num_pred)).float()
    grid_xy, anchor_wh, stride_n = decode_constants(meta, a_idx.device)
    boxes, pairs = decode_winners(raw_k, a_idx, grid_xy, anchor_wh, stride_n)
    if not extract_m:
        return boxes, pairs
    v_m, i_m = extract_top_m_plain(pairs, extract_m)
    return (boxes, v_m, i_m) + hot_rows_plain(pairs, v_m, i_m, hot_j)


def _check_cells(name: str, cells, a_idx, meta) -> Tuple[int, int, int, int]:
    """The checks both K3 wrappers make; returns (b, k, na, num_pred)."""
    na = len(meta[0][3])
    if not 1 <= len(cells) == len(meta) <= MAX_SCALES:
        raise ValueError(f"{name} takes 1..{MAX_SCALES} scales, one per meta entry")
    if not 1 <= na <= MAX_ANCHORS or any(len(m[3]) != na for m in meta):
        raise ValueError(f"{name} needs 1..{MAX_ANCHORS} anchors on every scale")
    b, _, lanes = cells[0].shape
    if lanes % na or lanes // na < 6:
        raise ValueError(f"{lanes} lanes do not split into {na} anchors of 5+C")
    for i, (x, m) in enumerate(zip(cells, meta)):
        require(x, f"cells[{i}]", (torch.bfloat16, torch.float32),
                shape=(b, m[0], lanes), device=cells[0].device)
        if x.dtype != cells[0].dtype:
            raise TypeError(f"{name}: all scales must share one dtype")
    if a_idx.dim() != 2 or a_idx.shape[0] != b:
        raise ValueError(f"a_idx must be (B={b}, k), got {tuple(a_idx.shape)}")
    require(a_idx, "a_idx", torch.int64, device=cells[0].device)
    return b, a_idx.shape[1], na, lanes // na


def meta_args(meta) -> tuple[list, list, list, list]:
    """``meta`` (per scale ``(cells, width, stride, anchors)``) as the flat
    lists a custom op takes: cells, widths, strides, anchors (w, h per
    anchor, scale by scale)."""
    return ([int(m[0]) for m in meta], [int(m[1]) for m in meta], [float(m[2]) for m in meta],
            [float(v) for m in meta for wh in m[3] for v in wh])


def meta_from_args(cells_n, widths, strides, anchors, na: int):
    """``meta_args``'s lists back to ``meta``."""
    return tuple((c, w, s, tuple((anchors[2 * (i * na + a)], anchors[2 * (i * na + a) + 1])
                                 for a in range(na)))
                 for i, (c, w, s) in enumerate(zip(cells_n, widths, strides)))


def _table_args(cells, cells_n, widths, strides, anchors):
    """The per-scale arguments of the C entry points, padded to MAX_SCALES,
    and the host arrays of strides and anchors (kept alive by the caller)."""
    pad = MAX_SCALES - len(cells)
    strides_c = (ctypes.c_float * len(strides))(*strides)
    anchors_c = (ctypes.c_float * len(anchors))(*anchors)
    args = ([x.data_ptr() for x in cells] + [None] * pad
            + list(cells_n) + [0] * pad + list(widths) + [1] * pad
            + [ctypes.addressof(strides_c), ctypes.addressof(anchors_c), len(cells)])
    return args, (strides_c, anchors_c)


def gather_decode_pairs(cells: Sequence[torch.Tensor], a_idx: torch.Tensor, meta,
                        extract_m: int = 0, hot_j: int = 0):
    """K3 wrapper: the kernel for CUDA tensors, the plain version on the CPU.
    With ``extract_m`` > 0 it is ``gather_decode_top_m``."""
    cells = tuple(cells)
    if extract_m:
        return gather_decode_top_m(cells, a_idx, meta, extract_m, hot_j)
    if cells[0].device.type == "cpu":
        return gather_decode_pairs_plain(cells, a_idx, meta)
    on_card(cells[0], "gather_decode_pairs")
    return torch.ops.viddet.gather_decode_pairs(list(cells), a_idx, *meta_args(meta),
                                                len(meta[0][3]))


@torch.library.custom_op("viddet::gather_decode_pairs", mutates_args=(), device_types="cpu")
def _gather_decode_pairs_op(cells: List[torch.Tensor], a_idx: torch.Tensor, cells_n: List[int],
                            widths: List[int], strides: List[float], anchors: List[float],
                            na: int) -> tuple[torch.Tensor, torch.Tensor]:
    meta = meta_from_args(cells_n, widths, strides, anchors, na)
    return gather_decode_pairs_plain(cells, a_idx, meta)


@_gather_decode_pairs_op.register_kernel("cuda")
def _gather_decode_pairs_cuda(cells, a_idx, cells_n, widths, strides, anchors, na):
    meta = meta_from_args(cells_n, widths, strides, anchors, na)
    b, k, na, num_pred = _check_cells("gather_decode_pairs", cells, a_idx, meta)
    dev = cells[0].device
    boxes = torch.empty((b, k, 4), dtype=torch.float32, device=dev)
    pairs = torch.empty((b, k, num_pred - 5), dtype=torch.float32, device=dev)
    table, _keep = _table_args(cells, cells_n, widths, strides, anchors)
    err = build.library().viddet_gather_decode(
        *table, b, k, na, num_pred, int(cells[0].dtype == torch.bfloat16), a_idx.data_ptr(),
        boxes.data_ptr(), pairs.data_ptr(), build.stream_of(boxes),
    )
    build.check(err, "gather_decode_pairs")
    gather_decode_pairs.launches += 1
    return boxes, pairs


@_gather_decode_pairs_op.register_fake
def _(cells, a_idx, cells_n, widths, strides, anchors, na):
    b, k = a_idx.shape
    c = cells[0].shape[-1] // na - 5
    return a_idx.new_empty((b, k, 4), dtype=torch.float32), a_idx.new_empty(
        (b, k, c), dtype=torch.float32)


gather_decode_pairs.launches = 0

MAX_TOP_M = 32  # one step's result per lane of the winner's warp
MAX_TOP_M_CLASSES = 128  # four class slots per lane
def gather_decode_top_m(cells: Sequence[torch.Tensor], a_idx: torch.Tensor, meta, m: int,
                        hot_j: int):
    """K3 wrapper, ``extract_m`` = m > 0 form: the kernel for CUDA tensors,
    the plain version on the CPU.  One launch, a thread-block cluster per
    image; the kernel's entry point picks the clusters' shape from what
    the card holds at once."""
    cells = tuple(cells)
    if cells[0].device.type == "cpu":
        return gather_decode_pairs_plain(cells, a_idx, meta, m, hot_j)
    on_card(cells[0], "gather_decode_top_m")
    return torch.ops.viddet.gather_decode_top_m(list(cells), a_idx, *meta_args(meta),
                                                len(meta[0][3]), int(m), int(hot_j))


@torch.library.custom_op("viddet::gather_decode_top_m", mutates_args=(), device_types="cpu")
def _gather_decode_top_m_op(
    cells: List[torch.Tensor], a_idx: torch.Tensor, cells_n: List[int], widths: List[int],
    strides: List[float], anchors: List[float], na: int, m: int, hot_j: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    meta = meta_from_args(cells_n, widths, strides, anchors, na)
    return tuple(t.contiguous() for t in gather_decode_pairs_plain(cells, a_idx, meta, m, hot_j))


@_gather_decode_top_m_op.register_kernel("cuda")
def _gather_decode_top_m_cuda(cells, a_idx, cells_n, widths, strides, anchors, na, m, hot_j):
    meta = meta_from_args(cells_n, widths, strides, anchors, na)
    b, k, na, num_pred = _check_cells("gather_decode_top_m", cells, a_idx, meta)
    c = num_pred - 5
    if not 1 <= m <= MAX_TOP_M or not 1 <= hot_j <= k or c > MAX_TOP_M_CLASSES:
        raise ValueError(f"gather_decode_top_m needs 1 <= m <= {MAX_TOP_M}, 1 <= hot_j <= k "
                         f"and C <= {MAX_TOP_M_CLASSES}; got m={m}, hot_j={hot_j}, k={k}, C={c}")
    dev = cells[0].device
    boxes = torch.empty((b, k, 4), dtype=torch.float32, device=dev)
    v_m = torch.empty((b, k, m), dtype=torch.float32, device=dev)
    i_m = torch.empty((b, k, m), dtype=torch.int64, device=dev)
    hot_flat = torch.empty((b, hot_j, c), dtype=torch.float32, device=dev)
    hot_idx = torch.empty((b, 1, hot_j), dtype=torch.int64, device=dev)
    table, _keep = _table_args(cells, cells_n, widths, strides, anchors)
    err = build.library().viddet_gather_decode_top_m(
        *table, b, k, na, num_pred, int(cells[0].dtype == torch.bfloat16), a_idx.data_ptr(),
        m, hot_j, boxes.data_ptr(), v_m.data_ptr(), i_m.data_ptr(), hot_flat.data_ptr(),
        hot_idx.data_ptr(), build.stream_of(boxes),
    )
    build.check(err, "gather_decode_top_m")
    gather_decode_top_m.launches += 1
    return boxes, v_m, i_m, hot_flat, hot_idx


@_gather_decode_top_m_op.register_fake
def _(cells, a_idx, cells_n, widths, strides, anchors, na, m, hot_j):
    b, k = a_idx.shape
    c = cells[0].shape[-1] // na - 5
    f32, i64 = torch.float32, torch.int64
    return (a_idx.new_empty((b, k, 4), dtype=f32), a_idx.new_empty((b, k, m), dtype=f32),
            a_idx.new_empty((b, k, m), dtype=i64), a_idx.new_empty((b, hot_j, c), dtype=f32),
            a_idx.new_empty((b, 1, hot_j), dtype=i64))


gather_decode_top_m.launches = 0


# ---------------------------------------------------------------------------
# K4: the hierarchical stage-2 winners back to (class, box)
# ---------------------------------------------------------------------------


def finalize_candidates_plain(i_m: torch.Tensor, hot_idx: torch.Tensor, q: torch.Tensor,
                              boxes_k: torch.Tensor, num_classes: int):
    """(cls_idx (B, topk) float32, cand_boxes (B, topk, 4) float32) of the
    merged ranking's winners ``q`` (B, topk): the ``xla`` branch of
    ``viddet_tpu/ops/nms.py:533-542``.  A winner q < k*(m-1) is box
    q // (m-1), class i_m[box, q % (m-1)]; any other is e = q - k*(m-1),
    box hot_idx[e // C], class e % C."""
    b, k, m = i_m.shape
    topk = q.shape[1]
    width = k * (m - 1)
    from_cand = q < width
    cid = i_m[..., : m - 1].reshape(b, width)
    cls1 = cid.gather(1, q.clamp(max=width - 1))
    e = (q - width).clamp(min=0)
    box2 = hot_idx[:, 0].gather(1, e // num_classes)
    box = torch.where(from_cand, q // (m - 1), box2)
    cls_idx = torch.where(from_cand, cls1, e % num_classes).float()
    return cls_idx, boxes_k.gather(1, box[..., None].expand(b, topk, 4))


MAX_SHARED_BYTES = 232_448  # shared memory a block can have on an H100


def finalize_candidates(i_m: torch.Tensor, hot_idx: torch.Tensor, q: torch.Tensor,
                        boxes_k: torch.Tensor, num_classes: int):
    """K4 wrapper: the kernel for CUDA tensors, the plain version on the CPU."""
    if i_m.device.type == "cpu":
        return finalize_candidates_plain(i_m, hot_idx, q, boxes_k, num_classes)
    on_card(i_m, "finalize_candidates")
    return torch.ops.viddet.finalize_candidates(i_m, hot_idx, q, boxes_k, int(num_classes))


@torch.library.custom_op("viddet::finalize_candidates", mutates_args=(), device_types="cpu")
def _finalize_candidates_op(i_m: torch.Tensor, hot_idx: torch.Tensor, q: torch.Tensor,
                            boxes_k: torch.Tensor,
                            num_classes: int) -> tuple[torch.Tensor, torch.Tensor]:
    return tuple(t.contiguous() for t in finalize_candidates_plain(i_m, hot_idx, q, boxes_k,
                                                                    num_classes))


@_finalize_candidates_op.register_kernel("cuda")
def _finalize_candidates_cuda(i_m, hot_idx, q, boxes_k, num_classes):
    if i_m.dim() != 3 or i_m.shape[-1] < 2:
        raise ValueError(f"finalize_candidates: i_m must be (B, k, m >= 2), got {tuple(i_m.shape)}")
    b, k, m = i_m.shape
    if hot_idx.dim() != 3 or q.dim() != 2:
        raise ValueError("finalize_candidates: hot_idx must be (B, 1, J) and q (B, topk)")
    j, topk = hot_idx.shape[-1], q.shape[1]
    require(i_m, "i_m", torch.int64)
    require(hot_idx, "hot_idx", torch.int64, shape=(b, 1, j), device=i_m.device)
    require(q, "q", torch.int64, shape=(b, topk), device=i_m.device)
    require(boxes_k, "boxes_k", torch.float32, shape=(b, k, 4), device=i_m.device)
    if boxes_k.data_ptr() % 16:
        raise ValueError("finalize_candidates: boxes_k must be 16-byte aligned")
    if k * 16 + j * 8 > MAX_SHARED_BYTES:
        raise ValueError(f"finalize_candidates: an image's {k} boxes and {j} hot ids do not "
                         f"fit a block's shared memory")
    cls_idx = torch.empty((b, topk), dtype=torch.float32, device=i_m.device)
    cand = torch.empty((b, topk, 4), dtype=torch.float32, device=i_m.device)
    err = build.library().viddet_finalize_candidates(
        i_m.data_ptr(), hot_idx.data_ptr(), q.data_ptr(), boxes_k.data_ptr(), b, k, m,
        int(num_classes), j, topk, cls_idx.data_ptr(), cand.data_ptr(), build.stream_of(cand),
    )
    build.check(err, "finalize_candidates")
    finalize_candidates.launches += 1
    return cls_idx, cand


@_finalize_candidates_op.register_fake
def _(i_m, hot_idx, q, boxes_k, num_classes):
    b, topk = q.shape
    return (q.new_empty((b, topk), dtype=torch.float32),
            q.new_empty((b, topk, 4), dtype=torch.float32))


finalize_candidates.launches = 0
