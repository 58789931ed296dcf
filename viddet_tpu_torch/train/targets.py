"""In-step YOLOv3 target assignment (counterpart of
``viddet_tpu/train/targets.py:29-132``).

Each ground-truth box is matched to the one anchor, of all scales, with
the highest shape-IoU (boxes concentric); that anchor's cell at that
scale becomes the positive.  Centre targets are the sub-cell offsets,
scale targets log(gt / anchor), box-loss weights ``2 - w*h/area``.
Ground truth is padded to a static M with class id -1.

Two boxes can land on one anchor slot.  The reference scatters with
``buf.at[flat].set(updates)``, where the last box wins on the CPU;
``index_put_`` with repeated indices is undefined on CUDA.  So the
collisions are settled before the scatter: a box that a later box of its
image overwrites goes to the dropped slot, as padding does.

Every float op is the reference's, in its order, so the targets equal
the JAX package's bit for bit on the CPU and on the card.  Where XLA's
CPU compiler rewrites an op, the port does what the compiled program
does: a division by the constant image area is a multiplication by its
float32 reciprocal, fused with the subtraction from 2 into one rounding,
and the log is XLA's CPU approximation (``log_xla_cpu``).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

# XLA's CPU log (a Cephes polynomial): its float32 constants, as the
# compiled program holds them.
_LOG_P = tuple(float(np.float32(c)) for c in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1, 1.4249322787e-1,
    -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1))
_LOG_Q1, _LOG_Q2 = float(np.float32(-2.12194440e-4)), 0.693359375
_SQRT_HALF = float(np.float32(0.707106781186547524))
_MIN_NORMAL = float(np.finfo(np.float32).tiny)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once: the product of two float32
    values is exact in float64, and the float64 sum rounds to float32
    (a double rounding that differs from one rounding about once in 2**29
    sums)."""
    return (a.double() * b + c).float()


def log_xla_cpu(x: torch.Tensor) -> torch.Tensor:
    """float32 ``log`` as JAX's jitted ``jnp.log`` computes it on an x86
    CPU with FMA, bit for bit, for positive finite x: frexp, then a
    degree-8 polynomial in Estrin-like groups whose multiply-adds the
    compiler fuses.  Torch's own ``log`` differs from it by an ulp on about
    a tenth of float32 inputs."""
    x = x.clamp_min(_MIN_NORMAL)
    bits = x.view(torch.int32)
    e = ((bits >> 23) - 127).float() + 1.0
    m = ((bits & -2139095041) | 1056964608).view(torch.float32)  # mantissa in [0.5, 1)
    low = m < _SQRT_HALF
    x = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    e = e - low.float()
    z = x * x
    x3 = z * x
    p = _LOG_P
    y1 = _fma(_fma(x, p[0], p[1]), x, p[2])
    y2 = _fma(_fma(x, p[3], p[4]), x, p[5])
    y3 = _fma(_fma(x, p[6], p[7]), x, p[8])
    y = _fma(_fma(_fma(y1, x3, y2), x3, y3), x3, _LOG_Q1 * e)
    return _fma(e, _LOG_Q2, (x - 0.5 * z) + y)


def last_of_duplicates(index: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(B, M) bool: valid entries that no later valid entry of their row
    shares ``index`` with.  XLA's CPU scatter writes repeated indices in
    order, so the last one wins; settled before a ``scatter_``, whose order
    on CUDA is undefined."""
    m = index.shape[-1]
    same = (index[..., :, None] == index[..., None, :]) & valid[..., None, :]
    later = torch.ones((m, m), dtype=torch.bool, device=index.device).triu(1)
    return valid & ~(same & later).any(dim=-1)


def _shape_iou(wh_a: torch.Tensor, wh_b: torch.Tensor) -> torch.Tensor:
    """IoU of concentric boxes given sizes: a (..., M, 2), b (A, 2) ->
    (..., M, A)."""
    a, b = wh_a[..., :, None, :], wh_b
    inter = torch.minimum(a[..., 0], b[:, 0]) * torch.minimum(a[..., 1], b[:, 1])
    area_a = a[..., 0] * a[..., 1]
    area_b = b[:, 0] * b[:, 1]
    return inter / (area_a + area_b - inter).clamp_min(1e-12)


@functools.lru_cache(maxsize=64)
def _layout(image_size: Tuple[int, int], strides, anchors, device: torch.device):
    """The static per-scale layout on ``device``, deepest first: (slots,
    anchors a scale, each scale's first slot, the anchors (A, 2), and per
    scale its stride, grid width and grid height).  Cached: a host-to-device
    copy inside the step would wait for the work queued before it."""
    img_h, img_w = image_size
    grid_hw = [(img_h // s, img_w // s) for s in strides]
    counts = [h * w * len(a) for (h, w), a in zip(grid_hw, anchors)]
    return (
        sum(counts),
        len(anchors[0]),
        torch.tensor([sum(counts[:i]) for i in range(len(counts))], device=device),
        torch.tensor([a for scale in anchors for a in scale], dtype=torch.float32, device=device),
        torch.tensor(strides, dtype=torch.float32, device=device),
        torch.tensor([w for _, w in grid_hw], device=device),
        torch.tensor([h for h, _ in grid_hw], device=device),
    )


def assign_targets(
    gt_boxes: torch.Tensor,
    gt_ids: torch.Tensor,
    gt_weights: Optional[torch.Tensor] = None,
    *,
    image_size: Tuple[int, int],
    strides: Tuple[int, ...],
    anchors: Tuple[Tuple[Tuple[float, float], ...], ...],
    num_classes: int,
) -> Dict[str, torch.Tensor]:
    """Batched target assignment, with no host synchronisation.

    gt_boxes (B, M, 4) corner boxes in input pixels, -1 padded; gt_ids
    (B, M), -1 for padding; gt_weights (B, M) the objectness weight of
    each box (mixup's lambda), default 1.  ``strides`` / ``anchors`` are
    deepest first, as the model's flat anchor axis.

    Returns float32 (B, N, ...) tensors: objectness (B, N, 1) in {0, w};
    center, scale, weight (B, N, 2); class_onehot (B, N, C); class_mask
    (B, N, 1), 1 at positives.
    """
    img_h, img_w = image_size
    dev = gt_boxes.device
    b, m = gt_ids.shape
    if gt_weights is None:
        gt_weights = torch.ones((b, m), dtype=torch.float32, device=dev)
    (n_total, per_scale, starts, anchors_flat, stride_of_scale, gridw_of_scale,
     gridh_of_scale) = _layout((img_h, img_w), tuple(strides), anchors, dev)

    boxes = gt_boxes.float()
    wh = (boxes[..., 2:4] - boxes[..., 0:2]).clamp_min(0.0)  # (B, M, 2)
    center = 0.5 * (boxes[..., 0:2] + boxes[..., 2:4])
    valid = (gt_ids >= 0) & (wh[..., 0] > 0) & (wh[..., 1] > 0)

    best = torch.argmax(_shape_iou(wh, anchors_flat), dim=-1)  # (B, M), first of ties
    scale_idx = torch.div(best, per_scale, rounding_mode="floor")
    anchor_in_scale = best % per_scale
    stride = stride_of_scale[scale_idx]
    gw, gh = gridw_of_scale[scale_idx], gridh_of_scale[scale_idx]
    # float32 -> int32 truncates toward zero, as XLA's convert does
    col = torch.minimum((center[..., 0] / stride).to(torch.int32).clamp_min(0), gw - 1)
    row = torch.minimum((center[..., 1] / stride).to(torch.int32).clamp_min(0), gh - 1)
    flat = starts[scale_idx] + (row * gw + col) * per_scale + anchor_in_scale
    # the last valid box of an image on a slot wins; the others and the
    # padding go to the dropped slot
    flat = torch.where(last_of_duplicates(flat, valid), flat, n_total)

    t_center = center / stride[..., None] - torch.stack([col, row], dim=-1).float()
    t_scale = log_xla_cpu(wh.clamp_min(1e-6) / anchors_flat[best])
    area_recip = float(np.float32(1.0 / (img_h * img_w)))
    t_weight = _fma(-(wh[..., 0] * wh[..., 1]), area_recip, 2.0)[..., None].expand(b, m, 2)
    onehot = torch.nn.functional.one_hot(gt_ids.long().clamp_min(0), num_classes).float()
    validf = valid.float()[..., None]

    def scatter(updates: torch.Tensor) -> torch.Tensor:
        buf = torch.zeros((b, n_total + 1, updates.shape[-1]), dtype=torch.float32, device=dev)
        index = flat[..., None].expand(-1, -1, updates.shape[-1])
        return buf.scatter_(1, index, updates.float())[:, :n_total]

    return {
        "objectness": scatter(gt_weights.float()[..., None] * validf),
        "center": scatter(t_center),
        "scale": scatter(t_scale),
        "weight": scatter(t_weight * validf),
        "class_onehot": scatter(onehot),
        "class_mask": scatter(validf),
    }
