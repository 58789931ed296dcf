"""Box math (counterpart of ``viddet_tpu/ops/boxes.py:23-54``).

Corner format ``[x1, y1, x2, y2]``; the expression order and the 1e-12
union floor are the reference's, so float32 results agree bit for bit.
"""

from __future__ import annotations

import torch


def div_rn(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` correctly rounded on any device, as XLA divides.  Given a
    Python number, PyTorch's CUDA kernels multiply by its rounded
    reciprocal instead, which can differ by an ulp (1/7, 1/10 and 1/224 are
    not exact)."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of corner-format boxes. ``(..., 4) -> (...)``; 0 for degenerate."""
    w = (boxes[..., 2] - boxes[..., 0]).clamp_min(0.0)
    h = (boxes[..., 3] - boxes[..., 1]).clamp_min(0.0)
    return w * h


def box_iou(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Pairwise IoU: a (..., N, 4), b (..., M, 4) -> (..., N, M)."""
    a = a[..., :, None, :]
    b = b[..., None, :, :]
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = (rb - lt).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a) + box_area(b) - inter
    return inter / union.clamp_min(eps)


def clip_boxes(boxes: torch.Tensor, height, width) -> torch.Tensor:
    """Clip corner boxes to ``[0, width] x [0, height]``
    (``viddet_tpu/ops/boxes.py:48``)."""
    x1 = boxes[..., 0].clamp(0.0, width)
    y1 = boxes[..., 1].clamp(0.0, height)
    x2 = boxes[..., 2].clamp(0.0, width)
    y2 = boxes[..., 3].clamp(0.0, height)
    return torch.stack([x1, y1, x2, y2], dim=-1)
