"""Box math (counterpart of ``viddet_tpu/ops/boxes.py:23-45``).

Corner format ``[x1, y1, x2, y2]``; the expression order and the 1e-12
union floor are the reference's, so float32 results agree bit for bit.
"""

from __future__ import annotations

import torch


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
