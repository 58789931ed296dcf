"""FPN ROIAlign, plain PyTorch (counterpart of ``viddet_tpu/ops/roi_align.py:92-167``).

``multilevel_roi_align_packed`` is the JAX package's packed single-gather
oracle written batched over B: every roi is aligned once, on the FPN level
``fpn_roi_level`` assigns it, with the standard ROIAlign semantics
(``sampling_ratio`` regular samples per bin side, bilinear interpolation,
the mean of each bin's samples, no rounding of the roi).  It is K7's plain
version: ``ops/roi_align_cuda.py`` runs it for CPU tensors and holds the
CUDA kernel to it on the card.

The float expressions are the oracle's, in its order; the one freedom
taken is the order of the bin mean, which sums the samples row by row
(``(s00 + s01) + s10 + s11`` at ``sampling_ratio`` 2) and then divides, so
that the kernel can repeat it exactly.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch

from viddet_tpu_torch.ops.boxes import div_rn


@functools.lru_cache(maxsize=64)
def _on_device(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A small constant table on ``device``, copied there once: a copy from
    pageable host memory inside a train step would wait for the work
    queued before it.  Made outside inference mode, so a train step may
    use a table first made under it."""
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=dtype, device=device)


def fpn_roi_level(rois: torch.Tensor, k0: int = 4, canonical: float = 224.0,
                  k_min: int = 2, k_max: int = 5) -> torch.Tensor:
    """FPN level per roi (FPN paper eq. 1), ``(..., 4) -> (...)`` int32:
    ``clip(floor(k0 + log2(sqrt(w*h) / canonical)), k_min, k_max)``."""
    w = (rois[..., 2] - rois[..., 0]).clamp_min(1e-6)
    h = (rois[..., 3] - rois[..., 1]).clamp_min(1e-6)
    k = torch.floor(k0 + torch.log2(div_rn(torch.sqrt(w * h), canonical)))
    return k.clamp(k_min, k_max).to(torch.int32)


def sample_grid(rois: torch.Tensor, levels: torch.Tensor, strides: Sequence[int],
                output_size: int, sampling_ratio: int):
    """Sample coordinates of each roi on its level, in level cells:
    ``(ys, xs)``, each (B, R, P*S) float32 (``roi_align.py:130-141``).

    ``levels`` are 0-based pyramid indices (B, R)."""
    p, s = output_size, sampling_ratio
    scale = 1.0 / _on_device(tuple(strides), torch.float32, rois.device)[levels.long()]
    boxes = rois * scale[..., None]
    x1, y1 = boxes[..., 0], boxes[..., 1]
    bin_w = div_rn((boxes[..., 2] - x1).clamp_min(1e-3), p)
    bin_h = div_rn((boxes[..., 3] - y1).clamp_min(1e-3), p)
    grid = (torch.arange(p * s, device=rois.device) + 0.5) / s
    ys = y1[..., None] + grid * bin_h[..., None]
    xs = x1[..., None] + grid * bin_w[..., None]
    return ys, xs


def multilevel_roi_align_packed(pyramid: Sequence[torch.Tensor], rois: torch.Tensor,
                                strides: Sequence[int], output_size: int = 7,
                                sampling_ratio: int = 2, k_min: int = 2) -> torch.Tensor:
    """ROIAlign over an FPN pyramid, batched.

    pyramid: levels k_min.. as (B, H_l, W_l, C) tensors of one float dtype
    (NHWC); rois: (B, R, 4) float32 image-coordinate corners.  Returns
    (B, R, P, P, C) float32, ``jax.vmap(multilevel_roi_align_packed)`` of
    the JAX package.  A sample outside ``(-1, H_l) x (-1, W_l)`` adds 0.
    """
    p, s = output_size, sampling_ratio
    b, r = rois.shape[:2]
    c = pyramid[0].shape[-1]
    dev = rois.device
    flat = torch.cat([f.reshape(b, -1, c) for f in pyramid], dim=1)
    hs = _on_device(tuple(int(f.shape[1]) for f in pyramid), torch.int64, dev)
    ws = _on_device(tuple(int(f.shape[2]) for f in pyramid), torch.int64, dev)
    offsets = _on_device(tuple(sum(int(f.shape[1] * f.shape[2]) for f in pyramid[:i])
                               for i in range(len(pyramid))), torch.int64, dev)

    lvl = (fpn_roi_level(rois, k_min=k_min, k_max=k_min + len(pyramid) - 1) - k_min).long()
    ys, xs = sample_grid(rois, lvl, strides, p, s)
    yy = ys[..., :, None]  # (B, R, P*S, 1): rows of the sample lattice
    xx = xs[..., None, :]  # (B, R, 1, P*S): its columns
    lh = hs[lvl][..., None, None]
    lw = ws[lvl][..., None, None]
    base = offsets[lvl][..., None, None]
    lhf, lwf = lh.float(), lw.float()

    valid = (yy > -1.0) & (yy < lhf) & (xx > -1.0) & (xx < lwf)
    y = torch.minimum(yy.clamp_min(0.0), lhf - 1.0)
    x = torch.minimum(xx.clamp_min(0.0), lwf - 1.0)
    y0 = torch.floor(y).long()
    x0 = torch.floor(x).long()
    y1 = torch.minimum(y0 + 1, lh - 1)
    x1 = torch.minimum(x0 + 1, lw - 1)
    ly = y - y0
    lx = x - x0
    hy, hx = 1 - ly, 1 - lx
    bidx = torch.arange(b, device=dev)[:, None, None, None]

    def fetch(yi, xi):
        return flat[bidx, base + yi * lw + xi]  # (B, R, P*S, P*S, C)

    out = (
        fetch(y0, x0) * (hy * hx)[..., None]
        + fetch(y0, x1) * (hy * lx)[..., None]
        + fetch(y1, x0) * (ly * hx)[..., None]
        + fetch(y1, x1) * (ly * lx)[..., None]
    ) * valid[..., None]
    out = out.reshape(b, r, p, s, p, s, c)
    acc = out[:, :, :, 0, :, 0]
    for i in range(s):
        for j in range(s):
            if i or j:
                acc = acc + out[:, :, :, i, :, j]
    return acc / (s * s)
