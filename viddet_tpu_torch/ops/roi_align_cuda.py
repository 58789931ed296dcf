"""K7 ``multilevel_roi_align``: FPN ROIAlign of the Faster R-CNN box head.

Replaces ``viddet_tpu/ops/roi_align_pallas.py:143``
``multilevel_roi_align_pallas`` (``_kernel``, ``:46``).  The CUDA kernel is
``csrc/roi_align.cu``; its header says what bounds it on an H100 and how
its design answers that.  It computes ``ops/roi_align.py``
``multilevel_roi_align_packed``, the JAX package's oracle, for every roi:
unlike the TPU kernel it has no window, so it is exact at any roi size and
aspect ratio (the TPU kernel clips the outer samples of rois wider than
its 48-cell window).

The level of each roi is computed here, on the roi's device, with the
plain ``fpn_roi_level`` expression, and passed to the kernel: a level
recomputed with CUDA's ``log2f`` could differ from PyTorch's at a level
boundary (sqrt(w*h) = 112, 224, 448).

The kernel is the custom op ``viddet::multilevel_roi_align``
(``ops/__init__.py``): its CUDA implementation launches it, so that
``torch.export`` carries it.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

import torch

from viddet_tpu_torch.kernels import build, on_card, require
from viddet_tpu_torch.ops.roi_align import fpn_roi_level, multilevel_roi_align_packed

MAX_LEVELS = 4  # the kernel's table; the box head aligns on P2..P5
OUTPUT_SIZE, SAMPLING_RATIO = 7, 2  # the only bin layout the kernel is built for


def multilevel_roi_align(pyramid: Sequence[torch.Tensor], rois: torch.Tensor,
                         strides: Sequence[int], output_size: int = OUTPUT_SIZE,
                         sampling_ratio: int = SAMPLING_RATIO, k_min: int = 2) -> torch.Tensor:
    """K7 wrapper: the kernel for CUDA tensors, the plain version on the CPU.

    pyramid: (B, H_l, W_l, C) per level, one dtype (bfloat16 or float32);
    rois: (B, R, 4) float32 image-coordinate corners.  Returns
    (B, R, P, P, C) float32.
    """
    pyramid = tuple(pyramid)
    if rois.device.type == "cpu":
        return multilevel_roi_align_packed(pyramid, rois, strides, output_size,
                                           sampling_ratio, k_min)
    on_card(rois, "multilevel_roi_align")
    return torch.ops.viddet.multilevel_roi_align(list(pyramid), rois, [int(s) for s in strides],
                                                 int(output_size), int(sampling_ratio),
                                                 int(k_min))


@torch.library.custom_op("viddet::multilevel_roi_align", mutates_args=(), device_types="cpu")
def _roi_align_op(pyramid: List[torch.Tensor], rois: torch.Tensor, strides: List[int],
                  output_size: int, sampling_ratio: int, k_min: int) -> torch.Tensor:
    return multilevel_roi_align_packed(pyramid, rois, strides, output_size, sampling_ratio,
                                       k_min).contiguous()


@_roi_align_op.register_kernel("cuda")
def _roi_align_cuda(pyramid, rois, strides, output_size, sampling_ratio, k_min):
    if (output_size, sampling_ratio) != (OUTPUT_SIZE, SAMPLING_RATIO):
        raise ValueError(f"multilevel_roi_align: the kernel takes output_size {OUTPUT_SIZE} and "
                         f"sampling_ratio {SAMPLING_RATIO}, got {output_size}, {sampling_ratio}")
    if not 1 <= len(pyramid) <= MAX_LEVELS or len(strides) != len(pyramid):
        raise ValueError(f"multilevel_roi_align: 1..{MAX_LEVELS} levels with one stride each, "
                         f"got {len(pyramid)} levels and {len(strides)} strides")
    if rois.dim() != 3 or rois.shape[-1] != 4:
        raise ValueError(f"multilevel_roi_align: rois must be (B, R, 4), got {tuple(rois.shape)}")
    b, r, _ = rois.shape
    require(rois, "rois", torch.float32)
    c = pyramid[0].shape[-1]
    if c % 2:
        raise ValueError(f"multilevel_roi_align: the kernel reads channel pairs; C={c} is odd")
    for i, f in enumerate(pyramid):
        require(f, f"pyramid[{i}]", (torch.bfloat16, torch.float32),
                shape=(b, f.shape[1], f.shape[2], c), device=rois.device)
        if f.dtype != pyramid[0].dtype:
            raise TypeError("multilevel_roi_align: all levels must share one dtype")
        if f.data_ptr() % (2 * f.element_size()):
            raise ValueError(f"pyramid[{i}]: not aligned to a channel pair")
    levels = (fpn_roi_level(rois, k_min=k_min, k_max=k_min + len(pyramid) - 1)
              - k_min).contiguous()
    out = torch.empty((b, r, output_size, output_size, c), dtype=torch.float32,
                      device=rois.device)
    n = len(pyramid)
    ptrs = [f.data_ptr() for f in pyramid] + [None] * (MAX_LEVELS - n)
    heights = (ctypes.c_int * MAX_LEVELS)(*[f.shape[1] for f in pyramid], *[0] * (MAX_LEVELS - n))
    widths = (ctypes.c_int * MAX_LEVELS)(*[f.shape[2] for f in pyramid], *[0] * (MAX_LEVELS - n))
    strides_f = (ctypes.c_float * MAX_LEVELS)(*[float(s) for s in strides],
                                              *[1.0] * (MAX_LEVELS - n))
    err = build.library().viddet_roi_align(
        *ptrs, ctypes.addressof(heights), ctypes.addressof(widths), ctypes.addressof(strides_f),
        n, b, r, c, int(pyramid[0].dtype == torch.bfloat16), rois.data_ptr(),
        levels.data_ptr(), out.data_ptr(), build.stream_of(out),
    )
    build.check(err, "multilevel_roi_align")
    multilevel_roi_align.launches += 1
    return out


@_roi_align_op.register_fake
def _(pyramid, rois, strides, output_size, sampling_ratio, k_min):
    b, r, _ = rois.shape
    return rois.new_empty((b, r, output_size, output_size, pyramid[0].shape[-1]),
                          dtype=torch.float32)


multilevel_roi_align.launches = 0
