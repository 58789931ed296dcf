"""Loader of the hand-written CUDA kernels (``build.py``) and the checks
their wrappers share."""

from __future__ import annotations

import torch


def on_card(t: torch.Tensor, name: str) -> None:
    """A wrapper's guard before its custom op: a tensor that is on neither
    the CPU (the plain version) nor a CUDA card (the kernel) raises; it
    never reaches the op's fake implementation as a meta tensor would."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got one on {t.device}")


def require(t: torch.Tensor, name: str, dtype, shape=None, device=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of this dtype/shape
    (and on ``device`` when given): what a kernel launch may assume."""
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype}, expected one of {dtypes}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
