"""Device resolution and the conv backend for the port's entry points.

Counterpart of ``viddet_tpu/core/platform.py``.  There the platform picks
the NMS backend; here the tensor's own device does: a CUDA tensor launches
the hand-written kernel, a CPU tensor takes the kernel's plain version.
No environment variable switches a CUDA tensor to the plain path, and there
is no silent CPU fallback: an entry point runs on ``cuda:0`` unless the
caller asks for the CPU.

``conv_backend`` (``viddet_tpu/core/platform.py:55-84``) picks which
kernels the shallow stride-2 ``ConvBNLeaky`` layers run: "xla", the
default, keeps PyTorch's convolution, BatchNorm and leaky ReLU; "pallas"
routes them to K8 ``conv_down2_bn_leaky`` (``ops/conv_cuda.py``), whose
wrapper launches the kernel for a CUDA tensor and runs its plain version
for a CPU tensor.  The JAX package's names are kept so that one
environment drives both packages; "pallas_interpret" has no meaning here
and raises.
"""

from __future__ import annotations

import os

import torch

CONV_BACKENDS = ("xla", "pallas")
_conv_backend: str | None = None


def set_conv_backend(backend: str) -> None:
    """Pin the conv backend ("xla" or "pallas"); "auto" unpins it, so
    ``VIDDET_CONV_BACKEND`` (default "xla") decides again."""
    global _conv_backend
    if backend != "auto" and backend not in CONV_BACKENDS:
        raise ValueError(f"conv backend {backend!r} is not one of {CONV_BACKENDS} or 'auto'")
    _conv_backend = None if backend == "auto" else backend


def conv_backend() -> str:
    """The pinned conv backend, else ``VIDDET_CONV_BACKEND``, else "xla".
    Read on every call; an unknown value raises."""
    if _conv_backend is not None:
        return _conv_backend
    env = os.environ.get("VIDDET_CONV_BACKEND") or "xla"
    if env not in CONV_BACKENDS:
        raise ValueError(f"VIDDET_CONV_BACKEND={env!r} is not one of {CONV_BACKENDS}")
    return env


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``cuda:0`` by default; the CPU only when the caller passes it.

    Raises RuntimeError when a CUDA device is wanted and none is present.
    """
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
