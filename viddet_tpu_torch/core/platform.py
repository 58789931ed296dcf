"""Device resolution for the port's entry points.

Counterpart of ``viddet_tpu/core/platform.py``.  There the platform picks
the NMS backend; here the tensor's own device does: a CUDA tensor launches
the hand-written kernel, a CPU tensor takes the kernel's plain version.
No environment variable switches a CUDA tensor to the plain path, and there
is no silent CPU fallback: an entry point runs on ``cuda:0`` unless the
caller asks for the CPU.
"""

from __future__ import annotations

import torch


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
