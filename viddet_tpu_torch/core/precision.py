"""Mixed-precision policy (counterpart of ``viddet_tpu/core/precision.py``).

Parameters are stored in float32 under every policy; convolutions run on
a compute-dtype copy of the weights and compute-dtype activations (bf16 by
default); the tail upcasts the head outputs, so box decode and scores are
float32 under every policy.  ``FLOAT32_POLICY`` computes everything in
float32, for the parity tests.

``quant="int8"`` (``INT8_POLICY``: bf16 compute, int8 convs, as
``viddet_tpu/core/precision.py:33,44``) runs every conv+BN cell at
inference as a BN-folded int8 x int8 -> int32 conv with calibrated
activation ranges (``viddet_tpu_torch/quant.py``); output heads, training
and calibration stay on the float path.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    compute_dtype: torch.dtype = torch.bfloat16  # conv weights and activations
    quant: str | None = None  # None | "int8" (post-training quantization at inference)


DEFAULT_POLICY = Policy()
FLOAT32_POLICY = Policy(compute_dtype=torch.float32)
INT8_POLICY = Policy(quant="int8")
