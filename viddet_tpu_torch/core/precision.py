"""Mixed-precision policy (counterpart of ``viddet_tpu/core/precision.py``).

Parameters are stored in float32 under every policy; convolutions run on
a compute-dtype copy of the weights and compute-dtype activations (bf16 by
default); the tail upcasts the head outputs, so box decode and scores are
float32 under every policy.  ``FLOAT32_POLICY`` computes everything in
float32, for the parity tests.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    compute_dtype: torch.dtype = torch.bfloat16  # conv weights and activations


DEFAULT_POLICY = Policy()
FLOAT32_POLICY = Policy(compute_dtype=torch.float32)
