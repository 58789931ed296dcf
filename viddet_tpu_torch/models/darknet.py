"""Darknet backbones (counterpart of ``viddet_tpu/models/darknet.py:26-71``).

Both take an NCHW channels_last tensor and return multi-scale features,
shallowest first, in the compute dtype.  ``in_channels`` widens the stem
conv (3k for the temporal model's ``stack`` aggregation).
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn

from viddet_tpu_torch.core.precision import DEFAULT_POLICY, Policy
from viddet_tpu_torch.models.common import (
    ConvBNLeaky,
    DarknetResidual,
    FlaxNames,
    maxpool2d,
)


class Darknet53(nn.Module):
    """53-layer Darknet. Returns (c3, c4, c5) at strides (8, 16, 32)."""

    # (num_residual_blocks, out_channels) per downsampling stage
    STAGES = ((1, 64), (2, 128), (8, 256), (8, 512), (4, 1024))
    OUT_CHANNELS = (256, 512, 1024)

    def __init__(self, policy: Policy = DEFAULT_POLICY, scope: str = "Darknet53_0",
                 in_channels: int = 3):
        super().__init__()
        self.policy = policy
        names = FlaxNames(scope)
        self.stem = ConvBNLeaky(in_channels, 32, 3, policy=policy, scope=names("ConvBNLeaky"))
        downs, stages = [], []
        cin = 32
        for _, channels in self.STAGES:
            downs.append(ConvBNLeaky(cin, channels, 3, stride=2, policy=policy,
                                     scope=names("ConvBNLeaky")))
            cin = channels
        for num_blocks, channels in self.STAGES:
            stages.append(nn.Sequential(*[
                DarknetResidual(channels, policy=policy, scope=names("DarknetResidual"))
                for _ in range(num_blocks)
            ]))
        self.downs = nn.ModuleList(downs)
        self.stages = nn.ModuleList(stages)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.stem(x.to(self.policy.compute_dtype))
        feats = []
        for down, stage in zip(self.downs, self.stages):
            x = stage(down(x))
            feats.append(x)
        return feats[-3:]


class DarknetTiny(nn.Module):
    """yolov3-tiny backbone: conv/max-pool ladder. Returns (c4, c5) at
    strides (16, 32); the last pool is window 2, stride 1, "SAME"."""

    OUT_CHANNELS = (256, 1024)

    def __init__(self, policy: Policy = DEFAULT_POLICY, scope: str = "DarknetTiny_0",
                 in_channels: int = 3):
        super().__init__()
        self.policy = policy
        names = FlaxNames(scope)
        cells, cin = [], in_channels
        for channels in (16, 32, 64, 128, 256, 512, 1024):
            cells.append(ConvBNLeaky(cin, channels, 3, policy=policy,
                                     scope=names("ConvBNLeaky")))
            cin = channels
        self.cells = nn.ModuleList(cells)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = x.to(self.policy.compute_dtype)
        for cell in self.cells[:4]:
            x = maxpool2d(cell(x))  # stride 2, 4, 8, 16
        c4 = self.cells[4](x)  # stride 16
        x = self.cells[5](maxpool2d(c4))  # stride 32
        c5 = self.cells[6](maxpool2d(x, window=2, stride=1))  # keep stride 32
        return [c4, c5]
