"""ResNet-50 v1.5 backbone (counterpart of ``viddet_tpu/models/resnet.py:19-110``).

NCHW channels_last tensors in the compute dtype; stride 2 sits in the 3x3
bottleneck conv; returns (c2, c3, c4, c5) at strides (4, 8, 16, 32).
Every conv pads as XLA's "SAME" does (``common.same_pads``): at 512 px
the 7x7/2 stem pads (2, 3), each 3x3/2 (0, 1) and each 1x1/2 projection
nothing; the stem's 3x3/2 max-pool pads (0, 1) with -inf.  In train mode
(``module.train()``) every BatchNorm normalizes with the batch's statistics
and updates its running ones as Flax's does (``common.batch_norm_train``).
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from viddet_tpu_torch import quant
from viddet_tpu_torch.core.precision import DEFAULT_POLICY, Policy
from viddet_tpu_torch.models.common import (
    BN_EPS, FlaxNames, _pad_same, batch_norm_train, maxpool2d,
)


class ConvBN(nn.Module, quant.Int8Cell):
    """conv ("SAME", no bias) -> BatchNorm -> optional ReLU: the JAX
    package's ``_ConvBN``, with its weights under ``scope``.  BatchNorm uses
    the running statistics in eval mode and the batch's in train mode
    (``batch_norm_train``).  Under an int8 policy it quantizes as
    ``ConvBNLeaky`` does (``resnet.py:37-47``), with activation "relu" or
    "none"."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3, stride: int = 1,
                 act: bool = True, policy: Policy = DEFAULT_POLICY, scope: str = ""):
        super().__init__()
        self.kernel_size, self.stride, self.act = kernel_size, stride, act
        self.policy, self.scope = policy, scope
        self.conv = nn.Conv2d(cin, cout, kernel_size, stride, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=BN_EPS)
        if policy.quant == "int8":
            self.register_buffer("act_amax", torch.zeros((), dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.policy.quant == "int8" and not self.training:
            if not quant.is_calibrating():
                return self.int8_forward(x, "relu" if self.act else "none",
                                         self.policy.compute_dtype)
            self.record_range(x)
        x, pad = _pad_same(x, self.kernel_size, self.stride)
        x = F.conv2d(x, self.conv.weight.to(self.policy.compute_dtype), stride=self.stride,
                     padding=pad)
        bn = self.bn
        if self.training:
            x = batch_norm_train(x, bn)
        else:
            x = F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                             training=False, eps=BN_EPS)
        return F.relu(x, inplace=True) if self.act else x


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 (4x width), with a projection shortcut
    when the width or stride changes.  As in Flax, the projection is built
    first, so it is ``_ConvBN_0`` and the main branch ``_ConvBN_1..3``
    (``_ConvBN_0..2`` without one)."""

    def __init__(self, cin: int, width: int, stride: int = 1,
                 policy: Policy = DEFAULT_POLICY, scope: str = ""):
        super().__init__()
        names = FlaxNames(scope)
        out = width * 4
        self.project = None
        if cin != out or stride != 1:
            self.project = ConvBN(cin, out, 1, stride, act=False, policy=policy,
                                  scope=names("_ConvBN"))
        self.reduce = ConvBN(cin, width, 1, policy=policy, scope=names("_ConvBN"))
        self.conv = ConvBN(width, width, 3, stride, policy=policy, scope=names("_ConvBN"))
        self.expand = ConvBN(width, out, 1, act=False, policy=policy, scope=names("_ConvBN"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x if self.project is None else self.project(x)
        return F.relu(self.expand(self.conv(self.reduce(x))) + shortcut, inplace=True)


class ResNet50(nn.Module):
    """Returns [c2, c3, c4, c5]; ``blocks`` / ``widths`` override the stages
    (the JAX module's ``BLOCKS`` / ``WIDTHS``)."""

    BLOCKS: Tuple[int, ...] = (3, 4, 6, 3)
    WIDTHS: Tuple[int, ...] = (64, 128, 256, 512)

    def __init__(self, policy: Policy = DEFAULT_POLICY, blocks=None, widths=None,
                 scope: str = "ResNet50_0"):
        super().__init__()
        self.policy = policy
        blocks = tuple(blocks or self.BLOCKS)
        widths = tuple(widths or self.WIDTHS)
        names = FlaxNames(scope)
        self.stem = ConvBN(3, 64, 7, 2, policy=policy, scope=names("_ConvBN"))
        stages, cin = [], 64
        for stage, (n, width) in enumerate(zip(blocks, widths)):
            units = []
            for i in range(n):
                stride = 2 if (i == 0 and stage > 0) else 1
                units.append(Bottleneck(cin, width, stride, policy, names("Bottleneck")))
                cin = width * 4
            stages.append(nn.Sequential(*units))
        self.stages = nn.ModuleList(stages)
        self.out_channels = tuple(w * 4 for w in widths)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = maxpool2d(self.stem(x.to(self.policy.compute_dtype)), window=3, stride=2)
        feats = []
        for stage in self.stages:
            x = stage(x)
            feats.append(x)
        return feats
