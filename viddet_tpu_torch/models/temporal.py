"""Temporal k-frame YOLOv3 (counterpart of ``viddet_tpu/models/temporal.py:35-89``).

The model takes (B, k, H, W, 3) clips and returns ``YOLOv3``'s output dict
(``raws_cells``, ``meta``) for the clip, so the cell-layout tail and its
kernels (K1-K6) run on it unchanged.  ``aggregation``:

* ``"stack"``: the clip becomes one 3k-channel image, frame-major (frame
  0's RGB, then frame 1's, ...), and the stem conv widens to 3k inputs;
* ``"max"`` / ``"mean"``: one batched backbone pass over the B*k frames,
  then each feature scale is reduced over time.  ``mean`` sums the frames
  in float32, divides (correctly rounded) and rounds once to the compute
  dtype, as ``jnp.mean`` does on bf16;
* ``"conv"``: the same pass, then a 1x1 ``ConvBNLeaky(k*fc -> fc)`` per
  scale over the frame-major time-stacked channels.

Flax scopes as the JAX module's: ``Darknet53_0`` / ``DarknetTiny_0``,
``ConvBNLeaky_0..`` (``conv``, shallowest scale first) and ``YOLOv3Head_0``.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn as nn

from viddet_tpu_torch.core.precision import DEFAULT_POLICY, Policy
from viddet_tpu_torch.models.common import ConvBNLeaky
from viddet_tpu_torch.models.darknet import Darknet53, DarknetTiny
from viddet_tpu_torch.models.yolo3 import YOLOv3Head, yolo_head_config
from viddet_tpu_torch.ops.boxes import div_rn

AGGREGATIONS = ("stack", "max", "mean", "conv")


class TemporalYOLOv3(nn.Module):
    """YOLOv3 over k-frame clips; the output dict matches ``YOLOv3``'s."""

    def __init__(self, num_classes: int, k: int = 3, backbone: str = "darknet53",
                 aggregation: str = "max", anchors=None, strides=None,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        if aggregation not in AGGREGATIONS:
            raise ValueError(f"unknown aggregation {aggregation!r}")
        self.num_classes, self.k, self.aggregation = num_classes, k, aggregation
        anchors, strides, head_channels = yolo_head_config(backbone, anchors, strides)
        in_channels = 3 * k if aggregation == "stack" else 3
        net = Darknet53 if backbone == "darknet53" else DarknetTiny
        self.backbone = net(policy, in_channels=in_channels)
        feat_channels = self.backbone.OUT_CHANNELS
        self.aggregators = None
        if aggregation == "conv":
            self.aggregators = nn.ModuleList(
                ConvBNLeaky(k * fc, fc, 1, policy=policy, scope=f"ConvBNLeaky_{i}")
                for i, fc in enumerate(feat_channels))
        self.head = YOLOv3Head(num_classes, anchors, strides, head_channels,
                               feat_channels[::-1], tiny=backbone == "tiny", policy=policy)

    def _reduce(self, i: int, f: torch.Tensor, b: int) -> torch.Tensor:
        """One scale's (B*k, fc, fh, fw) frame features -> (B, fc, fh, fw)."""
        _, fc, fh, fw = f.shape
        ft = f.unflatten(0, (b, self.k))
        if self.aggregation == "max":
            return ft.amax(dim=1)
        if self.aggregation == "mean":
            acc = ft[:, 0].float()
            for t in range(1, self.k):
                acc = acc + ft[:, t].float()
            return div_rn(acc, float(self.k)).to(f.dtype)
        # conv: NHWC channels frame-major (frame 0's fc, then frame 1's, ...)
        stacked = ft.permute(0, 3, 4, 1, 2).reshape(b, fh, fw, self.k * fc)
        return self.aggregators[i](stacked.permute(0, 3, 1, 2))

    def forward(self, clips: torch.Tensor) -> Dict[str, Any]:
        if clips.dim() != 5:
            raise ValueError(f"clips must be (B, k, H, W, 3), got {tuple(clips.shape)}")
        b, k, h, w, c = clips.shape
        if k != self.k:
            raise ValueError(f"expected k={self.k}, got {k}")
        if self.aggregation == "stack":
            x = clips.movedim(1, 3).reshape(b, h, w, k * c)
            feats = self.backbone(
                x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last))
        else:
            frames = clips.reshape(b * k, h, w, c)
            per_frame = self.backbone(
                frames.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last))
            feats = [self._reduce(i, f, b) for i, f in enumerate(per_frame)]
        return self.head(feats[::-1])  # deepest first
