"""YOLOv3 detector (counterpart of ``viddet_tpu/models/yolo3.py``).

Scale order is deepest first (strides 32, 16, 8); the flat anchor axis is
(row, col, anchor) per scale, scales concatenated deepest first.  Each
output conv's NHWC result, viewed as (B, h*w, na*(5+C)), is the cell
layout: lane group ``[a*(5+C), (a+1)*(5+C))`` is anchor a.  Under
channels_last that view is free.  The per-scale decode constants (the JAX
model's ``_scale_constants``) are ``ops.nms_gather_cuda.scale_constants``,
which the tail computes from each scale's meta.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Tuple

import torch
import torch.nn as nn

from viddet_tpu_torch.core.precision import DEFAULT_POLICY, Policy
from viddet_tpu_torch.models.common import BiasConv, ConvBNLeaky, FlaxNames, upsample2x_nearest
from viddet_tpu_torch.models.darknet import Darknet53, DarknetTiny
from viddet_tpu_torch.ops.nms import multiclass_nms_late_decode, multiclass_nms_late_decode_cells
from viddet_tpu_torch.ops.nms_gather_cuda import decode_constants

# Default COCO anchor boxes (input-pixel units), deepest scale first.
ANCHORS_DARKNET53 = (
    ((116, 90), (156, 198), (373, 326)),  # stride 32
    ((30, 61), (62, 45), (59, 119)),  # stride 16
    ((10, 13), (16, 30), (33, 23)),  # stride 8
)
STRIDES_DARKNET53 = (32, 16, 8)

ANCHORS_TINY = (
    ((81, 82), (135, 169), (344, 319)),  # stride 32
    ((10, 14), (23, 27), (37, 58)),  # stride 16
)
STRIDES_TINY = (32, 16)


def yolo_head_config(backbone: str, anchors=None, strides=None):
    """Default (anchors, strides, head_channels) per backbone family."""
    if backbone == "darknet53":
        return anchors or ANCHORS_DARKNET53, strides or STRIDES_DARKNET53, (512, 256, 128)
    if backbone == "tiny":
        return anchors or ANCHORS_TINY, strides or STRIDES_TINY, (256, 128)
    raise ValueError(f"unknown backbone {backbone!r}")


class YOLODetectionBlock(nn.Module):
    """Five-conv block + branch: returns (route, tip)."""

    def __init__(self, cin: int, channels: int, policy: Policy, scope: str):
        super().__init__()
        names = FlaxNames(scope)
        convs, c = [], cin
        for _ in range(2):
            convs.append(ConvBNLeaky(c, channels, 1, policy=policy, scope=names("ConvBNLeaky")))
            convs.append(ConvBNLeaky(channels, channels * 2, 3, policy=policy,
                                     scope=names("ConvBNLeaky")))
            c = channels * 2
        self.body = nn.Sequential(*convs)
        self.route = ConvBNLeaky(c, channels, 1, policy=policy, scope=names("ConvBNLeaky"))
        self.tip = ConvBNLeaky(channels, channels * 2, 3, policy=policy,
                               scope=names("ConvBNLeaky"))

    def forward(self, x):
        route = self.route(self.body(x))
        return route, self.tip(route)


class TinyBlock(nn.Module):
    """The tiny head's block: an optional 1x1 bottleneck (route) then a 3x3
    tip.  Returns (route or None, tip)."""

    def __init__(self, cin: int, channels: int, with_route: bool, policy: Policy,
                 names: FlaxNames):
        super().__init__()
        self.route = None
        if with_route:
            self.route = ConvBNLeaky(cin, channels, 1, policy=policy, scope=names("ConvBNLeaky"))
            cin = channels
        self.tip = ConvBNLeaky(cin, channels * 2, 3, policy=policy, scope=names("ConvBNLeaky"))

    def forward(self, x):
        route = None if self.route is None else self.route(x)
        return route, self.tip(x if route is None else route)


class YOLOv3Head(nn.Module):
    """FPN-lite neck + per-scale output convs.  Consumes features deepest
    first; returns the per-scale cell tensors and their meta."""

    def __init__(self, num_classes, anchors, strides, head_channels, feat_channels,
                 tiny: bool = False, policy: Policy = DEFAULT_POLICY,
                 scope: str = "YOLOv3Head_0"):
        super().__init__()
        self.anchors, self.strides = anchors, strides
        names = FlaxNames(scope)
        num_pred = 5 + num_classes
        laterals, blocks, outputs = [], [], []
        route_ch = None
        for i, (ch, fc) in enumerate(zip(head_channels, feat_channels)):
            cin = fc
            if route_ch is not None:
                laterals.append(ConvBNLeaky(route_ch, ch, 1, policy=policy,
                                            scope=names("ConvBNLeaky")))
                cin = ch + fc
            if tiny:  # the deepest scale routes on; no 5-conv block
                blocks.append(TinyBlock(cin, ch, i == 0, policy, names))
                route_ch = ch if i == 0 else None
            else:
                blocks.append(YOLODetectionBlock(cin, ch, policy, names("YOLODetectionBlock")))
                route_ch = ch
            outputs.append(BiasConv(ch * 2, len(anchors[i]) * num_pred, 1, policy,
                                    f"{scope}/output_{i}"))
        self.laterals = nn.ModuleList(laterals)
        self.blocks = nn.ModuleList(blocks)
        self.outputs = nn.ModuleList(outputs)

    def forward(self, feats: List[torch.Tensor]) -> Dict[str, Any]:
        cells, meta = [], []
        route = None
        for i, feat in enumerate(feats):
            if route is not None:
                lateral = upsample2x_nearest(self.laterals[i - 1](route))
                feat = torch.cat([lateral, feat], dim=1)
            route, tip = self.blocks[i](feat)
            out = self.outputs[i](tip)  # (B, na*(5+C), h, w), channels_last
            b, lanes, h, w = out.shape
            cells.append(out.permute(0, 2, 3, 1).reshape(b, h * w, lanes))
            meta.append((h * w, w, int(self.strides[i]),
                         tuple((float(aw), float(ah)) for aw, ah in self.anchors[i])))
        return {"raws_cells": tuple(cells), "meta": tuple(meta)}


class YOLOv3(nn.Module):
    """Backbone + head.  ``forward`` takes NHWC images (B, H, W, 3) and
    returns ``{"raws_cells": per-scale (B, h*w, na*(5+C)) tensors in the
    compute dtype, deepest first, "meta": per-scale (cells, width, stride,
    anchors)}``."""

    def __init__(self, num_classes: int, backbone: str = "darknet53", anchors=None,
                 strides=None, policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.num_classes = num_classes
        anchors, strides, head_channels = yolo_head_config(backbone, anchors, strides)
        if backbone == "darknet53":
            self.backbone = Darknet53(policy)
        else:
            self.backbone = DarknetTiny(policy)
        self.head = YOLOv3Head(
            num_classes, anchors, strides, head_channels,
            self.backbone.OUT_CHANNELS[::-1], tiny=backbone == "tiny", policy=policy,
        )

    def forward(self, images: torch.Tensor) -> Dict[str, Any]:
        x = images.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        feats = self.backbone(x)
        return self.head(feats[::-1])  # deepest first


@functools.lru_cache(maxsize=64)
def _decode_constants(meta, device: torch.device):
    """``decode_constants``, built on the device once per meta: its
    host-to-device copies would wait for the work queued before them, and
    the training step would stall the host after its forward pass.  Made
    outside inference mode, so a train step may use a table first made
    under it."""
    with torch.inference_mode(False):
        return decode_constants(meta, device)


def flatten_outputs(outputs: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX model's flat output dict from the cell tensors: raw_xy,
    raw_wh (float32), raw_obj, raw_cls, cls_max (compute dtype) over the
    flat anchor axis, the decoded float32 corner boxes in input pixels
    (``viddet_tpu/models/yolo3.py:203-207``: centre (sigmoid(raw_xy) +
    grid) * stride, size exp(raw_wh) * anchor), and the decode constants
    grid_xy / anchors / strides."""
    cells, meta = outputs["raws_cells"], outputs["meta"]
    na = len(meta[0][3])
    b = cells[0].shape[0]
    raw = torch.cat([x.reshape(b, -1, x.shape[-1] // na) for x in cells], dim=1)
    grid_xy, anchor_wh, stride_n = _decode_constants(tuple(meta), raw.device)
    raw_xy, raw_wh = raw[..., 0:2].float(), raw[..., 2:4].float()
    center = (torch.sigmoid(raw_xy) + grid_xy) * stride_n
    half = 0.5 * (torch.exp(raw_wh) * anchor_wh)
    return {
        "raw_xy": raw_xy,
        "raw_wh": raw_wh,
        "raw_obj": raw[..., 4:5],
        "raw_cls": raw[..., 5:],
        "cls_max": raw[..., 5:].amax(dim=-1),
        "boxes": torch.cat([center - half, center + half], dim=-1),
        "grid_xy": grid_xy,
        "anchors": anchor_wh,
        "strides": stride_n,
    }


@dataclasses.dataclass(frozen=True)
class NMSConfig:
    """Post-processing knobs (defaults as ``viddet_tpu/models/yolo3.py:272``).

    backend: "auto" launches each kernel for CUDA tensors and runs its plain
    version for CPU tensors; "plain" runs the plain versions on any device
    (the chain the kernels are held against).
    ranking: the stage-2 ranking of ``forward_and_postprocess``'s tail
    (``ops/nms.py``): "hier" (K1, K2 twice, K3 ``extract_m=9``, K4, K5, K6),
    "det" (K1, K2 twice, K3 ``extract_m=0``, K5, K6), or None to read
    ``VIDDET_PAIR_TOPK`` on every call (unset or "approx": hier).
    """

    iou_thresh: float = 0.45
    valid_thresh: float = 0.01
    topk: int = 400
    post_nms: int = 100
    backend: str = "auto"
    ranking: str | None = None

    def kwargs(self) -> dict:
        return dict(iou_thresh=self.iou_thresh, valid_thresh=self.valid_thresh,
                    topk=self.topk, post_nms=self.post_nms, backend=self.backend)


def postprocess(outputs: Dict[str, torch.Tensor], nms: NMSConfig = NMSConfig()):
    """Flat outputs (``flatten_outputs``) -> (ids, scores, boxes), -1 padded."""
    cls_max = outputs.get("cls_max")
    if cls_max is None:
        cls_max = outputs["raw_cls"].amax(dim=-1)
    return multiclass_nms_late_decode(
        outputs["raw_xy"], outputs["raw_wh"], outputs["raw_obj"], outputs["raw_cls"],
        cls_max, outputs["grid_xy"], outputs["anchors"], outputs["strides"],
        **nms.kwargs(),
    )


def forward_and_postprocess(model: YOLOv3, images: torch.Tensor,
                            nms: NMSConfig = NMSConfig()) -> Tuple[torch.Tensor, ...]:
    """One inference step: NHWC images -> (ids, scores, boxes) through the
    cell-layout tail, under ``nms.ranking``: on a CUDA device the
    hierarchical ranking runs K1, K2 (twice), K3 in its ``extract_m=9``
    form, K4, K5 and K6; the deterministic one K1, K2 (twice), K3 in its
    ``extract_m=0`` form, K5 and K6.  Under ``VIDDET_CONV_BACKEND=pallas``
    the backbone's three shallow downsample convs run K8
    (``models/common.py``)."""
    out = model(images)
    return multiclass_nms_late_decode_cells(out["raws_cells"], out["meta"], **nms.kwargs(),
                                            ranking=nms.ranking)
