"""SSD-512 ResNet-50 (counterpart of ``viddet_tpu/models/ssd.py``).

ResNet-50 c3/c4/c5 (strides 8/16/32) and four extra stride-2 ``_ConvBN``
pairs (strides 64..512) give seven maps; a 3x3 class conv and a 3x3 box
conv with bias per map predict ``len(ratios) + 1`` anchors per cell.  The
anchors are numpy constants, built once per set of map sizes and kept on
the device.  At 512 px there are 24,564 anchors.

``ssd_forward_and_postprocess`` takes the float32 softmax, drops the
background column and runs ``multiclass_nms_dense_two_stage``: on a CUDA
device K2 twice (the anchor ranking over N, the pair ranking over k*C),
K5 and K6.

Training (``ssd_loss``): each anchor matches its best ground-truth box at
IoU >= 0.5 and each box its best anchor; softmax cross-entropy with 3:1
hard-negative mining, SmoothL1 on the positives' variance-scaled deltas.
The targets equal the JAX package's jitted train step bit for bit: there
the anchors are a graph constant, so XLA's CPU program divides by them
through their float32 reciprocals, and its ``log`` is
``train.targets.log_xla_cpu``.  Training launches no kernel.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from viddet_tpu_torch.core.precision import DEFAULT_POLICY, Policy
from viddet_tpu_torch.models.common import BiasConv
from viddet_tpu_torch.models.resnet import ConvBN, ResNet50
from viddet_tpu_torch.models.yolo3 import NMSConfig
from viddet_tpu_torch.ops.boxes import box_iou
from viddet_tpu_torch.ops.nms import Detections, multiclass_nms_dense_two_stage
from viddet_tpu_torch.train.targets import last_of_duplicates, log_xla_cpu

# SSD512 layer config: stride, anchor size s_k, next size s_{k+1}, ratios
SSD512_STRIDES = (8, 16, 32, 64, 128, 256, 512)
SSD512_SIZES = (35.84, 76.8, 153.6, 230.4, 307.2, 384.0, 460.8, 537.6)
SSD512_RATIOS = (
    (1.0, 2.0, 0.5),
    (1.0, 2.0, 0.5, 3.0, 1.0 / 3.0),
    (1.0, 2.0, 0.5, 3.0, 1.0 / 3.0),
    (1.0, 2.0, 0.5, 3.0, 1.0 / 3.0),
    (1.0, 2.0, 0.5, 3.0, 1.0 / 3.0),
    (1.0, 2.0, 0.5),
    (1.0, 2.0, 0.5),
)
BOX_VARIANCES = (0.1, 0.1, 0.2, 0.2)
EXTRA_CHANNELS = (512, 256, 256, 256)


def anchors_per_cell(ratios: Sequence[float]) -> int:
    return len(ratios) + 1  # extra geometric-mean-size square box


def _layer_anchors(fh: int, fw: int, stride: int, layer_idx: int) -> np.ndarray:
    """(fh*fw*A, 4) corner anchors of one map, (row, col, anchor) order."""
    ratios = SSD512_RATIOS[layer_idx]
    s = SSD512_SIZES[layer_idx]
    s_next = SSD512_SIZES[layer_idx + 1]
    whs = [(s, s), (math.sqrt(s * s_next), math.sqrt(s * s_next))]
    for r in ratios:
        if r == 1.0:
            continue
        whs.append((s * math.sqrt(r), s / math.sqrt(r)))
    cx, cy = np.meshgrid((np.arange(fw) + 0.5) * stride, (np.arange(fh) + 0.5) * stride)
    layer = np.stack(
        [np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], axis=-1) for w, h in whs],
        axis=2)  # (fh, fw, A, 4)
    return layer.reshape(-1, 4)


def _anchors_for(sizes: Tuple[Tuple[int, int], ...]) -> np.ndarray:
    return np.concatenate([_layer_anchors(fh, fw, SSD512_STRIDES[i], i)
                           for i, (fh, fw) in enumerate(sizes)], axis=0).astype(np.float32)


def generate_ssd_anchors(image_size: int) -> np.ndarray:
    """(N, 4) corner anchors of all 7 maps; map sides are "SAME" stride-2
    sizes, ceil(image_size / stride)."""
    fm = [max(-(-image_size // stride), 1) for stride in SSD512_STRIDES]
    return _anchors_for(tuple((f, f) for f in fm))


def decode_ssd_boxes(deltas: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """Variance-scaled (..., 4) deltas on corner anchors -> corner boxes."""
    vx, vy, vw, vh = BOX_VARIANCES
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    acx = anchors[..., 0] + 0.5 * aw
    acy = anchors[..., 1] + 0.5 * ah
    cx = deltas[..., 0] * vx * aw + acx
    cy = deltas[..., 1] * vy * ah + acy
    w = torch.exp((deltas[..., 2] * vw).clamp(-10.0, 10.0)) * aw
    h = torch.exp((deltas[..., 3] * vh).clamp(-10.0, 10.0)) * ah
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)


class SSD(nn.Module):
    """SSD-512 ResNet-50.  ``forward`` takes NHWC images and returns
    ``cls_logits`` (B, N, C+1; class 0 background) in the compute dtype,
    ``box_deltas`` (B, N, 4) float32, ``anchors`` (N, 4) and ``boxes``
    (B, N, 4) float32.  ``backbone_blocks`` / ``backbone_widths`` override
    the ResNet stages (the JAX module's fields of the same names)."""

    def __init__(self, num_classes: int, image_size: int = 512,
                 policy: Policy = DEFAULT_POLICY, backbone_blocks=None, backbone_widths=None):
        super().__init__()
        self.num_classes, self.image_size = num_classes, image_size
        self.backbone = ResNet50(policy, backbone_blocks, backbone_widths)
        extras, cin = [], self.backbone.out_channels[-1]
        for i, ch in enumerate(EXTRA_CHANNELS):
            extras.append(nn.Sequential(
                ConvBN(cin, ch // 2, 1, 1, policy=policy, scope=f"_ConvBN_{2 * i}"),
                ConvBN(ch // 2, ch, 3, 2, policy=policy, scope=f"_ConvBN_{2 * i + 1}")))
            cin = ch
        self.extras = nn.ModuleList(extras)
        map_channels = self.backbone.out_channels[1:] + EXTRA_CHANNELS
        self.cls_preds = nn.ModuleList(
            BiasConv(ch, anchors_per_cell(r) * (num_classes + 1), 3, policy, f"cls_pred_{i}")
            for i, (ch, r) in enumerate(zip(map_channels, SSD512_RATIOS)))
        self.box_preds = nn.ModuleList(
            BiasConv(ch, anchors_per_cell(r) * 4, 3, policy, f"box_pred_{i}")
            for i, (ch, r) in enumerate(zip(map_channels, SSD512_RATIOS)))
        self._anchors: Dict[tuple, torch.Tensor] = {}

    def anchors(self, sizes: Tuple[Tuple[int, int], ...], device) -> torch.Tensor:
        key = (sizes, str(device))
        if key not in self._anchors:
            self._anchors[key] = torch.from_numpy(_anchors_for(sizes)).to(device)
        return self._anchors[key]

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = images.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        maps = self.backbone(x)[1:]  # c3, c4, c5
        y = maps[-1]
        for extra in self.extras:
            y = extra(y)
            maps.append(y)
        b, c1 = images.shape[0], self.num_classes + 1
        cls_outs, box_outs = [], []
        for fm, cls_pred, box_pred in zip(maps, self.cls_preds, self.box_preds):
            cls_outs.append(cls_pred(fm).permute(0, 2, 3, 1).reshape(b, -1, c1))
            box_outs.append(box_pred(fm).permute(0, 2, 3, 1).reshape(b, -1, 4).float())
        cls_logits = torch.cat(cls_outs, dim=1)
        box_deltas = torch.cat(box_outs, dim=1)
        anchors = self.anchors(tuple(tuple(fm.shape[2:]) for fm in maps), images.device)
        return {"cls_logits": cls_logits, "box_deltas": box_deltas, "anchors": anchors,
                "boxes": decode_ssd_boxes(box_deltas, anchors)}


def encode_ssd_boxes(gt_boxes: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """Corner GT (..., N, 4) against corner anchors (N, 4) -> variance-scaled
    deltas (``ssd.py:160``), as XLA compiles it with constant anchors: each
    division by an anchor term is a multiplication by its float32
    reciprocal, ``/ 0.2`` a multiplication by 5, and the log is XLA's CPU
    log.  (A tensor-by-tensor division is correctly rounded on the CPU and
    the card alike.)"""
    vx, vy, vw, vh = BOX_VARIANCES
    one = torch.ones((), dtype=torch.float32, device=anchors.device)
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    acx = anchors[..., 0] + 0.5 * aw
    acy = anchors[..., 1] + 0.5 * ah
    gw = (gt_boxes[..., 2] - gt_boxes[..., 0]).clamp_min(1e-6)
    gh = (gt_boxes[..., 3] - gt_boxes[..., 1]).clamp_min(1e-6)
    gcx = gt_boxes[..., 0] + 0.5 * gw
    gcy = gt_boxes[..., 1] + 0.5 * gh
    return torch.stack([
        (gcx - acx) * (one / (aw * vx)),
        (gcy - acy) * (one / (ah * vy)),
        log_xla_cpu(gw * (one / aw)) * float(np.float32(1) / np.float32(vw)),
        log_xla_cpu(gh * (one / ah)) * float(np.float32(1) / np.float32(vh)),
    ], dim=-1)


@torch.no_grad()
def assign_ssd_targets(anchors: torch.Tensor, gt_boxes: torch.Tensor, gt_ids: torch.Tensor,
                       match_thresh: float = 0.5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched matching (``ssd.py:195``): (cls_target (B, N) int32, 0 =
    background, box_target (B, N, 4) deltas, 0 off the matches).

    Each anchor takes its best-IoU box (the first of ties) when the IoU is
    >= ``match_thresh``; each valid box's best anchor is forced onto it
    (where two valid boxes share a best anchor, the later box wins).
    Padded boxes (id < 0) match nothing.
    """
    n = anchors.shape[0]
    valid = gt_ids >= 0
    iou = torch.where(valid[:, None, :], box_iou(anchors, gt_boxes.float()), -1.0)  # (B, N, M)
    best_iou, best_gt = iou.max(dim=2)
    matched = best_iou >= match_thresh
    best_anchor = iou.argmax(dim=1)  # (B, M)
    slot = torch.where(last_of_duplicates(best_anchor, valid), best_anchor, n)  # n: dropped
    b, m = gt_ids.shape
    forced = torch.zeros((b, n + 1), dtype=torch.bool, device=anchors.device)
    forced.scatter_(1, slot, True)
    forced_gt = torch.zeros((b, n + 1), dtype=torch.int64, device=anchors.device)
    forced_gt.scatter_(1, slot, torch.arange(m, device=anchors.device).expand(b, m))
    forced, forced_gt = forced[:, :n], forced_gt[:, :n]
    assigned = torch.where(forced, forced_gt, best_gt)
    matched = matched | forced
    cls_target = torch.where(matched, gt_ids.gather(1, assigned).int() + 1, 0).int()
    box_target = encode_ssd_boxes(gt_boxes.float().gather(1, assigned[..., None].expand(b, n, 4)),
                                  anchors)
    return cls_target, torch.where(matched[..., None], box_target, 0.0)


def smooth_l1(x: torch.Tensor) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5)


def inverse_permutation(order: torch.Tensor) -> torch.Tensor:
    """``argsort(order)`` of a permutation along the last axis: each entry's
    rank, by one scatter (the indices are distinct, so the order of the
    writes does not matter)."""
    ranks = torch.arange(order.shape[-1], device=order.device).expand_as(order)
    return torch.empty_like(order).scatter_(-1, order, ranks)


def ssd_loss(outputs: Dict[str, torch.Tensor], gt_boxes: torch.Tensor, gt_ids: torch.Tensor,
             neg_ratio: float = 3.0) -> Dict[str, torch.Tensor]:
    """Softmax CE with in-step 3:1 hard-negative mining, plus SmoothL1 on
    the positives (``ssd.py:250``).  Each image's sums are divided by its
    positives (at least 1), then averaged over the batch.

    The negatives are ranked by their CE, highest first, ties in anchor
    order: a stable sort, as ``jnp.argsort`` is (an image with no boxes on
    a blank frame has exact ties)."""
    cls_logits = outputs["cls_logits"].float()
    cls_t, box_t = assign_ssd_targets(outputs["anchors"], gt_boxes, gt_ids)
    log_probs = torch.log_softmax(cls_logits, dim=-1)
    ce = -log_probs.gather(-1, cls_t[..., None].long())[..., 0]  # (B, N)
    pos = cls_t > 0
    npos = pos.sum(dim=1)
    with torch.no_grad():
        neg_ce = torch.where(pos, -torch.inf, ce)
        order = torch.sort(-neg_ce, dim=1, stable=True).indices
        keep_neg = inverse_permutation(order) < (neg_ratio * npos)[:, None]
        cls_mask = pos | keep_neg
    denom = npos.float().clamp_min(1.0)
    cls_loss = ((ce * cls_mask).sum(dim=1) / denom).mean()
    box_err = smooth_l1(outputs["box_deltas"] - box_t)
    box_loss = ((box_err * pos[..., None]).sum(dim=(1, 2)) / denom).mean()
    return {"cls": cls_loss, "box": box_loss, "total": cls_loss + box_loss,
            "npos": npos.float().mean()}


# The JAX package's SSD config (``viddet_tpu/models/ssd.py:287``) has the
# same fields and defaults as YOLOv3's; SSD ignores ``ranking``.
SSDNMSConfig = NMSConfig


def ssd_postprocess(out: Dict[str, torch.Tensor],
                    nms: SSDNMSConfig = SSDNMSConfig()) -> Detections:
    """SSD outputs -> (ids, scores, boxes): the float32 softmax without its
    background column, then the dense two-stage ranking and NMS."""
    scores = torch.softmax(out["cls_logits"].float(), dim=-1)[..., 1:]
    return multiclass_nms_dense_two_stage(out["boxes"], scores, **nms.kwargs())


def ssd_forward_and_postprocess(model: SSD, images: torch.Tensor,
                                nms: SSDNMSConfig = SSDNMSConfig()) -> Detections:
    """One inference step: NHWC images -> (ids, scores, boxes), -1 padded."""
    return ssd_postprocess(model(images), nms)
