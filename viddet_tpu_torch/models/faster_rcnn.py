"""Faster R-CNN ResNet-50 FPN (counterpart of
``viddet_tpu/models/faster_rcnn.py``).

Every stage keeps fixed shapes, as in JAX:

* RPN proposals: per-level top-k -> concat -> top-k -> class-agnostic
  greedy NMS (K5 at K = ``rpn_nms_input``) -> the first ``post_nms``
  proposals in kept-first order, with a validity mask;
* ROIAlign of every proposal on its FPN level (K7), then the two-layer box
  head;
* detections: per-class boxes flattened to R*C candidates -> exact top-k
  (K2 and a stable sort) -> class-aware NMS (K5, K6), padded with -1.

The RPN ranks raw objectness *logits*, which are signed, so K2 (whose
precondition is scores >= 0 apart from -1 padding) cannot rank them:
the per-level and cross-level rankings are ``torch.sort(descending=True,
stable=True)``, which equals ``lax.top_k`` ties included.  The detection
ranking ranks softmax probabilities, which K2 takes.

Proposals that NMS did not keep stay in the compacted proposal set after
the kept ones, with ``proposal_valid`` false; they go through ROIAlign and
the box head, and ``frcnn_postprocess`` does not mask them, as in JAX.

Training (``model.train()``, ``forward(images, gt_boxes, gt_ids, ...)``):
``rpn_post_nms_train`` proposals, out of the autograd graph (K5 still
ranks them on the card), the ground truth appended, a fixed batch of
``roi_batch`` rois sampled (``sample_rois``), and the box head on the
sampled rois through the plain packed ROIAlign under autograd (the JAX
package trains through its XLA ROIAlign; K7 has no backward).
``frcnn_loss`` assigns and samples the RPN's anchors.  The samplers rank
uniforms that the caller passes in, drawn from an explicit
``torch.Generator`` on the model's device (``train.loop``), so the tests
feed them JAX's own ``jax.random`` draws.  Under several processes each
draws the global batch's uniforms and keeps its own rows
(``parallel.mesh.global_uniform``), and ``frcnn_loss`` divides by the
global batch's counts, so the processes together take the step that one
process with the whole batch takes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from viddet_tpu_torch.core.precision import DEFAULT_POLICY, Policy
from viddet_tpu_torch.models.common import BiasConv, upsample2x_nearest
from viddet_tpu_torch.models.resnet import ResNet50
from viddet_tpu_torch.ops import roi_align_cuda
from viddet_tpu_torch.models.ssd import inverse_permutation
from viddet_tpu_torch.ops.boxes import box_iou, clip_boxes, div_rn
from viddet_tpu_torch.ops.nms import Detections, _nms_on_candidates, _ops, _pair_top_k_det
from viddet_tpu_torch.ops.roi_align import multilevel_roi_align_packed
from viddet_tpu_torch.parallel import mesh
from viddet_tpu_torch.parallel.mesh import global_uniform
from viddet_tpu_torch.train.targets import log_xla_cpu

FPN_STRIDES = (4, 8, 16, 32, 64)  # P2..P6
ANCHOR_SCALES = (32.0, 64.0, 128.0, 256.0, 512.0)
ANCHOR_RATIOS = (0.5, 1.0, 2.0)
HEAD_DELTA_WEIGHTS = (10.0, 10.0, 5.0, 5.0)


@dataclasses.dataclass(frozen=True)
class FRCNNConfig:
    """The JAX config's fields and defaults.  ``nms_backend`` (proposal
    NMS) and ``roi_backend`` (ROIAlign) take "auto", each kernel's wrapper
    (the kernel for CUDA tensors, the plain version for CPU tensors), or
    "plain", the plain versions on any device; in training the ROIAlign is
    always the plain packed one.  Inference reads ``rpn_post_nms_test``,
    training the other counts."""

    rpn_pre_nms_topk: int = 1000  # per level
    rpn_nms_input: int = 1000  # candidates entering proposal NMS
    rpn_post_nms_train: int = 512
    rpn_post_nms_test: int = 300
    rpn_nms_thresh: float = 0.7
    rpn_batch: int = 256
    rpn_pos_fraction: float = 0.5
    rpn_pos_iou: float = 0.7
    rpn_neg_iou: float = 0.3
    roi_batch: int = 512
    roi_pos_fraction: float = 0.25
    roi_pos_iou: float = 0.5
    nms_backend: str = "auto"
    roi_backend: str = "auto"


def encode_rcnn(gt: torch.Tensor, anchors: torch.Tensor, weights=(1.0, 1.0, 1.0, 1.0),
                constant_anchors: bool = False) -> torch.Tensor:
    """R-CNN box encoding (``faster_rcnn.py:85``), as XLA's CPU program
    computes it: ``weight * (gcx - acx) / aw`` and ``weight * log(gw / aw)``
    with XLA's CPU log.  ``constant_anchors``: the RPN's anchors, a graph
    constant in JAX's train step, where XLA divides by their float32
    reciprocals (and drops the weights of 1); the rois of ``sample_rois``
    are data and divide."""
    wx, wy, ww, wh = weights
    aw = (anchors[..., 2] - anchors[..., 0]).clamp_min(1e-6)
    ah = (anchors[..., 3] - anchors[..., 1]).clamp_min(1e-6)
    acx = anchors[..., 0] + 0.5 * aw
    acy = anchors[..., 1] + 0.5 * ah
    gw = (gt[..., 2] - gt[..., 0]).clamp_min(1e-6)
    gh = (gt[..., 3] - gt[..., 1]).clamp_min(1e-6)
    gcx = gt[..., 0] + 0.5 * gw
    gcy = gt[..., 1] + 0.5 * gh
    if constant_anchors:
        if tuple(weights) != (1.0, 1.0, 1.0, 1.0):
            raise ValueError("constant_anchors takes the RPN's weights (1, 1, 1, 1)")
        one = torch.ones((), dtype=torch.float32, device=anchors.device)
        rw, rh = one / aw, one / ah
        return torch.stack([(gcx - acx) * rw, (gcy - acy) * rh, log_xla_cpu(gw * rw),
                            log_xla_cpu(gh * rh)], dim=-1)
    return torch.stack([wx * (gcx - acx) / aw, wy * (gcy - acy) / ah,
                        ww * log_xla_cpu(gw / aw), wh * log_xla_cpu(gh / ah)], dim=-1)


def decode_rcnn(deltas: torch.Tensor, anchors: torch.Tensor,
                weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """R-CNN box decoding (``faster_rcnn.py:106``), corner boxes out."""
    wx, wy, ww, wh = weights
    aw = (anchors[..., 2] - anchors[..., 0]).clamp_min(1e-6)
    ah = (anchors[..., 3] - anchors[..., 1]).clamp_min(1e-6)
    acx = anchors[..., 0] + 0.5 * aw
    acy = anchors[..., 1] + 0.5 * ah
    cx = div_rn(deltas[..., 0], wx) * aw + acx
    cy = div_rn(deltas[..., 1], wy) * ah + acy
    w = torch.exp(div_rn(deltas[..., 2], ww).clamp(-10.0, 10.0)) * aw
    h = torch.exp(div_rn(deltas[..., 3], wh).clamp(-10.0, 10.0)) * ah
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)


def _level_anchors(fh: int, fw: int, stride: int, scale: float) -> np.ndarray:
    """(fh*fw*A, 4) anchors in (row, col, ratio) order, the RPN head's
    flattening (``faster_rcnn.py:119``)."""
    whs = [(scale * np.sqrt(1.0 / r), scale * np.sqrt(r)) for r in ANCHOR_RATIOS]
    cx, cy = np.meshgrid((np.arange(fw) + 0.5) * stride, (np.arange(fh) + 0.5) * stride)
    per = [np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], axis=-1) for w, h in whs]
    return np.stack(per, axis=2).reshape(-1, 4).astype(np.float32)


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis of a score of any sign: descending,
    ties lowest index first."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def random_topk_select(uniform: torch.Tensor, eligible: torch.Tensor, k) -> torch.Tensor:
    """Up to ``k`` eligible entries of each row, chosen uniformly at random
    (``faster_rcnn.py:345``): the priority ``uniform + 10 * ~eligible``
    ranked ascending (a stable sort, as ``jnp.argsort``), then each entry's
    rank against ``k`` (an int or a (B, 1) tensor).  ``uniform`` in [0, 1)
    and ``eligible`` are (B, n); each row selects ``min(k, its eligible)``."""
    priority = uniform + (~eligible).float() * 10.0
    rank = inverse_permutation(torch.sort(priority, dim=-1, stable=True).indices)
    return eligible & (rank < k)


@torch.no_grad()
def assign_rpn_targets(anchors: torch.Tensor, gt_boxes: torch.Tensor, gt_ids: torch.Tensor,
                       cfg: FRCNNConfig, uniform: torch.Tensor):
    """RPN labels after sampling and box targets (``faster_rcnn.py:357``):
    labels (B, N) int32, 1 positive, 0 negative, -1 not sampled;
    box_targets (B, N, 4) against each anchor's best box.

    An anchor is positive at IoU >= ``rpn_pos_iou`` and every valid box's
    best anchor is; negative below ``rpn_neg_iou``.  Up to ``rpn_batch *
    rpn_pos_fraction`` positives are sampled, then negatives to fill
    ``rpn_batch``.  ``uniform`` (B, 2, N): the positives' and the
    negatives' draws."""
    n = anchors.shape[0]
    valid = gt_ids >= 0
    iou = torch.where(valid[:, None, :], box_iou(anchors, gt_boxes.float()), -1.0)  # (B, N, M)
    best_iou, best_gt = iou.max(dim=2)
    best_anchor = torch.where(valid, iou.argmax(dim=1), n)  # invalid boxes: dropped
    forced = torch.zeros((gt_ids.shape[0], n + 1), dtype=torch.bool, device=anchors.device)
    pos = (best_iou >= cfg.rpn_pos_iou) | forced.scatter_(1, best_anchor, True)[:, :n]
    neg = (best_iou < cfg.rpn_neg_iou) & ~pos
    pos_sel = random_topk_select(uniform[:, 0], pos, int(cfg.rpn_batch * cfg.rpn_pos_fraction))
    num_pos = pos_sel.sum(dim=1, keepdim=True)
    neg_sel = random_topk_select(uniform[:, 1], neg, cfg.rpn_batch - num_pos)
    labels = torch.where(pos_sel, 1, torch.where(neg_sel, 0, -1)).int()
    matched = gt_boxes.float().gather(1, best_gt[..., None].expand(*best_gt.shape, 4))
    return labels, encode_rcnn(matched, anchors, constant_anchors=True)


@torch.no_grad()
def sample_rois(uniform: torch.Tensor, proposals: torch.Tensor, p_valid: torch.Tensor,
                gt_boxes: torch.Tensor, gt_ids: torch.Tensor, cfg: FRCNNConfig):
    """The ground truth appended to the proposals, matched, and a fixed
    batch of S = ``roi_batch`` rois sampled (``faster_rcnn.py:390``).

    Returns rois (B, S, 4): positives first, then negatives, then
    padding, each group in candidate order; cls_target (B, S) int32 (0
    background, -1 padding); box_target (B, S, 4), the matched box encoded
    with weights (10, 10, 5, 5), 0 off the positives; mask (B, S) float32,
    1 where sampled.  ``uniform`` (B, 2, R + M) as ``assign_rpn_targets``'s.
    Fewer candidates than S pad with zero boxes."""
    s = cfg.roi_batch
    gt_boxes = gt_boxes.float()
    gt_valid = gt_ids >= 0
    cands = torch.cat([proposals, gt_boxes], dim=1)
    cand_valid = torch.cat([p_valid, gt_valid], dim=1)
    iou = torch.where(gt_valid[:, None, :], box_iou(cands, gt_boxes), -1.0)
    best_iou, best_gt = iou.max(dim=2)
    best_iou = torch.where(cand_valid, best_iou, -1.0)
    pos = best_iou >= cfg.roi_pos_iou
    neg = cand_valid & ~pos & (best_iou >= 0.0)
    pos_sel = random_topk_select(uniform[:, 0], pos, int(s * cfg.roi_pos_fraction))
    num_pos = pos_sel.sum(dim=1, keepdim=True)
    neg_sel = random_topk_select(uniform[:, 1], neg, s - num_pos)
    selected = pos_sel | neg_sel
    order_key = torch.where(pos_sel, 0, torch.where(neg_sel, 1, 2))
    b, n = order_key.shape
    if n < s:  # fewer candidates than the roi batch: pad
        cands = F.pad(cands, (0, 0, 0, s - n))
        order_key = F.pad(order_key, (0, s - n), value=2)
        selected, pos_sel = (F.pad(t, (0, s - n)) for t in (selected, pos_sel))
        best_gt = F.pad(best_gt, (0, s - n))
    order = torch.sort(order_key, dim=1, stable=True).indices[:, :s]
    rois = cands.gather(1, order[..., None].expand(b, s, 4))
    sel, is_pos, matched_gt = (t.gather(1, order) for t in (selected, pos_sel, best_gt))
    cls_t = torch.where(is_pos, gt_ids.gather(1, matched_gt).int() + 1, 0)
    cls_t = torch.where(sel, cls_t, -1).int()
    box_t = encode_rcnn(gt_boxes.gather(1, matched_gt[..., None].expand(b, s, 4)), rois,
                        HEAD_DELTA_WEIGHTS)
    return rois, cls_t, torch.where(is_pos[..., None], box_t, 0.0), sel.float()


def _smooth_l1(x: torch.Tensor, beta: float = 1.0 / 9.0) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax < beta, 0.5 * x * x / beta, ax - 0.5 * beta)


def _loss_denominators(rpn_count: torch.Tensor, head_count: torch.Tensor):
    """The RPN's and the head's denominators: the sampled anchors and rois
    of the whole batch, at least 1.  Under several processes they are the
    global batch's counts (a detached all-reduce) divided by the process
    count: each process's loss is then its share of the global sum over
    the global count, times the processes, and their mean, which the
    gradient average differentiates, is the global loss."""
    counts = torch.stack([rpn_count, head_count]).detach()
    world = mesh.process_count()
    if world > 1:
        mesh.all_reduce_([counts])
        return (counts.clamp_min(1.0) / world).unbind()
    return counts.clamp_min(1.0).unbind()


def frcnn_loss(outputs: Dict[str, torch.Tensor], gt_boxes: torch.Tensor, gt_ids: torch.Tensor,
               cfg: FRCNNConfig, rpn_uniform: torch.Tensor) -> Dict[str, torch.Tensor]:
    """RPN (sigmoid BCE and SmoothL1 over the sampled anchors) and head
    (softmax CE over the sampled rois, SmoothL1 on the positives' class
    deltas) losses of a train-mode forward (``faster_rcnn.py:454``).
    ``rpn_uniform`` (B, 2, N anchors) drives the RPN's sampling."""
    labels, rpn_box_t = assign_rpn_targets(outputs["anchors"], gt_boxes, gt_ids, cfg, rpn_uniform)
    obj = outputs["rpn_obj"]
    pos = (labels == 1).float()
    sampled = (labels >= 0).float()
    cls_t = outputs["roi_cls_target"].long()  # (B, S), -1 padding
    mask = (cls_t >= 0).float()
    denom, head_denom = _loss_denominators(sampled.sum(), mask.sum())
    bce = obj.clamp_min(0.0) - obj * pos + torch.log1p(torch.exp(-obj.abs()))
    rpn_cls = (bce * sampled).sum() / denom
    rpn_box = (_smooth_l1(outputs["rpn_delta"] - rpn_box_t) * pos[..., None]).sum() / denom

    logp = torch.log_softmax(outputs["roi_cls_logits"], dim=-1)
    ce = -logp.gather(-1, cls_t.clamp_min(0)[..., None])[..., 0]
    head_cls = (ce * mask).sum() / head_denom
    b, s = cls_t.shape
    cls_idx = (cls_t - 1).clamp_min(0)  # the foreground class's slot
    deltas = outputs["roi_box_deltas"].gather(2, cls_idx[..., None, None].expand(b, s, 1, 4))
    head_box = (_smooth_l1(deltas[:, :, 0] - outputs["roi_box_target"])
                * (cls_t > 0).float()[..., None]).sum() / head_denom
    return {"rpn_cls": rpn_cls, "rpn_box": rpn_box, "cls": head_cls, "box": head_box,
            "total": rpn_cls + rpn_box + head_cls + head_box}


class Dense(nn.Module):
    """Flax ``nn.Dense`` in the compute dtype (product rounded to it, then
    the bias added in it).  ``weight`` is (out, in): the Flax kernel
    transposed."""

    def __init__(self, cin: int, cout: int, policy: Policy, scope: str):
        super().__init__()
        self.policy, self.scope = policy, scope
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))
        nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.policy.compute_dtype
        return F.linear(x, self.weight.to(cd)) + self.bias.to(cd)


class FPN(nn.Module):
    """Top-down feature pyramid: P2..P5 and P6 (``faster_rcnn.py:139``)."""

    def __init__(self, in_channels, channels: int = 256, policy: Policy = DEFAULT_POLICY,
                 scope: str = "FPN_0"):
        super().__init__()
        self.laterals = nn.ModuleList(BiasConv(c, channels, 1, policy, f"{scope}/lateral_{i}")
                                      for i, c in enumerate(in_channels))
        self.posts = nn.ModuleList(BiasConv(channels, channels, 3, policy, f"{scope}/post_{i}")
                                   for i in range(len(in_channels)))

    def forward(self, feats: List[torch.Tensor]) -> List[torch.Tensor]:
        laterals = [conv(f) for conv, f in zip(self.laterals, feats)]
        outs = [laterals[-1]]
        for lat in laterals[-2::-1]:
            up = upsample2x_nearest(outs[0])[:, :, : lat.shape[2], : lat.shape[3]]
            outs.insert(0, lat + up)
        pyramid = [conv(o) for conv, o in zip(self.posts, outs)]
        return pyramid + [pyramid[-1][:, :, ::2, ::2]]  # P6: the 1x1/2 max-pool


class RPNHead(nn.Module):
    """Shared 3x3 conv, then objectness and delta 1x1s on every level.
    Both maps flatten in NHWC order (row, col, ratio), as the anchors do."""

    def __init__(self, channels: int = 256, policy: Policy = DEFAULT_POLICY,
                 scope: str = "RPNHead_0"):
        super().__init__()
        na = len(ANCHOR_RATIOS)
        self.conv = BiasConv(channels, channels, 3, policy, f"{scope}/rpn_conv")
        self.obj = BiasConv(channels, na, 1, policy, f"{scope}/rpn_obj")
        self.delta = BiasConv(channels, na * 4, 1, policy, f"{scope}/rpn_delta")

    def forward(self, pyramid: List[torch.Tensor]):
        objs, deltas = [], []
        for fm in pyramid:
            x = F.relu(self.conv(fm))
            b = x.shape[0]
            objs.append(self.obj(x).permute(0, 2, 3, 1).reshape(b, -1))
            deltas.append(self.delta(x).permute(0, 2, 3, 1).reshape(b, -1, 4).float())
        return objs, deltas


class FasterRCNN(nn.Module):
    """``forward`` takes NHWC images (B, H, W, 3) and returns, in eval mode,
    ``{"anchors" (A, 4), "rpn_obj" (B, A) float32, "rpn_delta" (B, A, 4),
    "proposals" (B, R, 4), "proposal_valid" (B, R) bool, "roi_cls_logits"
    (B, R, C+1), "roi_box_deltas" (B, R, C, 4)}``, all float32 but the mask,
    R = ``rpn_post_nms_test``.  In train mode it also takes the padded
    ground truth and either ``generator`` (a ``torch.Generator`` on the
    model's device) or ``roi_uniform`` (B, 2, R + M) for the roi sampling,
    R = ``rpn_post_nms_train``; the head runs on the S = ``roi_batch``
    sampled rois, and the outputs add "rois" (B, S, 4), "roi_cls_target",
    "roi_box_target" and "roi_mask" (``sample_rois``).

    On a CUDA device, proposal NMS runs K5 and the ROIAlign K7 (under the
    config's "auto" backends).  ``backbone_blocks`` / ``backbone_widths``
    override the ResNet stages (a shallow model for CPU tests)."""

    def __init__(self, num_classes: int, config: FRCNNConfig = FRCNNConfig(),
                 policy: Policy = DEFAULT_POLICY, backbone_blocks=None, backbone_widths=None):
        super().__init__()
        self.num_classes, self.config, self.policy = num_classes, config, policy
        self.backbone = ResNet50(policy, backbone_blocks, backbone_widths)
        self.fpn = FPN(self.backbone.out_channels, policy=policy)
        self.rpn = RPNHead(policy=policy)
        self.fc1 = Dense(7 * 7 * 256, 1024, policy, "fc1")
        self.fc2 = Dense(1024, 1024, policy, "fc2")
        self.cls_score = Dense(1024, num_classes + 1, policy, "cls_score")
        self.bbox_pred = Dense(1024, num_classes * 4, policy, "bbox_pred")
        self._anchors: Dict[tuple, Tuple[List[torch.Tensor], torch.Tensor]] = {}

    def anchors(self, pyramid: List[torch.Tensor]) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """Per-level anchors for these map sizes and their concatenation,
        made once per size."""
        key = (pyramid[0].device,) + tuple(tuple(p.shape[2:]) for p in pyramid)
        if key not in self._anchors:
            levels = [torch.from_numpy(_level_anchors(p.shape[2], p.shape[3], s, sc)).to(p.device)
                      for p, s, sc in zip(pyramid, FPN_STRIDES, ANCHOR_SCALES)]
            self._anchors[key] = (levels, torch.cat(levels, dim=0))
        return self._anchors[key]

    def _proposals(self, objs, deltas, anchors, image_hw, post_nms):
        """(B, post_nms, 4) proposals and their validity
        (``faster_rcnn.py:204``)."""
        cfg = self.config
        h, w = image_hw
        cand_boxes, cand_scores = [], []
        for obj, delta, anc in zip(objs, deltas, anchors):
            b, n = obj.shape
            top, idx = _top_k(obj.float(), min(cfg.rpn_pre_nms_topk, n))
            sel = delta.gather(1, idx[..., None].expand(*idx.shape, 4))
            cand_boxes.append(clip_boxes(decode_rcnn(sel, anc[idx]), float(h), float(w)))
            cand_scores.append(top)
        boxes = torch.cat(cand_boxes, dim=1)
        _, idx = _top_k(torch.cat(cand_scores, dim=1), min(cfg.rpn_nms_input, boxes.shape[1]))
        boxes = boxes.gather(1, idx[..., None].expand(*idx.shape, 4))
        valid = (boxes[..., 2] - boxes[..., 0] > 1.0) & (boxes[..., 3] - boxes[..., 1] > 1.0)
        keep = _ops(cfg.nms_backend).nms_keep_mask(boxes, valid, cfg.rpn_nms_thresh) > 0.5
        # kept first, each group in rank order
        order = torch.sort((~keep).to(torch.uint8), dim=1, stable=True).indices[:, :post_nms]
        return boxes.gather(1, order[..., None].expand(*order.shape, 4)), keep.gather(1, order)

    def _roi_head(self, pyramid, rois):
        """ROIAlign on P2..P5 (K7; in training the plain packed version),
        then the box head (``faster_rcnn.py:249``)."""
        b, r, _ = rois.shape
        if self.training or self.config.roi_backend == "plain":
            align = multilevel_roi_align_packed
        elif self.config.roi_backend == "auto":
            align = roi_align_cuda.multilevel_roi_align
        else:
            raise ValueError(f"roi_backend {self.config.roi_backend!r} is not 'auto' or 'plain'")
        maps = [p.permute(0, 2, 3, 1).contiguous() for p in pyramid[:4]]  # NHWC
        feats = align(maps, rois, FPN_STRIDES[:4], 7, 2, 2)  # (B, R, 7, 7, C) float32
        x = feats.reshape(b * r, -1).to(self.policy.compute_dtype)  # (py, px, c) order
        x = F.relu(self.fc1(x))
        x = F.relu(self.fc2(x))
        return (self.cls_score(x).reshape(b, r, self.num_classes + 1).float(),
                self.bbox_pred(x).reshape(b, r, self.num_classes, 4).float())

    def forward(self, images: torch.Tensor, gt_boxes: Optional[torch.Tensor] = None,
                gt_ids: Optional[torch.Tensor] = None, *,
                generator: Optional[torch.Generator] = None,
                roi_uniform: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        x = images.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        pyramid = self.fpn(self.backbone(x))
        objs, deltas = self.rpn(pyramid)
        levels, anchors = self.anchors(pyramid)
        cfg = self.config
        # the proposals carry no gradient (JAX's stop_gradient): K5 ranks
        # detached boxes
        proposals, p_valid = self._proposals(
            [o.detach() for o in objs], [d.detach() for d in deltas], levels, images.shape[1:3],
            cfg.rpn_post_nms_train if self.training else cfg.rpn_post_nms_test)
        out = {"anchors": anchors, "rpn_obj": torch.cat([o.float() for o in objs], dim=1),
               "rpn_delta": torch.cat(deltas, dim=1), "proposals": proposals,
               "proposal_valid": p_valid}
        rois = proposals
        if self.training:
            if gt_boxes is None or gt_ids is None:
                raise ValueError("a train-mode forward takes gt_boxes and gt_ids")
            if roi_uniform is None:
                if generator is None:
                    raise ValueError("a train-mode forward takes a generator or roi_uniform")
                roi_uniform = global_uniform(
                    (images.shape[0], 2, proposals.shape[1] + gt_ids.shape[1]), generator,
                    images.device)
            rois, cls_t, box_t, mask = sample_rois(roi_uniform, proposals, p_valid, gt_boxes,
                                                   gt_ids, cfg)
            out.update(rois=rois, roi_cls_target=cls_t, roi_box_target=box_t, roi_mask=mask)
        out["roi_cls_logits"], out["roi_box_deltas"] = self._roi_head(pyramid, rois)
        return out


def frcnn_postprocess(proposals: torch.Tensor, cls_logits: torch.Tensor,
                      box_deltas: torch.Tensor, image_hw, *, iou_thresh: float = 0.5,
                      valid_thresh: float = 0.05, topk: int = 400, post_nms: int = 100,
                      backend: str = "auto") -> Detections:
    """(B, R, 4) proposals + head outputs -> padded (ids, scores, boxes)
    (``faster_rcnn.py:504``): softmax, per-class decode and clip, the exact
    top-k of the R*C probabilities (K2 and a stable sort), then class-aware
    NMS (K5, K6).  ``backend`` as ``ops/nms.py``'s."""
    ops = _ops(backend)
    b, r = box_deltas.shape[:2]
    probs = torch.softmax(cls_logits, dim=-1)[..., 1:]  # (B, R, C)
    boxes = decode_rcnn(box_deltas, proposals[:, :, None, :], HEAD_DELTA_WEIGHTS)
    boxes = clip_boxes(boxes, float(image_hw[0]), float(image_hw[1]))
    c = probs.shape[-1]
    top, idx = _pair_top_k_det(probs.reshape(b, r * c), min(topk, r * c), ops.topk_indices)
    cand_boxes = boxes.reshape(b, r * c, 4).gather(1, idx[..., None].expand(*idx.shape, 4))
    valid = top > valid_thresh
    return _nms_on_candidates(cand_boxes, top, (idx % c).float(), valid, iou_thresh, post_nms,
                              ops)


def frcnn_forward_and_postprocess(model: FasterRCNN, images: torch.Tensor,
                                  **nms_kw) -> Detections:
    """One inference step: NHWC images -> (ids, scores, boxes).  On a CUDA
    device under the default backends it launches K5 twice (proposal NMS
    at K = 1000, detection NMS at K = 400), K7, K2 and K6 once each."""
    out = model(images)
    return frcnn_postprocess(out["proposals"], out["roi_cls_logits"], out["roi_box_deltas"],
                             images.shape[1:3], **nms_kw)
