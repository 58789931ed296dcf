"""YOLOv3 training loss with the dynamic ignore mask (counterpart of
``viddet_tpu/train/losses.py:31-105``).

* objectness: sigmoid BCE; positives are matched anchors (target = the
  mixup weight); anchors whose predicted box overlaps a ground-truth box
  above ``ignore_thresh`` (0.7) but are not positives are ignored;
* center: sigmoid BCE against the sub-cell offsets, weighted by the box
  weight ``2 - w*h/area``, positives only;
* scale: L1 on the raw log-scale outputs, same weighting;
* class: sigmoid BCE on the one-hot targets (optionally label-smoothed),
  positives only.

Each term is a sum per image, then the mean over the batch.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from viddet_tpu_torch.ops.boxes import box_iou
from viddet_tpu_torch.train.targets import assign_targets


def sigmoid_bce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Numerically stable elementwise sigmoid binary cross-entropy."""
    return logits.clamp_min(0.0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def yolo_loss(
    outputs: Dict[str, torch.Tensor],
    gt_boxes: torch.Tensor,
    gt_ids: torch.Tensor,
    gt_weights: Optional[torch.Tensor],
    *,
    image_size: Tuple[int, int],
    strides,
    anchors,
    num_classes: int,
    ignore_thresh: float = 0.7,
    label_smooth: bool = False,
) -> Dict[str, torch.Tensor]:
    """The four YOLOv3 loss terms and their total (0-d float32 tensors).

    ``outputs`` is ``models.yolo3.flatten_outputs`` of a train-mode
    forward; the ground truth is padded (B, M, 4) / (B, M).
    """
    t = assign_targets(gt_boxes, gt_ids, gt_weights, image_size=image_size,
                       strides=tuple(strides),
                       anchors=tuple(tuple(tuple(a) for a in s) for s in anchors),
                       num_classes=num_classes)

    # the ignore mask from the predicted boxes, with no gradient through it
    with torch.no_grad():
        iou = box_iou(outputs["boxes"].detach(), gt_boxes.float())  # (B, N, M)
        best_iou = torch.where((gt_ids >= 0)[:, None, :], iou, 0.0).amax(dim=-1, keepdim=True)
        del iou
        ignore = (best_iou > ignore_thresh).float()  # (B, N, 1)
        pos = (t["objectness"] > 0).float()  # (B, N, 1)
        obj_mask = torch.maximum(pos, 1.0 - ignore)  # gradient everywhere but ignored

    b = gt_boxes.shape[0]

    def reduce(x: torch.Tensor) -> torch.Tensor:
        return x.reshape(b, -1).sum(dim=1).mean()

    raw_obj = outputs["raw_obj"].float()
    raw_cls = outputs["raw_cls"].float()
    obj_loss = reduce(sigmoid_bce(raw_obj, t["objectness"]) * obj_mask)
    center_loss = reduce(sigmoid_bce(outputs["raw_xy"], t["center"]) * t["weight"] * pos)
    scale_loss = reduce((outputs["raw_wh"] - t["scale"]).abs() * t["weight"] * pos)

    cls_t = t["class_onehot"]
    if label_smooth:
        smooth = min(1.0 / num_classes, 1.0 / 40.0)
        cls_t = torch.where(cls_t > 0.5, cls_t - smooth, smooth)
    cls_loss = reduce(sigmoid_bce(raw_cls, cls_t) * t["class_mask"] * pos)

    return {
        "obj": obj_loss,
        "center": center_loss,
        "scale": scale_loss,
        "cls": cls_loss,
        "total": obj_loss + center_loss + scale_loss + cls_loss,
    }
