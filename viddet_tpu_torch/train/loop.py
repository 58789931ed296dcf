"""The YOLOv3 train step (counterpart of ``viddet_tpu/train/loop.py:37-112``).

``train_step(state, images, gt_boxes, gt_ids, gt_weights=None)`` runs on
the model's device: uint8 images are normalized there, the model runs in
train mode (BatchNorm on batch statistics, updating its running ones),
the targets are assigned in the step (``train/targets.py``), then the
loss, the backward pass and the optimizer update.  It returns the state
(updated in place) and the losses as 0-d device tensors; nothing in it
waits for the device.  Multi-scale batches of any size reuse it.

The reference's eval step (``:177``) is ``cli.common.make_predictor``:
BatchNorm on running statistics needs the model in eval mode
(``model.eval()``, then ``model.train()`` to go on training).  The SSD
and Faster R-CNN steps are not ported yet.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch

from viddet_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from viddet_tpu_torch.models.yolo3 import flatten_outputs
from viddet_tpu_torch.train.losses import yolo_loss
from viddet_tpu_torch.train.state import TrainState


@functools.lru_cache(maxsize=8)
def _imagenet_stats(device: torch.device):
    """ImageNet mean and std on ``device``, copied there once: a copy inside
    the step would wait for the work queued before it."""
    return (torch.as_tensor(IMAGENET_MEAN, device=device),
            torch.as_tensor(IMAGENET_STD, device=device))


def _maybe_normalize(images: torch.Tensor) -> torch.Tensor:
    """Normalize a uint8 batch on its device (``(x / 255 - mean) / std``,
    as ``cli.common.make_predictor``); float batches pass through."""
    if images.dtype != torch.uint8:
        return images
    mean, std = _imagenet_stats(images.device)
    return (images.float() / 255.0 - mean) / std


def make_train_step(*, strides, anchors, num_classes: int, ignore_thresh: float = 0.7,
                    label_smooth: bool = False):
    """Returns ``train_step(state, images, gt_boxes, gt_ids, gt_weights=None)
    -> (state, losses)``, training ``state.model``.  ``strides`` /
    ``anchors`` are the model head's (deepest first)."""
    anchors = tuple(tuple(tuple(a) for a in s) for s in anchors)

    def train_step(state: TrainState, images: torch.Tensor, gt_boxes: torch.Tensor,
                   gt_ids: torch.Tensor, gt_weights: torch.Tensor | None = None
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        model = state.model.train()
        images = _maybe_normalize(images)
        losses = yolo_loss(flatten_outputs(model(images)), gt_boxes, gt_ids, gt_weights,
                           # images (B, H, W, 3) and clips (B, k, H, W, 3)
                           image_size=(images.shape[-3], images.shape[-2]),
                           strides=strides, anchors=anchors, num_classes=num_classes,
                           ignore_thresh=ignore_thresh, label_smooth=label_smooth)
        state.zero_grad()
        losses["total"].backward()
        state.apply_gradients()
        return state, {k: v.detach() for k, v in losses.items()}

    return train_step
