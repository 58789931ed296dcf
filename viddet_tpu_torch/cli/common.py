"""Predictor and weight loading shared by the port's entry points
(counterpart of ``viddet_tpu/cli/common.py:249-298``)."""

from __future__ import annotations

import numpy as np
import torch

from viddet_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from viddet_tpu_torch.models.faster_rcnn import FasterRCNN, frcnn_forward_and_postprocess
from viddet_tpu_torch.models.ssd import SSD, ssd_forward_and_postprocess
from viddet_tpu_torch.models.yolo3 import NMSConfig, forward_and_postprocess
from viddet_tpu_torch.weights import load_flat


def make_predictor(model: torch.nn.Module, nms: NMSConfig | None = None):
    """``infer(images) -> (ids, scores, boxes)`` on the model's device, for
    a YOLOv3, a temporal YOLOv3, an SSD or a Faster R-CNN (dispatched as
    ``viddet_tpu/cli/common.py:271-276`` does).  Images are NHWC frames, or
    (B, k, H, W, 3) clips for a temporal model.

    ``nms`` None keeps each family's defaults (YOLOv3 and SSD:
    ``NMSConfig()``; Faster R-CNN: ``frcnn_postprocess``'s IoU 0.5, valid
    0.05, topk 400, post_nms 100); an SSD and a Faster R-CNN ignore
    ``nms.ranking``.

    uint8 frames are ImageNet-normalized on the device, with the
    expression of ``viddet_tpu/train/loop.py:37`` ``_maybe_normalize``
    (a quarter of the host->device bytes of float frames), broadcast over
    the leading dimensions; float batches pass through untouched.
    """
    device = next(model.parameters()).device
    mean = torch.as_tensor(IMAGENET_MEAN, device=device)
    std = torch.as_tensor(IMAGENET_STD, device=device)
    if isinstance(model, SSD):
        ssd_nms = nms or NMSConfig()

        def step(images):
            return ssd_forward_and_postprocess(model, images, ssd_nms)
    elif isinstance(model, FasterRCNN):
        kw = {} if nms is None else nms.kwargs()

        def step(images):
            return frcnn_forward_and_postprocess(model, images, **kw)
    else:
        def step(images):
            return forward_and_postprocess(model, images, nms or NMSConfig())

    @torch.inference_mode()
    def infer(images: torch.Tensor):
        if images.dtype == torch.uint8:
            images = (images.float() / 255.0 - mean) / std
        return step(images)

    return infer


def load_weights(model: torch.nn.Module, weights_path: str) -> torch.nn.Module:
    """Load a JAX-package ``.npz`` weights file (``train/state.py`` schema)
    into the model, in place; an empty path leaves it as it is."""
    if weights_path:
        with np.load(weights_path) as data:
            load_flat(model, {k: data[k] for k in data.files})
    return model
