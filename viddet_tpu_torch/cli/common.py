"""Predictor and weight loading shared by the port's entry points
(counterpart of ``viddet_tpu/cli/common.py:249-298``)."""

from __future__ import annotations

import numpy as np
import torch

from viddet_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from viddet_tpu_torch.models.yolo3 import NMSConfig, YOLOv3, forward_and_postprocess
from viddet_tpu_torch.weights import load_flat


def make_predictor(model: YOLOv3, nms: NMSConfig = NMSConfig()):
    """``infer(images) -> (ids, scores, boxes)`` for NHWC images on the
    model's device.

    uint8 frames are ImageNet-normalized on the device, with the
    expression of ``viddet_tpu/train/loop.py:37`` ``_maybe_normalize``
    (a quarter of the host->device bytes of float frames); float batches
    pass through untouched.
    """
    device = next(model.parameters()).device
    mean = torch.as_tensor(IMAGENET_MEAN, device=device)
    std = torch.as_tensor(IMAGENET_STD, device=device)

    @torch.inference_mode()
    def infer(images: torch.Tensor):
        if images.dtype == torch.uint8:
            images = (images.float() / 255.0 - mean) / std
        return forward_and_postprocess(model, images, nms)

    return infer


def load_weights(model: YOLOv3, weights_path: str) -> YOLOv3:
    """Load a JAX-package ``.npz`` weights file (``train/state.py`` schema)
    into the model, in place; an empty path leaves it as it is."""
    if weights_path:
        with np.load(weights_path) as data:
            load_flat(model, {k: data[k] for k in data.files})
    return model
