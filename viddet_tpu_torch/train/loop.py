"""The train steps (counterpart of ``viddet_tpu/train/loop.py:37-174``).

``train_step(state, images, gt_boxes, gt_ids, gt_weights=None)`` runs on
the model's device: uint8 images are normalized there, the model runs in
train mode (BatchNorm on batch statistics, updating its running ones),
the targets are assigned in the step (``train/targets.py``), then the
loss, the backward pass and the optimizer update.  It returns the state
(updated in place) and the losses as 0-d device tensors; nothing in it
waits for the device.  Multi-scale batches of any size reuse it.

The reference's eval step (``:177``) is ``cli.common.make_predictor``:
BatchNorm on running statistics needs the model in eval mode
(``model.eval()``, then ``model.train()`` to go on training).

``make_ssd_train_step`` and ``make_frcnn_train_step`` are the SSD and
Faster R-CNN steps (``:115-174``), with the same structure.  The Faster
R-CNN step takes a ``torch.Generator`` on the model's device where JAX's
takes a key: the roi sampling draws from it first, then the RPN's
sampling, on the device (no host round trip).  Its stream is not
``jax.random``'s, so only the selection given the same uniforms equals
JAX's.  On the card the Faster R-CNN step launches K5 once (proposal NMS
at K = ``rpn_nms_input``); the SSD step launches no kernel.

Under a process group (``parallel/mesh.py``) every step is the global
batch's: BatchNorm on its statistics, the gradients averaged over the
processes and the losses returned averaged too, and Faster R-CNN's
draws and denominators those of the global batch.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch

from viddet_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from viddet_tpu_torch.models.faster_rcnn import frcnn_loss
from viddet_tpu_torch.models.ssd import ssd_loss
from viddet_tpu_torch.models.yolo3 import flatten_outputs
from viddet_tpu_torch.parallel import mesh
from viddet_tpu_torch.parallel.mesh import global_uniform
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
        return _backward_and_update(state, losses)

    return train_step


def _backward_and_update(state: TrainState, losses: Dict[str, torch.Tensor]
                         ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """Backward and the update; the losses returned are the global batch's:
    under several processes each process's losses are averaged over them
    (each is its local batch's mean, or for Faster R-CNN its share of the
    global sums), the mean that the gradient average differentiates."""
    state.zero_grad()
    losses["total"].backward()
    state.apply_gradients()
    out = {k: v.detach() for k, v in losses.items()}
    if mesh.process_count() > 1:
        dtype = functools.reduce(torch.promote_types, (v.dtype for v in out.values()))
        values = torch.stack([v.to(dtype) for v in out.values()])
        mesh.all_reduce_([values], mean=True)
        out = {k: m.to(v.dtype) for (k, v), m in zip(out.items(), values.unbind())}
    return state, out


def _check_model(state: TrainState, model: torch.nn.Module) -> torch.nn.Module:
    if state.model is not model:
        raise ValueError("the state trains another model than the step's")
    return model.train()


def make_ssd_train_step(model: torch.nn.Module):
    """Returns ``train_step(state, images, gt_boxes, gt_ids) -> (state,
    losses)`` for an SSD: normalize, train-mode forward, ``ssd_loss``
    (targets and hard-negative mining in the step), backward, SGD."""

    def train_step(state: TrainState, images: torch.Tensor, gt_boxes: torch.Tensor,
                   gt_ids: torch.Tensor) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        out = _check_model(state, model)(_maybe_normalize(images))
        return _backward_and_update(state, ssd_loss(out, gt_boxes, gt_ids))

    return train_step


def make_frcnn_train_step(model: torch.nn.Module):
    """Returns ``train_step(state, generator, images, gt_boxes, gt_ids,
    uniforms=None) -> (state, losses)`` for a Faster R-CNN: normalize,
    train-mode forward (proposals, the roi sampling, the box head),
    ``frcnn_loss`` (the RPN's targets and sampling), backward, SGD.
    ``generator`` is a ``torch.Generator`` on the model's device; it feeds
    both samplers.  ``uniforms`` (roi (B, 2, R + M), RPN (B, 2, N)) replaces
    its draws (the tests pass JAX's)."""
    cfg = model.config

    def train_step(state: TrainState, generator: torch.Generator | None, images: torch.Tensor,
                   gt_boxes: torch.Tensor, gt_ids: torch.Tensor, uniforms=None
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        roi_uniform, rpn_uniform = uniforms or (None, None)
        out = _check_model(state, model)(_maybe_normalize(images), gt_boxes, gt_ids,
                                         generator=generator, roi_uniform=roi_uniform)
        if rpn_uniform is None:
            rpn_uniform = global_uniform((images.shape[0], 2, out["anchors"].shape[0]),
                                         generator, images.device)
        return _backward_and_update(state, frcnn_loss(out, gt_boxes, gt_ids, cfg, rpn_uniform))

    return train_step
