"""Shared pieces of the training tests: tiny YOLOv3 in both packages on the
same seeded weights, the batches, and leaf-by-leaf comparisons.

The port's seeded weights (``weights.seeded_flat``) are loaded into both
models, so both start from one ``.npz``-schema dict.  Both run float32.
"""

import functools

import jax
import numpy as np
import torch

from viddet_tpu.core.precision import FLOAT32_POLICY
from viddet_tpu.models.yolo3 import YOLOv3 as JaxYOLOv3
from viddet_tpu.train.loop import make_train_step as jax_make_train_step
from viddet_tpu.train.state import TrainState as JaxTrainState
from viddet_tpu.train.state import _flatten, _unflatten
from viddet_tpu.train.state import make_lr_schedule as jax_schedule
from viddet_tpu.train.state import make_optimizer as jax_optimizer
from viddet_tpu_torch.core.precision import FLOAT32_POLICY as TORCH_F32
from viddet_tpu_torch.models.yolo3 import YOLOv3
from viddet_tpu_torch.train import loop, state
from viddet_tpu_torch.weights import load_flat, seeded_flat

ANCHORS = (((40, 40), (24, 48), (48, 24)), ((10, 10), (16, 8), (8, 16)))
STRIDES = (32, 16)
LOSS_NAMES = ("obj", "center", "scale", "cls", "total")


def port_model(num_classes=3, seed=0, policy=TORCH_F32, device="cpu", anchors=ANCHORS,
               strides=STRIDES):
    model = YOLOv3(num_classes=num_classes, backbone="tiny", anchors=anchors, strides=strides,
                   policy=policy)
    model = model.to(device=device, memory_format=torch.channels_last)
    load_flat(model, seeded_flat(model, seed))
    return model.train()


def flat_of_jax(params, batch_stats) -> dict:
    flat = _flatten({"params": jax.device_get(params)})
    flat.update(_flatten({"batch_stats": jax.device_get(batch_stats)}))
    return flat


@functools.lru_cache(maxsize=None)
def jax_step(num_classes=3, label_smooth=False, anchors=ANCHORS, strides=STRIDES):
    """The JAX module and one jitted train step per configuration (a CPU
    compile takes ~10 s)."""
    module = JaxYOLOv3(num_classes=num_classes, backbone="tiny", policy=FLOAT32_POLICY,
                       anchors=anchors, strides=strides)
    step = jax_make_train_step(module, strides=strides, anchors=anchors,
                               num_classes=num_classes, label_smooth=label_smooth)
    return module, step


def jax_state(flat: dict, lr=1e-3, weight_decay=5e-4, momentum=0.9):
    tree = _unflatten({k: np.array(v) for k, v in flat.items()})
    tx = jax_optimizer(jax_schedule(lr, 1), momentum=momentum, weight_decay=weight_decay)
    return JaxTrainState.create(params=tree["params"], batch_stats=tree["batch_stats"], tx=tx)


def port_state(model, lr=1e-3, weight_decay=5e-4, momentum=0.9):
    tx = state.make_optimizer(state.make_lr_schedule(lr, 1), momentum=momentum,
                              weight_decay=weight_decay)
    return state.TrainState(model, tx)


def port_step(num_classes=3, label_smooth=False, anchors=ANCHORS, strides=STRIDES):
    return loop.make_train_step(strides=strides, anchors=anchors, num_classes=num_classes,
                                label_smooth=label_smooth)


def make_batch(rng, size=64, batch=2, max_gt=4, collide=False):
    """``tests/integration/test_train_step.py``'s batch: float images in
    [0, 1), two boxes an image; ``collide`` adds a third box of the first's
    size one pixel off, which lands on the first's anchor slot."""
    images = rng.uniform(0, 1, size=(batch, size, size, 3)).astype(np.float32)
    gt_boxes = -np.ones((batch, max_gt, 4), np.float32)
    gt_ids = -np.ones((batch, max_gt), np.int32)
    gt_boxes[:, 0] = [10, 12, 44, 50]
    gt_ids[:, 0] = 1
    gt_boxes[:, 1] = [40, 8, 56, 20]
    gt_ids[:, 1] = 2
    if collide:
        gt_boxes[:, 2] = [11, 12, 45, 50]
        gt_ids[:, 2] = 0
    return images, gt_boxes, gt_ids


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def leaf_gaps(got: dict, want: dict) -> dict:
    """Relative L2 distance of every leaf of two flat dicts (same keys)."""
    assert set(got) == set(want)
    return {k: rel_l2(got[k], want[k]) for k in want}
