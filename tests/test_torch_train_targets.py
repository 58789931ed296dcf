"""The port's in-step target assignment and YOLOv3 loss against the JAX
package's, on the same numpy-seeded inputs.

``assign_targets`` must equal JAX's bit for bit, colliding boxes included
(two boxes on one anchor slot: the later one wins, as XLA's scatter on the
CPU); ``log_xla_cpu`` equals XLA's CPU log bit for bit.  ``yolo_loss`` on
identical model outputs agrees within rtol 1e-6 (term by term, and its
gradient with respect to the outputs): the frameworks' sigmoid, exp and
log1p differ by an ulp, and sums run in other orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viddet_tpu.models.yolo3 import ANCHORS_DARKNET53, ANCHORS_TINY, STRIDES_DARKNET53, STRIDES_TINY
from viddet_tpu.train.losses import yolo_loss as jax_yolo_loss
from viddet_tpu.train.targets import assign_targets as jax_assign_targets
from viddet_tpu_torch.train.losses import yolo_loss
from viddet_tpu_torch.train.targets import assign_targets, log_xla_cpu

KW = dict(image_size=(416, 416), strides=STRIDES_DARKNET53, anchors=ANCHORS_DARKNET53,
          num_classes=20)
SMALL = (((40, 40), (24, 48), (48, 24)), ((10, 10), (16, 8), (8, 16)))


def _both(boxes, ids, weights, **kw):
    want = jax_assign_targets(jnp.asarray(boxes), jnp.asarray(ids),
                              None if weights is None else jnp.asarray(weights), **kw)
    got = assign_targets(torch.from_numpy(boxes), torch.from_numpy(ids),
                         None if weights is None else torch.from_numpy(weights), **kw)
    return {k: np.asarray(v) for k, v in want.items()}, {k: v.numpy() for k, v in got.items()}


def random_gt(rng, b, m, size, collide=True, pad=0.3, max_wh=None):
    """Seeded ground truth: boxes of all sizes (some zero-width, some with
    centres outside the image), -1 padding, mixup weights, and (with
    ``collide``) exact duplicates and one-pixel shifts of earlier boxes,
    which land on their anchor slots."""
    max_wh = max_wh or size
    c = rng.uniform(-0.05 * size, 1.05 * size, (b, m, 2))
    wh = rng.uniform(0, max_wh, (b, m, 2)) * rng.uniform(0, 1, (b, m, 1)) ** 2
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    boxes[:, ::7, 2] = boxes[:, ::7, 0]  # zero width
    ids = rng.integers(0, 20, (b, m)).astype(np.int32)
    if collide:
        boxes[:, 1::4] = boxes[:, 0::4][:, : boxes[:, 1::4].shape[1]]
        boxes[:, 2::4] = boxes[:, 0::4][:, : boxes[:, 2::4].shape[1]] + np.float32(1.0)
    padding = rng.uniform(0, 1, (b, m)) < pad
    boxes[padding] = -1.0
    ids[padding] = -1
    weights = rng.uniform(0, 1, (b, m)).astype(np.float32)
    return boxes, ids, weights


@pytest.mark.parametrize("case", [
    ("darknet53", 416, 12), ("darknet53", 320, 40), ("darknet53", 608, 100),
    ("tiny", 416, 30), ("small", 64, 8),
])
def test_assign_targets_bit_exact(case):
    name, size, m = case
    anchors, strides = {"darknet53": (ANCHORS_DARKNET53, STRIDES_DARKNET53),
                        "tiny": (ANCHORS_TINY, STRIDES_TINY),
                        "small": (SMALL, (32, 16))}[name]
    rng = np.random.default_rng(size + m)
    boxes, ids, weights = random_gt(rng, 4, m, size)
    for w in (None, weights):
        want, got = _both(boxes, ids, w, image_size=(size, size), strides=strides,
                          anchors=anchors, num_classes=20)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        # the collisions happened: fewer positives than valid boxes
        assert want["class_mask"].sum() < (ids >= 0).sum()


def test_collision_last_box_wins():
    boxes = np.array([[[188, 188, 228, 228], [189, 189, 229, 229], [10, 10, 50, 50],
                       [-1, -1, -1, -1]]], np.float32)
    ids = np.array([[3, 7, 1, -1]], np.int32)
    want, got = _both(boxes, ids, None, **KW)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    pos = np.nonzero(got["class_mask"][0, :, 0])[0]
    assert len(pos) == 2
    assert {int(np.argmax(got["class_onehot"][0, p])) for p in pos} == {7, 1}


def test_log_xla_cpu_matches_jax():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.uniform(1e-6, 2.0, 400_000), rng.uniform(0.5, 60.0, 400_000),
        np.exp(rng.uniform(-30, 30, 200_000)),
        [1e-6, 1.0, 2.0, 0.5, np.float32(0.70710677), np.finfo(np.float32).tiny, 3e38],
    ]).astype(np.float32)
    want = np.asarray(jax.jit(jnp.log)(x))
    got = log_xla_cpu(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


# --------------------------------------------- tests/unit/test_targets.py


def test_single_box_assignment():
    cx, cy, w, h = 208.0, 208.0, 116.0, 90.0
    gt_boxes = torch.tensor([[[cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2]]])
    t = assign_targets(gt_boxes, torch.tensor([[3]]), None, **KW)
    flat = (6 * 13 + 6) * 3 + 0
    obj = t["objectness"][0, :, 0].numpy()
    assert obj[flat] == 1.0 and obj.sum() == 1.0
    np.testing.assert_allclose(t["center"][0, flat].numpy(), [208 / 32 - 6] * 2, atol=1e-5)
    np.testing.assert_allclose(t["scale"][0, flat].numpy(), [0.0, 0.0], atol=1e-4)
    np.testing.assert_allclose(t["weight"][0, flat].numpy(), [2 - 116 * 90 / 416**2] * 2,
                               atol=1e-5)
    cls = t["class_onehot"][0, flat].numpy()
    assert cls[3] == 1.0 and cls.sum() == 1.0


def test_small_box_goes_to_fine_scale():
    cx, cy, w, h = 100.0, 60.0, 10.0, 13.0
    gt_boxes = torch.tensor([[[cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2]]])
    t = assign_targets(gt_boxes, torch.tensor([[0]]), None, **KW)
    n32, n16 = 13 * 13 * 3, 26 * 26 * 3
    flat = n32 + n16 + (int(60 // 8) * 52 + int(100 // 8)) * 3 + 0
    obj = t["objectness"][0, :, 0].numpy()
    assert obj[flat] == 1.0 and obj.sum() == 1.0


def test_padding_boxes_produce_no_targets():
    t = assign_targets(-torch.ones((2, 5, 4)), -torch.ones((2, 5), dtype=torch.int32), None, **KW)
    for key in ("objectness", "weight", "class_mask"):
        assert float(t[key].sum()) == 0.0


def test_mixup_weight_propagates():
    cx, cy, w, h = 208.0, 208.0, 116.0, 90.0
    gt_boxes = torch.tensor([[[cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2]]])
    t = assign_targets(gt_boxes, torch.tensor([[3]]), torch.tensor([[0.6]]), **KW)
    assert abs(float(t["objectness"].max()) - 0.6) < 1e-6


# -------------------------------------------------------------------- loss


def random_outputs(rng, b, size, anchors, strides, num_classes):
    """Head outputs as the model's flat dict: raw fields and decoded boxes
    (the decode of ``viddet_tpu/models/yolo3.py:203-207``)."""
    grids, anch, strd = [], [], []
    for a, s in zip(anchors, strides):
        g = size // s
        gy, gx, _ = np.meshgrid(np.arange(g), np.arange(g), np.arange(len(a)), indexing="ij")
        grids.append(np.stack([gx, gy], -1).reshape(-1, 2))
        anch.append(np.broadcast_to(np.asarray(a, np.float32), (g, g, len(a), 2)).reshape(-1, 2))
        strd.append(np.full((g * g * len(a), 1), s, np.float32))
    grid, anch, strd = (np.concatenate(v).astype(np.float32) for v in (grids, anch, strd))
    n = grid.shape[0]
    raw_xy = rng.normal(0, 1.5, (b, n, 2)).astype(np.float32)
    raw_wh = rng.normal(0, 0.7, (b, n, 2)).astype(np.float32)
    center = (1 / (1 + np.exp(-raw_xy)) + grid) * strd
    half = 0.5 * np.exp(raw_wh) * anch
    return {"raw_xy": raw_xy, "raw_wh": raw_wh,
            "raw_obj": rng.normal(0, 3, (b, n, 1)).astype(np.float32),
            "raw_cls": rng.normal(0, 3, (b, n, num_classes)).astype(np.float32),
            "boxes": np.concatenate([center - half, center + half], -1).astype(np.float32)}


@pytest.mark.parametrize("label_smooth", [False, True])
@pytest.mark.parametrize("mixup", [False, True])
def test_yolo_loss_matches_jax(label_smooth, mixup):
    rng = np.random.default_rng(3 + 2 * mixup + label_smooth)
    size, num_classes = 320, 20
    out = random_outputs(rng, 3, size, ANCHORS_DARKNET53, STRIDES_DARKNET53, num_classes)
    boxes, ids, weights = random_gt(rng, 3, 24, size, max_wh=200)
    # boxes near predictions, so the ignore mask has members
    boxes[:, :4] = out["boxes"][:, 500:504] + rng.normal(0, 2, (3, 4, 4)).astype(np.float32)
    ids[:, :4] = 2
    w = weights if mixup else None
    kw = dict(image_size=(size, size), strides=STRIDES_DARKNET53, anchors=ANCHORS_DARKNET53,
              num_classes=num_classes, label_smooth=label_smooth)

    def jax_total(o):
        losses = jax_yolo_loss(o, jnp.asarray(boxes), jnp.asarray(ids),
                               None if w is None else jnp.asarray(w), **kw)
        return losses["total"], losses

    (_, want), jgrad = jax.value_and_grad(jax_total, has_aux=True)(
        {k: jnp.asarray(v) for k, v in out.items()})
    tout = {k: torch.tensor(v, requires_grad=k != "boxes") for k, v in out.items()}
    got = yolo_loss(tout, torch.from_numpy(boxes), torch.from_numpy(ids),
                    None if w is None else torch.from_numpy(w), **kw)
    got["total"].backward()
    for key in want:
        np.testing.assert_allclose(float(got[key].detach()), float(want[key]), rtol=1e-6,
                                   err_msg=key)
    for key in ("raw_xy", "raw_wh", "raw_obj", "raw_cls"):
        np.testing.assert_allclose(tout[key].grad.numpy(), np.asarray(jgrad[key]), rtol=1e-6,
                                   atol=1e-7, err_msg=key)
    assert float(want["obj"]) > 0 and float(want["scale"]) > 0
