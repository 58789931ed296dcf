"""The JAX training fixture and the port held to it.

The card machine has no Flax, so ``chip_smoke.py`` and the card test hold
the port's float32 train step to ``tests/fixtures/jax_train_steps.npz``:
tiny YOLOv3 (3 classes, 64 px, the anchors of
``tests/integration/test_train_step.py``), ``weights.seeded_flat(model,
0)`` in both packages, one seeded batch of two images whose third box
lands on the first's anchor slot, three steps of SGD (lr 1e-3, momentum
0.9, weight decay 5e-4).  It records the batch, the targets of the batch,
the five losses of each step and, after step 3, a seeded sample of up to
256 elements of every parameter and statistic with the leaf's norm.
Written on the CPU by

    JAX_PLATFORMS=cpu python -m tests.test_torch_train_fixture

and held to a live JAX run here in tier 1.  The card's test is
``tests/test_torch_cuda_parity.py`` ``test_train_step_matches_jax_fixture``
(that file imports no Flax, which the card machine lacks).  The limits on
the card
(``chip_smoke.TRAIN_LOSS_RTOL``, ``TRAIN_LEAF_REL_L2``) are relative 1e-4
for the losses and a relative L2 distance of 1e-3 for each leaf's sample;
the targets must be equal bit for bit.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch

import chip_smoke
from tests.torch_train_helpers import (
    ANCHORS,
    LOSS_NAMES,
    STRIDES,
    flat_of_jax,
    jax_state,
    jax_step,
    make_batch,
    port_model,
)
from viddet_tpu.train.targets import assign_targets as jax_assign_targets
from viddet_tpu_torch.weights import seeded_flat

FIXTURE = Path(chip_smoke.TRAIN_FIXTURE)
BATCH_SEED, SAMPLE_SEED, SAMPLES, STEPS = 11, 12, 256, 3
LR, WEIGHT_DECAY, MOMENTUM, NUM_CLASSES, SIZE = 1e-3, 5e-4, 0.9, 3, 64


def jax_fixture() -> dict:
    images, gt_boxes, gt_ids = make_batch(np.random.default_rng(BATCH_SEED), size=SIZE,
                                          collide=True)
    flat = seeded_flat(port_model(NUM_CLASSES), 0)
    _, step = jax_step(NUM_CLASSES)
    state = jax_state(flat, LR, WEIGHT_DECAY, MOMENTUM)
    targets = jax_assign_targets(jnp.asarray(gt_boxes), jnp.asarray(gt_ids), None,
                                 image_size=(SIZE, SIZE), strides=STRIDES, anchors=ANCHORS,
                                 num_classes=NUM_CLASSES)
    losses = []
    for _ in range(STEPS):
        state, out = step(state, jnp.asarray(images), jnp.asarray(gt_boxes), jnp.asarray(gt_ids))
        losses.append([float(out[k]) for k in LOSS_NAMES])
    fx = {
        "images": images, "gt_boxes": gt_boxes, "gt_ids": gt_ids,
        "anchors": np.asarray(ANCHORS, np.float32), "strides": np.asarray(STRIDES, np.int32),
        "num_classes": np.int32(NUM_CLASSES), "weights_seed": np.int32(0),
        "lr": np.float32(LR), "weight_decay": np.float32(WEIGHT_DECAY),
        "momentum": np.float32(MOMENTUM), "steps": np.int32(STEPS),
        "losses": np.asarray(losses, np.float32),
    }
    fx.update({f"targets/{k}": np.asarray(v) for k, v in targets.items()})
    rng = np.random.default_rng(SAMPLE_SEED)
    for key, value in sorted(flat_of_jax(state.params, state.batch_stats).items()):
        v = np.asarray(value, np.float32).reshape(-1)
        idx = np.sort(rng.choice(v.size, min(SAMPLES, v.size), replace=False)).astype(np.int32)
        fx[f"leaf_index/{key}"] = idx
        fx[f"leaf_sample/{key}"] = v[idx]
        fx[f"leaf_norm/{key}"] = np.float32(np.linalg.norm(v))
    return fx


def test_fixture_batch_collides():
    """Two valid boxes of an image share an anchor slot, so the fixture
    holds the collision rule: the targets have fewer positives than boxes."""
    with np.load(FIXTURE) as fx:
        positives = fx["targets/class_mask"].sum(axis=(1, 2))
        boxes = (fx["gt_ids"] >= 0).sum(axis=1)
        assert (positives < boxes).all(), (positives, boxes)
        assert FIXTURE.stat().st_size < 1 << 20


def test_fixture_equals_live_jax():
    live = jax_fixture()
    with np.load(FIXTURE) as f:
        stored = {k: f[k] for k in f.files}
    assert set(live) == set(stored)
    for key, want in stored.items():
        if key.startswith(("leaf_sample/", "leaf_norm/")) or key == "losses":
            np.testing.assert_allclose(live[key], want, rtol=1e-6, err_msg=key)
        else:
            np.testing.assert_array_equal(live[key], want, err_msg=key)


def test_port_on_cpu_matches_fixture():
    """The port on the CPU: targets equal, losses of step 1 within 1e-5
    relative, the rest and the leaves within the card's limits (the card's
    own test is ``tests/test_torch_cuda_parity.py``
    ``test_train_step_matches_jax_fixture``)."""
    report = chip_smoke.train_fixture_run(torch.device("cpu"))
    assert all(report["targets_equal"].values()), report["targets_equal"]
    assert report["loss_max_rel_step1"] <= 1e-5, report
    assert report["loss_max_rel"] <= chip_smoke.TRAIN_LOSS_RTOL, report
    assert report["leaf_max_rel_l2"] <= chip_smoke.TRAIN_LEAF_REL_L2, report


if __name__ == "__main__":
    FIXTURE.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(FIXTURE, **jax_fixture())
    print(f"wrote {FIXTURE} ({FIXTURE.stat().st_size} bytes)")
