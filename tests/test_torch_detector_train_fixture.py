"""The JAX fixtures of SSD and Faster R-CNN training, and the port held to
them.

The card machine has no Flax, so ``chip_smoke.py`` holds the port's steps
to ``tests/fixtures/jax_ssd_train_steps.npz`` and
``jax_frcnn_train_steps.npz``: the shallow models of the JAX unit tests
(one bottleneck a stage, widths 8..64; SSD at 64 px, Faster R-CNN at 128
px with ``TINY_CFG``'s counts), 3 classes, ``weights.seeded_flat(model,
0)`` in both packages, one batch of two images of 8x8-pixel blocks whose
third box shares the first's best anchor, three steps of SGD (lr 1e-3,
momentum 0.9, weight decay 5e-4) keyed from ``key(5)``.  Each holds:

* the batch and the targets: SSD's class and box targets; Faster R-CNN's
  step-1 proposals with JAX's roi sampling of them, its RPN labels and the
  positives' box targets;
* JAX's draws of each step (uniforms as integers k of k / 2**23);
* the losses of each step in float32, and in float64 compute (the
  models' own float32 casts kept, the same float32 draws);
* after the float64 step 3, up to 64 evenly spaced elements of every
  parameter and statistic (``chip_smoke.leaf_sample_index``).

Written on the CPU by

    JAX_PLATFORMS=cpu python -m tests.test_torch_detector_train_fixture

and held to a live JAX run here.  The card's limits are the train
phase's: targets bit for bit, losses 1e-4 relative (float32: SSD's three
steps, Faster R-CNN's first; float64: all), each leaf's sample 1e-3
relative L2 (float64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tests.torch_detector_helpers import (  # noqa: F401 (one_torch_thread: a fixture)
    COUNTS,
    NUM_CLASSES,
    SHALLOW,
    fixture_batch,
    jax_runs,
    one_torch_thread,
)
from viddet_tpu.models import ssd as JS

STEPS, LR, WEIGHT_DECAY, MOMENTUM = 3, 1e-3, 5e-4, 0.9


def _codes(u: np.ndarray) -> np.ndarray:
    codes = np.asarray(u, np.float64) * chip_smoke.UNIFORM_SCALE
    assert (codes == np.round(codes)).all()
    return codes.astype(np.uint32)


def jax_fixture(family: str) -> dict:
    batch = fixture_batch(family)
    runs = {p: jax_runs(family, batch, STEPS, f64=p == "f64", lr=LR, weight_decay=WEIGHT_DECAY,
                        momentum=MOMENTUM) for p in ("f32", "f64")}
    names = chip_smoke.DETECTOR_LOSS_NAMES[family]
    fx = {"images": batch[0], "gt_boxes": batch[1], "gt_ids": batch[2],
          "num_classes": np.int32(NUM_CLASSES),
          "backbone_blocks": np.asarray(SHALLOW["backbone_blocks"], np.int32),
          "backbone_widths": np.asarray(SHALLOW["backbone_widths"], np.int32),
          "lr": np.float32(LR), "weight_decay": np.float32(WEIGHT_DECAY),
          "momentum": np.float32(MOMENTUM), "steps": np.int32(STEPS)}
    for p, run in runs.items():
        fx[f"losses_{p}"] = np.asarray([[r[k] for k in names] for r in run["losses"]], np.float32)
    if family == "ssd":
        anchors = JS.generate_ssd_anchors(batch[0].shape[1])
        cls_t, box_t = jax.jit(lambda b, i: JS.assign_ssd_targets(jnp.asarray(anchors), b, i))(
            jnp.asarray(batch[1]), jnp.asarray(batch[2]))
        fx["targets/cls"], fx["targets/box"] = np.asarray(cls_t), np.asarray(box_t)
    else:
        fx["count_names"] = np.asarray(sorted(COUNTS))
        fx["counts"] = np.asarray([COUNTS[k] for k in sorted(COUNTS)], np.int32)
        recs = runs["f32"]["records"]
        for k in ("roi", "rpn"):
            fx[f"{k}_uniform"] = np.stack([_codes(r[k][0]) for r in recs])
            # the float64 run sampled on the same draws
            assert all(np.array_equal(a[k][0], b[k][0])
                       for a, b in zip(recs, runs["f64"]["records"]))
        roi_u, props, p_valid, rois, cls_t, box_t, mask = recs[0]["roi"]
        fx.update({"proposals": props, "proposal_valid": p_valid, "targets/rois": rois,
                   "targets/roi_cls": cls_t, "targets/roi_box": box_t, "targets/roi_mask": mask})
        labels, rpn_box = recs[0]["rpn"][1:]
        fx["targets/rpn_labels"] = labels.astype(np.int32)
        fx["targets/rpn_box_at_positives"] = rpn_box[labels == 1]
    for key, value in sorted(runs["f64"]["flat"].items()):
        v = np.asarray(value, np.float64).reshape(-1)
        fx[f"leaf_sample/{key}"] = v[chip_smoke.leaf_sample_index(v.size)].astype(np.float32)
    return fx


@pytest.mark.parametrize("family", ["ssd", "frcnn"])
def test_fixture_is_small_and_collides(family):
    with np.load(chip_smoke.DETECTOR_FIXTURES[family]) as fx:
        assert (fx["gt_ids"] >= 0).sum(1).tolist() == [3, 3]
        if family == "ssd":  # the colliding box takes the shared anchor: 3 boxes, fewer matches
            assert (fx["targets/cls"] > 0).any(1).all()
        else:
            assert (fx["targets/rpn_labels"] == 1).any(1).all()
            assert (fx["targets/roi_cls"] > 0).any(1).all()
    assert chip_smoke.DETECTOR_FIXTURES[family] and \
        __import__("os").path.getsize(chip_smoke.DETECTOR_FIXTURES[family]) < 300_000


@pytest.mark.parametrize("family", ["ssd", "frcnn"])
def test_fixture_equals_live_jax(family):
    live = jax_fixture(family)
    with np.load(chip_smoke.DETECTOR_FIXTURES[family]) as f:
        stored = {k: f[k] for k in f.files}
    assert set(live) == set(stored)
    for key, want in stored.items():
        if key.startswith("leaf_sample/") or key.startswith("losses_"):
            np.testing.assert_allclose(live[key], want, rtol=1e-6, atol=1e-12, err_msg=key)
        else:
            np.testing.assert_array_equal(live[key], want, err_msg=key)


@pytest.mark.parametrize("family", ["ssd", "frcnn"])
def test_port_on_cpu_matches_fixture(family):
    """The port on the CPU at the card's limits (the card's own test is
    ``tests/test_torch_cuda_parity.py`` ``test_detector_train_steps_match_jax_fixture``)."""
    report = chip_smoke.detector_fixture_run(torch.device("cpu"), family)
    chip_smoke.check_detector_fixture(report, family)
    assert report["loss_max_rel_f32_step1"] <= 1e-4 and report["loss_max_rel_f64"] <= 1e-5, report
    assert report["leaf_max_rel_l2_f64"] <= (5e-5 if family == "frcnn" else 1e-3), report


if __name__ == "__main__":
    for family, path in chip_smoke.DETECTOR_FIXTURES.items():
        np.savez_compressed(path, **jax_fixture(family))
        print(f"wrote {path} ({__import__('os').path.getsize(path)} bytes)")
