"""SSD training on the CPU against the JAX package, in float32 unless a
test says otherwise: the box encoding, the matching and the hard-negative
mining (``viddet_tpu/models/ssd.py:160-286``), train-mode ``ConvBN``, and
the train step (``viddet_tpu/train/loop.py:115-136``) of the shallow SSD of
``tests/unit/test_ssd.py`` (one bottleneck a stage, widths 8..64, 64 px, 3
classes) from the same seeded weights.

Limits:

* the targets (class targets, matches, box targets) equal JAX's jitted
  ones bit for bit;
* one step: each loss within 1e-5 relative, each gradient leaf within a
  relative L2 distance of 1e-4;
* three steps: each loss within 1e-5; the parameters within PR 13's leaf
  limits (median 1e-5, each leaf 5e-5), in float32 and in float64 compute
  on both sides (the models' own float32 casts kept).  The BatchNorm
  running statistics of the extra layers miss them (ROADMAP Queue 3): at
  64 px their maps are 2x2 and 1x1, so each statistic is over 2 to 8
  values of a batch of 2, and ``_ConvBN_6`` normalizes two values an
  image pair, whose difference is tiny, so the next layer's statistics
  are differences of nearly equal numbers.  Measured on one torch thread:
  in float32 ``_ConvBN_7``'s mean 4.4e-2 (11 of 50 statistic leaves above
  1e-5, their median 7.8e-7), in float64 2.0e-4 (the only leaf above
  1e-5; parameters within 5.3e-8).  ``STATS_REL_L2_AFTER_3``
  and ``STATS_REL_L2_AFTER_3_F64`` hold the statistics there, at twice
  and five times the measured gaps.  ``python -m tests.test_torch_ssd_train``
  prints them.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_detector_helpers import (  # noqa: F401 (one_torch_thread: a fixture)
    NUM_CLASSES,
    SHALLOW,
    SSD_LOSSES,
    SSD_SIZE,
    flat_of_jax,
    fixture_batch,
    jax_runs,
    jax_ssd,
    leaf_gaps,
    _placed,
    loss_gaps,
    make_batch,
    one_torch_thread,
    port_runs,
    port_state,
    ssd_model,
    summary,
)
from viddet_tpu.core.precision import FLOAT32_POLICY
from viddet_tpu.models import ssd as JS
from viddet_tpu.models.resnet import _ConvBN as JaxConvBN
from viddet_tpu.train.state import _unflatten
from viddet_tpu_torch.core.precision import FLOAT32_POLICY as TORCH_F32
from viddet_tpu_torch.models import ssd as TS
from viddet_tpu_torch.models.resnet import ConvBN
from viddet_tpu_torch.train import loop
from viddet_tpu_torch.weights import leaves, load_flat, schema_array, seeded_flat

LOSS_RTOL, GRAD_REL_L2, LEAF_REL_L2_MEDIAN, LEAF_REL_L2 = 1e-5, 1e-4, 1e-5, 5e-5
STATS_REL_L2_AFTER_3, STATS_REL_L2_AFTER_3_F64 = 1e-1, 1e-3  # measured 4.4e-2, 2.0e-4


@functools.lru_cache(maxsize=None)
def _jax_assign():
    """JAX's matching jitted with the anchors as a graph constant, as in its
    train step (XLA then divides by their reciprocals)."""
    anchors = JS.generate_ssd_anchors(SSD_SIZE)
    return anchors, jax.jit(lambda b, i: JS.assign_ssd_targets(jnp.asarray(anchors), b, i))


def _assert_targets_equal(gt_boxes, gt_ids):
    anchors, assign = _jax_assign()
    want = [np.asarray(t) for t in assign(jnp.asarray(gt_boxes), jnp.asarray(gt_ids))]
    got = TS.assign_ssd_targets(torch.from_numpy(anchors), torch.from_numpy(gt_boxes),
                                torch.from_numpy(gt_ids))
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    return got


# ------------------------------------------- tests/unit/test_ssd.py:23-55


def test_encode_matches_jax_and_round_trips():
    anchors = TS.generate_ssd_anchors(128)[:50]
    pts = np.random.default_rng(0).uniform(0, 128, (50, 2, 2)).astype(np.float32)
    gt = np.concatenate([pts.min(1) - 1, pts.max(1) + 1], axis=-1)
    want = jax.jit(lambda g: JS.encode_ssd_boxes(g, jnp.asarray(anchors)))(jnp.asarray(gt))
    got = TS.encode_ssd_boxes(torch.from_numpy(gt), torch.from_numpy(anchors))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = TS.decode_ssd_boxes(got, torch.from_numpy(anchors))
    np.testing.assert_allclose(back.numpy(), gt, rtol=1e-4, atol=1e-2)


def _assign(anchors, gt, ids):
    want = JS.assign_ssd_targets(jnp.asarray(anchors), jnp.asarray(gt), jnp.asarray(ids))
    got = TS.assign_ssd_targets(torch.from_numpy(anchors), torch.from_numpy(gt),
                                torch.from_numpy(ids))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6, atol=1e-6)
    return got


def test_target_assignment_forces_best_anchor():
    anchors = np.asarray([[0, 0, 10, 10], [100, 100, 140, 140], [200, 200, 210, 210]], np.float32)
    cls_t, box_t = _assign(anchors, np.asarray([[[110, 110, 170, 170]]], np.float32),
                           np.asarray([[2]], np.int32))
    assert cls_t[0].tolist() == [0, 3, 0]  # IoU < 0.5, still matched: class 2 -> label 3
    assert box_t[0, 1].abs().sum() > 0 and box_t[0, 0].abs().sum() == 0


def test_target_threshold_match():
    anchors = np.asarray([[0, 0, 100, 100], [500, 500, 600, 600]], np.float32)
    cls_t, _ = _assign(anchors, np.asarray([[[0, 0, 90, 100], [-1, -1, -1, -1]]], np.float32),
                       np.asarray([[0, -1]], np.int32))
    assert cls_t[0].tolist() == [1, 0]  # IoU 0.9 >= 0.5


@pytest.mark.parametrize("collide", [False, True])
def test_targets_equal_jax_bit_for_bit(collide):
    """The shallow model's 64-px anchors against seeded boxes; with
    ``collide`` two valid boxes of an image share their best anchor, where
    XLA's scatter keeps the later box."""
    rng = np.random.default_rng(3)
    gt_boxes = -np.ones((4, 6, 4), np.float32)
    gt_ids = -np.ones((4, 6), np.int32)
    for b, n in enumerate((0, 1, 3, 5)):
        xy = rng.uniform(0, 48, (n, 2))
        wh = rng.uniform(4, 40, (n, 2))
        gt_boxes[b, :n] = np.concatenate([xy, np.minimum(xy + wh, 64)], -1)
        gt_ids[b, :n] = rng.integers(0, NUM_CLASSES, n)
    if collide:
        gt_boxes[3, 1] = gt_boxes[3, 0] + [0.5, 0, 0.5, 0]
    cls_t, _ = _assert_targets_equal(gt_boxes, gt_ids)
    assert (cls_t[0] == 0).all()
    if collide:  # the later box's class lands on the shared anchor
        anchors, _ = _jax_assign()
        from viddet_tpu_torch.ops.boxes import box_iou

        best = box_iou(torch.from_numpy(anchors), torch.from_numpy(gt_boxes[3, :2])).argmax(0)
        assert best[0] == best[1] and cls_t[3, best[1]] == gt_ids[3, 1] + 1


def test_hard_negative_ties_rank_in_anchor_order():
    """A blank image with no boxes: every anchor's CE is an exact tie, so the
    3:1 mining of the other image's negatives, and this image's zero
    positives, rest on the stable ranking."""
    anchors = JS.generate_ssd_anchors(SSD_SIZE)
    n = anchors.shape[0]
    logits = np.zeros((2, n, NUM_CLASSES + 1), np.float32)
    logits[1] = np.random.default_rng(0).normal(size=(n, NUM_CLASSES + 1))
    logits[1, ::7] = 0.0  # ties among the second image's negatives too
    deltas = np.zeros((2, n, 4), np.float32)
    gt = -np.ones((2, 2, 4), np.float32)
    ids = -np.ones((2, 2), np.int32)
    gt[1, 0], ids[1, 0] = [8, 8, 40, 30], 1
    want = jax.jit(lambda lg, d, g, i: JS.ssd_loss(
        {"cls_logits": lg, "box_deltas": d, "anchors": jnp.asarray(anchors)}, g, i))(
        *(jnp.asarray(a) for a in (logits, deltas, gt, ids)))
    got = TS.ssd_loss({"cls_logits": torch.from_numpy(logits), "box_deltas": torch.from_numpy(deltas),
                       "anchors": torch.from_numpy(anchors)}, torch.from_numpy(gt),
                      torch.from_numpy(ids))
    for k in SSD_LOSSES:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=LOSS_RTOL, err_msg=k)
    # an unstable sort would rank the tied negatives in another order
    neg_ce = torch.full((1, n), 1.5)
    order = torch.sort(-neg_ce, dim=1, stable=True).indices
    assert torch.equal(TS.inverse_permutation(order)[0], torch.arange(n))


# ------------------------------------------------------ train-mode ConvBN


@pytest.mark.parametrize("act", [True, False])
def test_conv_bn_train_matches_flax(act):
    """ResNet's unit cell in train mode: the output, the running statistics
    (0.9 * old + 0.1 * batch, biased variance) and the gradients."""
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(4, 10, 10, 8)) * 2 + 1).astype(np.float32)
    tm = ConvBN(8, 16, 3, 2, act=act, policy=TORCH_F32, scope="_ConvBN_0")
    tm = tm.to(memory_format=torch.channels_last).train()
    flat = seeded_flat(tm, 4)
    flat["batch_stats/_ConvBN_0/BatchNorm_0/var"] = rng.uniform(0.5, 2, 16).astype(np.float32)
    load_flat(tm, flat)
    tree = _unflatten({k.replace("_ConvBN_0/", ""): v for k, v in flat.items()})
    jm = JaxConvBN(16, 3, 2, policy=FLOAT32_POLICY, act=act)
    weights = rng.normal(size=(4, 5, 5, 16)).astype(np.float32)

    def jax_loss(params, xj):
        y, mut = jm.apply({"params": params, "batch_stats": tree["batch_stats"]}, xj, train=True,
                          mutable=["batch_stats"])
        return jnp.sum(y * weights), (y, mut["batch_stats"])

    (gp, gx), (want, stats) = jax.grad(jax_loss, argnums=(0, 1), has_aux=True)(
        tree["params"], jnp.asarray(x))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    xt.requires_grad_()
    got = tm(xt)
    (got * torch.from_numpy(weights).permute(0, 3, 1, 2)).sum().backward()
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tm.bn.running_mean.numpy(),
                               np.asarray(stats["BatchNorm_0"]["mean"]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tm.bn.running_var.numpy(),
                               np.asarray(stats["BatchNorm_0"]["var"]), rtol=1e-5)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(gx), rtol=1e-4,
                               atol=1e-5)
    for got_g, want_g in ((tm.conv.weight.grad.permute(2, 3, 1, 0), gp["Conv_0"]["kernel"]),
                          (tm.bn.weight.grad, gp["BatchNorm_0"]["scale"]),
                          (tm.bn.bias.grad, gp["BatchNorm_0"]["bias"])):
        np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-4, atol=1e-4)
    tm.eval()  # eval mode reads the running statistics and updates nothing
    mean = tm.bn.running_mean.clone()
    with torch.no_grad():
        tm(xt)
    assert torch.equal(tm.bn.running_mean, mean)


# ------------------------------------------------------------ the train step


def _batch(seed=0):
    return make_batch(np.random.default_rng(seed), SSD_SIZE, collide=True)


@functools.lru_cache(maxsize=None)
def _jax_grads():
    module, _ = jax_ssd()
    images, boxes, ids = _batch()
    tree = _unflatten(seeded_flat(ssd_model(), 0))

    def loss_fn(params):
        out, _ = module.apply({"params": params, "batch_stats": tree["batch_stats"]},
                              jnp.asarray(images), train=True, mutable=["batch_stats"])
        losses = JS.ssd_loss(out, jnp.asarray(boxes), jnp.asarray(ids))
        return losses["total"], losses

    grads, losses = jax.jit(jax.grad(loss_fn, has_aux=True))(tree["params"])
    return flat_of_jax(grads, {}), {k: float(v) for k, v in losses.items()}


def one_step_gaps() -> dict:
    want_grads, want_losses = _jax_grads()
    model = ssd_model()
    images, boxes, ids = (torch.from_numpy(a) for a in _batch())
    losses = TS.ssd_loss(model(images), boxes, ids)
    losses["total"].backward()
    got = {key: schema_array(t.grad, kind) for key, t, kind in leaves(model)
           if key.startswith("params/")}
    return {"loss_rel": {k: abs(float(losses[k].detach()) / want_losses[k] - 1)
                         for k in SSD_LOSSES},
            "grads": summary(leaf_gaps(got, want_grads))}


def three_step_gaps(f64=False) -> dict:
    batch = fixture_batch("ssd")
    want = jax_runs("ssd", batch, f64=f64)
    got = port_runs("ssd", batch, f64=f64)
    gaps = leaf_gaps(got["flat"], want["flat"])
    params = {k: g for k, g in gaps.items() if k.startswith("params/")}
    stats = {k: g for k, g in gaps.items() if k.startswith("batch_stats/")}
    return {"loss_rel": loss_gaps(got["losses"], want["losses"]), "params": summary(params),
            "stats": summary(stats), "all": summary(gaps)}


def test_one_step_matches_jax():
    gaps = one_step_gaps()
    assert max(gaps["loss_rel"].values()) <= LOSS_RTOL, gaps
    assert gaps["grads"]["max_rel_l2"] <= GRAD_REL_L2, gaps


def test_three_steps_match_jax():
    gaps = three_step_gaps()
    assert max(gaps["loss_rel"]) <= LOSS_RTOL, gaps
    assert gaps["all"]["median_rel_l2"] <= LEAF_REL_L2_MEDIAN, gaps
    assert gaps["params"]["max_rel_l2"] <= LEAF_REL_L2, gaps
    assert gaps["stats"]["max_rel_l2"] <= STATS_REL_L2_AFTER_3, gaps


def test_three_steps_match_jax_in_float64():
    """Both sides in float64 compute, the models' own float32 casts kept."""
    gaps = three_step_gaps(f64=True)
    assert max(gaps["loss_rel"]) <= LOSS_RTOL, gaps
    assert gaps["all"]["median_rel_l2"] <= LEAF_REL_L2_MEDIAN, gaps
    assert gaps["params"]["max_rel_l2"] <= LEAF_REL_L2, gaps
    assert gaps["stats"]["max_rel_l2"] <= STATS_REL_L2_AFTER_3_F64, gaps


def test_step_rejects_another_models_state():
    step = loop.make_ssd_train_step(ssd_model())
    with pytest.raises(ValueError, match="another model"):
        step(port_state(ssd_model()), *(torch.from_numpy(a) for a in _batch()))


def test_uint8_batch_matches_host_normalized():
    from viddet_tpu_torch.data.transforms import normalize

    rng = np.random.default_rng(7)
    u8 = rng.integers(0, 256, (2, SSD_SIZE, SSD_SIZE, 3)).astype(np.uint8)
    _, boxes, ids = _batch()
    got = {}
    for name, images in (("u8", u8), ("f32", normalize(u8))):
        model = ssd_model()
        _, got[name] = loop.make_ssd_train_step(model)(
            port_state(model), torch.from_numpy(images), torch.from_numpy(boxes),
            torch.from_numpy(ids))
    for k in SSD_LOSSES:
        np.testing.assert_allclose(float(got["u8"][k]), float(got["f32"][k]), rtol=1e-4,
                                   err_msg=k)


def test_loss_decreases_overfit():
    """``tests/unit/test_ssd.py:91``'s criterion and batch (two images at
    128 px, a box each, 2 classes, 25 float32 steps, no weight decay) on
    the shallow model: the least of the last three totals below 0.7 of the
    greatest of the first three.  JAX's test trains the full ResNet-50 at
    lr 5e-3; the shallow model takes lr 1e-3 (at 5e-3 it diverges)."""
    model = _placed(TS.SSD(2, 128, TORCH_F32, **SHALLOW), 0, "cpu", False)
    st = port_state(model, lr=1e-3, weight_decay=0.0)
    step = loop.make_ssd_train_step(model)
    x = np.random.default_rng(0).uniform(0, 1, (2, 128, 128, 3)).astype(np.float32)
    boxes = torch.tensor([[[10.0, 10, 60, 80]], [[20.0, 20, 100, 100]]])
    ids = torch.tensor([[0], [1]], dtype=torch.int32)
    history = [float(step(st, torch.from_numpy(x), boxes, ids)[1]["total"]) for _ in range(25)]
    assert np.isfinite(history).all()
    assert min(history[-3:]) < 0.7 * max(history[:3]), history


@pytest.mark.slow
def test_overfit_reaches_map_one():
    """``tools/overfit_check.py --family ssd`` on the port: 8 synthetic
    images of 3 classes memorized by the shallow SSD at 128 px (lr 2e-3
    with 50 warmup steps, no weight decay), then VOC mAP through the eval
    path (BatchNorm on running statistics)."""
    from tests.test_torch_frcnn_train import overfit_map

    assert overfit_map("ssd") > 0.95


if __name__ == "__main__":
    import json

    torch.set_num_threads(1)  # as the tests run
    print(json.dumps({"one_step": one_step_gaps(), "three_steps": three_step_gaps(),
                      "three_steps_f64": three_step_gaps(f64=True)}, indent=1))
