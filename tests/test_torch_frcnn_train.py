"""Faster R-CNN training on the CPU against the JAX package: the box
encoding, the random top-k sampler, the RPN targets, the roi sampling
(``viddet_tpu/models/faster_rcnn.py:85,345-480``), the train-mode forward
and the train step (``viddet_tpu/train/loop.py:141-174``) of the shallow
model of ``tests/unit/test_faster_rcnn.py`` (one bottleneck a stage,
widths 8..64, 128 px, ``TINY_CFG``'s counts, 3 classes) from the same
seeded weights.

The port's samplers rank uniforms they are given; the tests give them
JAX's own ``jax.random`` draws (``tests/torch_detector_helpers.py``
records the module's), and the selection is then exact: RPN labels,
sampled rois, their class and box targets, bit for bit.

Limits, float32 unless a test says otherwise:

* one step's losses within 1e-5 relative, end to end and given JAX's own
  proposals (the module's ``_proposals`` patched to return them);
* in float64 compute on both sides (the models' own float32 casts kept),
  one step's losses within 1e-5 and each gradient leaf within 1e-4
  relative L2, and after three steps every leaf within PR 13's limits
  (median 1e-5, each 5e-5): the step's semantics are JAX's;
* in float32 the gradient leaves miss 1e-4 (ROADMAP Queue 3): the
  train-mode BatchNorm statistics are float32 sums in other orders on
  each side (``tests/test_torch_train_step.py``
  ``batch_norm_statistic_errors``), the RPN's deltas inherit the gap and,
  decoded against anchors of up to 512 px, move the proposals by up to
  4.1e-3 px, hence the head's box targets; and the backbone's leaves pass
  through BatchNorm biases whose gradients nearly cancel.  Measured on
  one torch thread (``one_torch_thread``): the losses within 8.5e-6, the
  gradient leaves within 9.6e-3 (median 4.1e-3), given JAX's proposals
  1.3e-4 (median 7.4e-6); after three steps the losses 7.9e-3, the leaves
  4.8e-2.  ``ONE_STEP_F32_GRAD_REL_L2``
  holds the one-step leaves at about twice the measured gap; ``python -m
  tests.test_torch_frcnn_train`` prints them.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_detector_helpers import (  # noqa: F401 (one_torch_thread: a fixture)
    COUNTS,
    FRCNN_LOSSES,
    FRCNN_SIZE,
    RECORDED,
    fixture_batch,
    flat_of_jax,
    frcnn_model,
    jax_draws,
    jax_frcnn,
    jax_runs,
    leaf_gaps,
    loss_gaps,
    make_batch,
    one_torch_thread,
    port_runs,
    port_state,
    recording_draws,
    summary,
)
from viddet_tpu.models import faster_rcnn as JF
from viddet_tpu.train.state import _unflatten
from viddet_tpu_torch.models import faster_rcnn as TF
from viddet_tpu_torch.ops import nms_cuda
from viddet_tpu_torch.train import loop
from viddet_tpu_torch.weights import leaves, schema_array, seeded_flat

LOSS_RTOL, GRAD_REL_L2, LEAF_REL_L2_MEDIAN, LEAF_REL_L2 = 1e-5, 1e-4, 1e-5, 5e-5
ONE_STEP_F32_GRAD_REL_L2 = 2e-2  # measured 9.6e-3 (see above)
CFG = TF.FRCNNConfig(**COUNTS)
JCFG = JF.FRCNNConfig(**COUNTS, nms_backend="xla")


def _boxes(rng, n, size=FRCNN_SIZE, lo=4.0):
    xy = rng.uniform(0, size - 16, (n, 2))
    wh = rng.uniform(lo, size / 2, (n, 2))
    return np.concatenate([xy, np.minimum(xy + wh, size)], -1).astype(np.float32)


def _gt(rng, counts, m=6):
    gt = -np.ones((len(counts), m, 4), np.float32)
    ids = -np.ones((len(counts), m), np.int32)
    for b, n in enumerate(counts):
        gt[b, :n] = _boxes(rng, n, lo=12.0)
        ids[b, :n] = rng.integers(0, 3, n)
    return gt, ids


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


# --------------------------------------------------------------- encoding


@pytest.mark.parametrize("weights", [(1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)])
def test_encode_rcnn_matches_jax_bit_for_bit(weights):
    """Rois (data: JAX divides) and, for the RPN's weights, anchors (a graph
    constant in JAX's step: it multiplies by their reciprocals)."""
    rng = np.random.default_rng(0)
    anchors, gt = _boxes(rng, 300), _boxes(rng, 300)
    want = jax.jit(lambda g, a: JF.encode_rcnn(g, a, weights))(jnp.asarray(gt), jnp.asarray(anchors))
    got = TF.encode_rcnn(*_t(gt, anchors), weights)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = TF.decode_rcnn(got, torch.from_numpy(anchors), weights)
    np.testing.assert_allclose(back.numpy(), gt, rtol=1e-4, atol=1e-3)
    if weights == (1.0, 1.0, 1.0, 1.0):
        want = jax.jit(lambda g: JF.encode_rcnn(g, jnp.asarray(anchors)))(jnp.asarray(gt))
        got = TF.encode_rcnn(*_t(gt, anchors), constant_anchors=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        with pytest.raises(ValueError):
            TF.encode_rcnn(*_t(gt, anchors), weights, constant_anchors=True)


# ---------------------------------------------------------------- sampling


@pytest.mark.parametrize("k", [0, 4, 25])
def test_random_topk_select_matches_jax_given_its_draws(k):
    """``tests/unit/test_faster_rcnn.py:47`` (4 of the first 10; all 10 when
    k is 25) and the selection equal to JAX's on its own draws."""
    key = jax.random.key(0)
    eligible = np.asarray([True] * 10 + [False] * 20)
    eligible[[3, 12]] = [False, True]
    want = np.asarray(JF._random_topk_select(key, jnp.asarray(eligible), k))
    u = np.asarray(jax.random.uniform(key, (eligible.size,)))
    got = TF.random_topk_select(*_t(u[None], eligible[None]), k)[0].numpy()
    np.testing.assert_array_equal(got, want)
    assert got.sum() == min(k, eligible.sum()) and not (got & ~eligible).any()


def test_random_topk_select_takes_a_count_per_row():
    u = torch.rand((3, 50), generator=torch.Generator().manual_seed(0))
    eligible = torch.rand((3, 50), generator=torch.Generator().manual_seed(1)) < 0.5
    k = torch.tensor([[0], [3], [50]])
    got = TF.random_topk_select(u, eligible, k)
    assert got.sum(1).tolist() == [0, 3, int(eligible[2].sum())]


def test_rpn_target_assignment_case():
    """``tests/unit/test_faster_rcnn.py:57``, against JAX on its draws."""
    anchors = np.asarray([[0, 0, 32, 32], [100, 100, 132, 132], [300, 300, 332, 332]], np.float32)
    gt = np.asarray([[[0, 0, 30, 32], [-1, -1, -1, -1]]], np.float32)
    ids = np.asarray([[0, -1]], np.int32)
    key = jax.random.key(0)
    want = JF.assign_rpn_targets(jnp.asarray(anchors), jnp.asarray(gt), jnp.asarray(ids), JCFG, key)
    labels, box_t = TF.assign_rpn_targets(*_t(anchors, gt, ids), CFG,
                                          torch.from_numpy(np.array(jax_draws(key, 1, 3))))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(want[0]))
    assert labels[0, 0] == 1 and labels[0, 1] in (0, -1)  # IoU ~0.94 -> positive
    np.testing.assert_allclose(box_t.numpy(), np.asarray(want[1]), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("counts", [(0, 1, 6), (2, 3, 4)])
def test_rpn_targets_equal_jax_bit_for_bit(counts):
    """The 128-px model's 4,092 anchors, a graph constant as in JAX's step:
    labels after sampling and box targets bit for bit."""
    from viddet_tpu_torch.models.faster_rcnn import _level_anchors

    anchors = np.concatenate([_level_anchors(128 // s, 128 // s, s, sc) for s, sc in
                              zip(TF.FPN_STRIDES, TF.ANCHOR_SCALES)])
    gt, ids = _gt(np.random.default_rng(sum(counts)), counts)
    gt[2, 1] = gt[2, 0] + [0.5, 0, 0.5, 0]  # two boxes on one best anchor
    key = jax.random.key(7)
    want = jax.jit(lambda g, i, k: JF.assign_rpn_targets(jnp.asarray(anchors), g, i, JCFG, k))(
        jnp.asarray(gt), jnp.asarray(ids), key)
    u = torch.from_numpy(np.array(jax_draws(key, 3, anchors.shape[0])))
    got = TF.assign_rpn_targets(*_t(anchors, gt, ids), CFG, u)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert (got[0][1:] == 1).any() and (got[0] == 0).sum(1).tolist() == \
        [CFG.rpn_batch - int(n) for n in (got[0] == 1).sum(1)]


@pytest.mark.parametrize("proposals", [40, 80])
def test_sample_rois_equal_jax_bit_for_bit(proposals):
    """``tests/unit/test_faster_rcnn.py:71``'s composition, and the rois,
    class targets, box targets and mask equal JAX's: with 40 proposals and
    a few boxes there are fewer candidates than ``roi_batch`` (64), so both
    pad; with 80 neither does."""
    rng = np.random.default_rng(proposals)
    props = np.stack([_boxes(rng, proposals) for _ in range(2)])
    p_valid = rng.uniform(size=(2, proposals)) > 0.1
    gt, ids = _gt(rng, (1, 4))
    props[1, :5] = gt[1, 0] + rng.uniform(-2, 2, (5, 4))  # near-duplicates: positives
    key = jax.random.key(1)
    want = jax.jit(lambda *a: JF.sample_rois(key, *a, JCFG))(
        *(jnp.asarray(a) for a in (props, p_valid, gt, ids)))
    u = torch.from_numpy(np.array(jax_draws(key, 2, proposals + gt.shape[1])))
    got = TF.sample_rois(u, *_t(props, p_valid, gt, ids), CFG)
    for name, g, w in zip(("rois", "cls_target", "box_target", "mask"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    cls_t = got[1].numpy()
    assert (cls_t[1] == ids[1, 0] + 1).sum() >= 1 and (cls_t == 0).any()
    for row in cls_t:  # positives first, then negatives, then padding
        assert (np.diff(np.where(row > 0, 0, np.where(row == 0, 1, 2))) >= 0).all()
    assert (cls_t < 0).any() == (proposals + gt.shape[1] < CFG.roi_batch)


# ------------------------------------------------------------ train mode


def test_k5_takes_detached_boxes():
    boxes = torch.rand(1, 8, 4, requires_grad=True)
    with pytest.raises(ValueError, match="detach"):
        nms_cuda.nms_keep_mask(boxes, torch.ones(1, 8, dtype=torch.bool), 0.7)


def test_train_forward_needs_ground_truth_and_draws():
    model = frcnn_model()
    images, boxes, ids = _t(*make_batch(np.random.default_rng(0), FRCNN_SIZE))
    with pytest.raises(ValueError, match="gt_boxes"):
        model(images)
    with pytest.raises(ValueError, match="generator"):
        model(images, boxes, ids)
    gen = torch.Generator().manual_seed(0)
    out = model(images, boxes, ids, generator=gen)
    assert out["rois"].shape == (2, CFG.roi_batch, 4)
    assert out["roi_cls_logits"].shape == (2, CFG.roi_batch, 4)
    assert not out["proposals"].requires_grad and out["roi_cls_logits"].requires_grad


def test_step_draws_rois_then_rpn_from_its_generator():
    """One generator feeds both samplers, the roi sampling first: the step
    equals the same step given those two draws."""
    images, boxes, ids = _t(*make_batch(np.random.default_rng(1), FRCNN_SIZE))
    n_anchors = 4092
    gen = torch.Generator().manual_seed(3)
    roi_u = torch.rand((2, 2, CFG.rpn_post_nms_train + 4), generator=gen)
    rpn_u = torch.rand((2, 2, n_anchors), generator=gen)
    losses = []
    for kw in ({"generator": torch.Generator().manual_seed(3)},
               {"generator": None, "uniforms": (roi_u, rpn_u)}):
        model = frcnn_model()
        gen_arg = kw.pop("generator")
        losses.append(loop.make_frcnn_train_step(model)(port_state(model), gen_arg, images,
                                                        boxes, ids, **kw)[1])
    for k in FRCNN_LOSSES:
        assert float(losses[0][k]) == float(losses[1][k]), k


@functools.lru_cache(maxsize=None)
def _jax_one_step(f64=False):
    """JAX's losses and gradients of one step from the seeded weights, with
    the draws and the sampling it recorded."""
    module, _ = jax_frcnn(f64)
    images, boxes, ids = fixture_batch("frcnn")
    dtype = jnp.float64 if f64 else jnp.float32
    with jax.enable_x64(f64):
        tree = _unflatten({k: v.astype(dtype) for k, v in seeded_flat(frcnn_model(), 0).items()})

        def loss_fn(params, key, x, g, i):
            sk, tk = jax.random.split(key)
            out, _ = module.apply({"params": params, "batch_stats": tree["batch_stats"]}, x, g, i,
                                  train=True, mutable=["batch_stats"], rngs={"sampling": sk})
            losses = JF.frcnn_loss(out, g, i, module.config, tk)
            return losses["total"], losses

        with recording_draws():
            grads, losses = jax.jit(jax.grad(loss_fn, has_aux=True))(
                tree["params"], jax.random.key(3), jnp.asarray(images, dtype), jnp.asarray(boxes),
                jnp.asarray(ids))
        return (flat_of_jax(grads, {}), {k: float(v) for k, v in losses.items()},
                {k: list(v) for k, v in RECORDED.items()})


def one_step_gaps(f64=False, jax_proposals=False) -> dict:
    """Losses (relative), the selection, and the gradient leaves (relative
    L2) of one step; ``jax_proposals``: the port's forward takes JAX's."""
    want_grads, want_losses, rec = _jax_one_step(f64)
    model = frcnn_model(f64=f64)
    if jax_proposals:
        fixed = _t(*rec["roi"][1:3])
        model._proposals = lambda *a, **k: fixed
    images, boxes, ids = _t(*fixture_batch("frcnn"))
    out = model(images.to(torch.float64 if f64 else torch.float32), boxes, ids,
                roi_uniform=torch.from_numpy(rec["roi"][0]))
    losses = TF.frcnn_loss(out, boxes, ids, model.config, torch.from_numpy(rec["rpn"][0]))
    labels, _ = TF.assign_rpn_targets(out["anchors"], boxes, ids, model.config,
                                      torch.from_numpy(rec["rpn"][0]))
    losses["total"].backward()
    got = {key: schema_array(t.grad, kind) for key, t, kind in leaves(model)
           if key.startswith("params/")}
    return {"loss_rel": {k: abs(float(losses[k].detach()) / want_losses[k] - 1)
                         for k in FRCNN_LOSSES},
            "roi_targets_equal": bool(np.array_equal(out["roi_cls_target"].numpy(), rec["roi"][4])),
            "rpn_labels_equal": bool(np.array_equal(labels.numpy(), rec["rpn"][1])),
            "proposals_max_abs": float(np.abs(out["proposals"].numpy() - rec["roi"][1]).max()),
            "grads": summary(leaf_gaps(got, want_grads))}


def test_recorded_draws_reproduce_jax_sampling():
    """The recorded uniforms, through the port's samplers on JAX's own
    proposals, give JAX's rois, targets and RPN labels bit for bit."""
    _, _, rec = _jax_one_step()
    roi_u, props, p_valid, *want = rec["roi"]
    _, boxes, ids = fixture_batch("frcnn")
    got = TF.sample_rois(*_t(roi_u, props, p_valid, boxes, ids), CFG)
    for name, g, w in zip(("rois", "cls_target", "box_target", "mask"), got, want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    model = frcnn_model()
    _, anchors = model.anchors([torch.empty(1, 1, FRCNN_SIZE // s, FRCNN_SIZE // s)
                                for s in TF.FPN_STRIDES])
    labels, box_t = TF.assign_rpn_targets(anchors, *_t(boxes, ids), CFG,
                                          torch.from_numpy(rec["rpn"][0]))
    np.testing.assert_array_equal(labels.numpy(), rec["rpn"][1])
    np.testing.assert_array_equal(box_t.numpy(), rec["rpn"][2])


def test_one_step_float32():
    gaps = one_step_gaps()
    assert gaps["roi_targets_equal"] and gaps["rpn_labels_equal"], gaps
    assert max(gaps["loss_rel"].values()) <= LOSS_RTOL, gaps
    assert gaps["grads"]["max_rel_l2"] <= ONE_STEP_F32_GRAD_REL_L2, gaps
    gaps = one_step_gaps(jax_proposals=True)
    assert max(gaps["loss_rel"].values()) <= LOSS_RTOL, gaps


def test_one_step_matches_jax_in_float64():
    gaps = one_step_gaps(f64=True)
    assert gaps["roi_targets_equal"] and gaps["rpn_labels_equal"], gaps
    assert max(gaps["loss_rel"].values()) <= LOSS_RTOL, gaps
    assert gaps["grads"]["max_rel_l2"] <= GRAD_REL_L2, gaps


def three_step_gaps(f64=False) -> dict:
    batch = fixture_batch("frcnn")
    want = jax_runs("frcnn", batch, f64=f64)
    got = port_runs("frcnn", batch, f64=f64, records=want["records"])
    return {"loss_rel": loss_gaps(got["losses"], want["losses"]),
            "leaves": summary(leaf_gaps(got["flat"], want["flat"]))}


def test_three_steps_match_jax_in_float64():
    gaps = three_step_gaps(f64=True)
    assert max(gaps["loss_rel"]) <= LOSS_RTOL, gaps
    assert gaps["leaves"]["median_rel_l2"] <= LEAF_REL_L2_MEDIAN, gaps
    assert gaps["leaves"]["max_rel_l2"] <= LEAF_REL_L2, gaps


def test_loss_decreases_overfit():
    """``tests/unit/test_faster_rcnn.py:147``'s criterion on the shallow
    model: 12 steps (lr 2e-3, no weight decay) on one image, the least of
    the last three totals below the greatest of the first three."""
    model = frcnn_model()
    st = port_state(model, lr=2e-3, weight_decay=0.0)
    step = loop.make_frcnn_train_step(model)
    x = np.random.default_rng(0).uniform(0, 1, (1, FRCNN_SIZE, FRCNN_SIZE, 3)).astype(np.float32)
    images, boxes, ids = _t(x, [[[20, 20, 80, 90]]], [[0]])
    boxes = boxes.float()
    gen = torch.Generator().manual_seed(5)
    history = [float(step(st, gen, images, boxes, ids.int())[1]["total"]) for _ in range(12)]
    assert np.isfinite(history).all()
    assert min(history[-3:]) < max(history[:3]), history


def overfit_map(family: str, steps: int = 400, size: int = 128) -> float:
    """``tools/overfit_check.py`` on the port's shallow models: 8 synthetic
    images of 3 classes, lr 2e-3 after 50 warmup steps, no weight decay;
    then VOC mAP through the eval path (BatchNorm on running statistics)."""
    from viddet_tpu_torch.cli.common import make_predictor
    from viddet_tpu_torch.data.loader import pad_label
    from viddet_tpu_torch.data.synthetic import SyntheticDetection
    from viddet_tpu_torch.data.transforms import ValTransform
    from viddet_tpu_torch.eval.voc_map import VOCMApMetric
    from viddet_tpu_torch.models import ssd as TS
    from tests.torch_detector_helpers import SHALLOW, TORCH_F32, _placed
    from viddet_tpu_torch.train import state as st_mod

    ds = SyntheticDetection(num_images=8, size=size, num_classes=3, seed=3)
    tf = ValTransform(size=(size, size))
    images, labels = [], []
    for i in range(len(ds)):
        x, label, _ = tf(*ds[i])
        images.append(x)
        labels.append(pad_label(label, 10))
    labels = np.stack(labels)
    batch = _t(np.stack(images), labels[:, :, :4].copy(), labels[:, :, 4].astype(np.int32))
    if family == "ssd":
        model = _placed(TS.SSD(3, size, TORCH_F32, **SHALLOW), 0, "cpu", False)
        step = loop.make_ssd_train_step(model)
    else:
        cfg = TF.FRCNNConfig(rpn_pre_nms_topk=500, rpn_nms_input=500, rpn_post_nms_train=256,
                             rpn_post_nms_test=100, roi_batch=128)
        model = _placed(TF.FasterRCNN(3, cfg, TORCH_F32, **SHALLOW), 0, "cpu", False)
        gen = torch.Generator().manual_seed(0)
        frcnn_step = loop.make_frcnn_train_step(model)
        step = lambda s, *b: frcnn_step(s, gen, *b)  # noqa: E731
    tx = st_mod.make_optimizer(st_mod.make_lr_schedule(2e-3, 1, warmup_epochs=50),
                               weight_decay=0.0)
    state = st_mod.TrainState(model, tx)
    for _ in range(steps):
        step(state, *batch)
    model.eval()
    ids, scores, boxes = make_predictor(model)(batch[0])
    metric = VOCMApMetric(class_names=[f"c{i}" for i in range(3)])
    metric.update(boxes.numpy(), ids.numpy(), scores.numpy(), labels[:, :, :4], labels[:, :, 4])
    return metric.get()[1][-1]


@pytest.mark.slow
def test_overfit_reaches_map_one():
    assert overfit_map("frcnn") > 0.95


if __name__ == "__main__":
    import json

    torch.set_num_threads(1)  # as the tests run
    print(json.dumps({"one_step": one_step_gaps(),
                      "one_step_jax_proposals": one_step_gaps(jax_proposals=True),
                      "one_step_f64": one_step_gaps(f64=True),
                      "three_steps": three_step_gaps(),
                      "three_steps_f64": three_step_gaps(f64=True)}, indent=1))
