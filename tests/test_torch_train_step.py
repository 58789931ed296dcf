"""The port's train-mode model and train step against the JAX package's, in
float32 on the CPU, from the same seeded weights and batch.

Limits (the acceptance criteria of the training slice):

* each loss within rtol 1e-5 after one step;
* each gradient leaf within a relative L2 distance of 1e-4;
* the parameters and BatchNorm statistics after three steps: the median
  leaf within 1e-5; every leaf within ``LEAF_REL_L2_AFTER_3 = 5e-5``,
  above the 1e-5 asked for.  The measured gap is 3.32e-5, on the first
  layer's BatchNorm bias, whose values after three steps are the small sums
  of its updates; 8 of the 59 leaves are above 1e-5, the median is 8.2e-7
  (``python -m tests.test_torch_train_step`` prints them).  It is recorded
  in ROADMAP Queue 3.  Its source is float32 rounding: the BatchNorm
  statistics are sums in other orders (over 32,768 values, relative to
  float64: Flax's mean 9.9e-7 and variance 1.5e-6 off, the port's 6.6e-7
  and 4.7e-7), and a BatchNorm bias followed by another BatchNorm gets a
  gradient that nearly cancels, so its rounding dominates it (ROADMAP
  Queue 3: at batch 8 these leaves differ by 3e-2).

Also the train-mode BatchNorm against Flax's (batch statistics, the
biased variance folded into the running one, float32 statistics of a
bf16 input), K8 kept off under training, the mirrored cases of
``tests/integration/test_train_step.py`` and the temporal model's ``conv``
aggregation in training.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_train_helpers import (
    ANCHORS,
    LOSS_NAMES,
    STRIDES,
    flat_of_jax,
    jax_state,
    jax_step,
    leaf_gaps,
    make_batch,
    port_model,
    port_state,
    port_step,
)
from viddet_tpu.core.precision import DEFAULT_POLICY as JAX_BF16
from viddet_tpu.core.precision import FLOAT32_POLICY
from viddet_tpu.models.common import ConvBNLeaky as JaxConvBNLeaky
from viddet_tpu.train.losses import yolo_loss as jax_yolo_loss
from viddet_tpu.train.state import _unflatten
from viddet_tpu_torch.core.platform import set_conv_backend
from viddet_tpu_torch.core.precision import DEFAULT_POLICY as TORCH_BF16
from viddet_tpu_torch.core.precision import FLOAT32_POLICY as TORCH_F32
from viddet_tpu_torch.models import common
from viddet_tpu_torch.models.yolo3 import flatten_outputs
from viddet_tpu_torch.train.losses import yolo_loss
from viddet_tpu_torch.weights import seeded_flat, to_flat

LOSS_RTOL_STEP1, GRAD_REL_L2, LEAF_REL_L2_MEDIAN, LEAF_REL_L2_AFTER_3 = 1e-5, 1e-4, 1e-5, 5e-5


def _batch(seed=0, collide=True):
    return make_batch(np.random.default_rng(seed), collide=collide)


# ------------------------------------------------------- train-mode BatchNorm


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_bn_leaky_train_matches_flax(dtype):
    """One train-mode ConvBNLeaky: the output, the updated running
    statistics (0.9 * old + 0.1 * batch, biased variance, in float32) and,
    in float32, the gradients of input, kernel, scale and bias."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(4, 12, 10, 8)) * 2 + 1).astype(np.float32)  # NHWC, mean far from 0
    jpol, tpol = (FLOAT32_POLICY, TORCH_F32) if dtype == "float32" else (JAX_BF16, TORCH_BF16)
    jm = JaxConvBNLeaky(16, 3, policy=jpol)
    tm = common.ConvBNLeaky(8, 16, 3, policy=tpol, scope="ConvBNLeaky_0")
    tm = tm.to(memory_format=torch.channels_last).train()
    flat = {k.replace("ConvBNLeaky_0/", ""): v for k, v in seeded_flat(tm, 1).items()}
    flat["params/BatchNorm_0/scale"] = rng.uniform(0.5, 2, 16).astype(np.float32)
    flat["batch_stats/BatchNorm_0/var"] = rng.uniform(0.5, 2, 16).astype(np.float32)
    from viddet_tpu_torch.weights import load_flat

    load_flat(tm, {k.replace("/", "/ConvBNLeaky_0/", 1): v for k, v in flat.items()})
    tree = _unflatten(flat)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    xt.requires_grad_(dtype == "float32")

    def jax_apply(params, xj):
        y, mut = jm.apply({"params": params, "batch_stats": tree["batch_stats"]}, xj, train=True,
                          mutable=["batch_stats"])
        return y, mut["batch_stats"]

    (want, stats) = jax_apply(tree["params"], jnp.asarray(x))
    got = tm(xt.to(tpol.compute_dtype) if dtype == "bfloat16" else xt)
    np.testing.assert_allclose(got.float().permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(want, np.float32),
                               rtol=1e-5 if dtype == "float32" else 2 ** -7, atol=1e-5)
    np.testing.assert_allclose(tm.bn.running_mean.numpy(), np.asarray(stats["BatchNorm_0"]["mean"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tm.bn.running_var.numpy(), np.asarray(stats["BatchNorm_0"]["var"]),
                               rtol=1e-5)
    if dtype == "bfloat16":
        return
    weights = rng.normal(size=np.asarray(want).shape).astype(np.float32)
    (got * torch.from_numpy(weights).permute(0, 3, 1, 2)).sum().backward()

    def jax_loss(params, xj):
        return jnp.sum(jax_apply(params, xj)[0] * weights)

    gp, gx = jax.grad(jax_loss, argnums=(0, 1))(tree["params"], jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(gx), rtol=1e-4,
                               atol=1e-5)
    for got_g, want_g in ((tm.conv.weight.grad.permute(2, 3, 1, 0), gp["Conv_0"]["kernel"]),
                          (tm.bn.weight.grad, gp["BatchNorm_0"]["scale"]),
                          (tm.bn.bias.grad, gp["BatchNorm_0"]["bias"])):
        np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-4, atol=1e-4)


def test_running_var_is_the_biased_one():
    bn_layer = common.ConvBNLeaky(3, 4, 1, policy=TORCH_F32).train()
    x = torch.randn(2, 4, 3, 3)
    common.batch_norm_train(x, bn_layer.bn)
    biased = x.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(bn_layer.bn.running_var, 0.9 + 0.1 * biased, rtol=1e-6, atol=1e-7)


def test_k8_stays_off_in_training(monkeypatch):
    """Under ``VIDDET_CONV_BACKEND=pallas`` a stride-2 3x3 layer routes to K8
    in eval mode only: K8 has no backward."""
    calls = []
    monkeypatch.setattr(common, "conv_down2_bn_leaky",
                        lambda *a, **k: calls.append(1) or (_ for _ in ()).throw(AssertionError))
    layer = common.ConvBNLeaky(32, 64, 3, stride=2, policy=TORCH_F32)
    x = torch.randn(2, 32, 16, 16).contiguous(memory_format=torch.channels_last)
    set_conv_backend("pallas")
    try:
        assert layer.eval().fused_down2(x)
        assert not layer.train().fused_down2(x)
        layer(x).sum().backward()
    finally:
        set_conv_backend("auto")
    assert not calls and layer.conv.weight.grad is not None


# ----------------------------------------------------------- the train step


@functools.lru_cache(maxsize=None)
def _jax_grads():
    """JAX's losses and gradients of one step from the seeded weights."""
    module, _ = jax_step()
    images, boxes, ids = _batch()
    tree = _unflatten(seeded_flat(port_model(), 0))

    def loss_fn(params):
        out, _ = module.apply({"params": params, "batch_stats": tree["batch_stats"]},
                              jnp.asarray(images), train=True, mutable=["batch_stats"])
        losses = jax_yolo_loss(out, jnp.asarray(boxes), jnp.asarray(ids), None,
                               image_size=(64, 64), strides=STRIDES, anchors=ANCHORS,
                               num_classes=3)
        return losses["total"], losses

    grads, losses = jax.jit(jax.grad(loss_fn, has_aux=True))(tree["params"])
    return flat_of_jax(grads, {}), {k: float(v) for k, v in losses.items()}


def one_step_gaps() -> dict:
    """Losses (relative) and gradient leaves (relative L2) of one step."""
    want_grads, want_losses = _jax_grads()
    model = port_model()
    images, boxes, ids = (torch.from_numpy(a) for a in _batch())
    losses = yolo_loss(flatten_outputs(model(images)), boxes, ids, None, image_size=(64, 64),
                       strides=STRIDES, anchors=ANCHORS, num_classes=3)
    losses["total"].backward()
    from viddet_tpu_torch.weights import leaves, schema_array

    got = {key: schema_array(t.grad, kind) for key, t, kind in leaves(model)
           if key.startswith("params/")}
    gaps = leaf_gaps(got, want_grads)
    worst = max(gaps, key=gaps.get)
    return {"loss_rel": {k: abs(float(losses[k].detach()) / want_losses[k] - 1)
                         for k in LOSS_NAMES},
            "grad_worst": worst, "grad_max_rel_l2": gaps[worst],
            "grad_median_rel_l2": float(np.median(list(gaps.values())))}


def three_step_gaps(batch: int = 2) -> dict:
    """Losses of each step (relative) and every parameter and statistic
    after step 3 (relative L2), on a batch of ``batch`` images."""
    images, boxes, ids = make_batch(np.random.default_rng(0), batch=batch, collide=True)
    _, step = jax_step()
    jstate = jax_state(seeded_flat(port_model(), 0))
    state = port_state(port_model())
    tstep = port_step()
    loss_rel = []
    for _ in range(3):
        jstate, want = step(jstate, jnp.asarray(images), jnp.asarray(boxes), jnp.asarray(ids))
        _, got = tstep(state, *(torch.from_numpy(a) for a in (images, boxes, ids)))
        loss_rel.append({k: abs(float(got[k]) / float(want[k]) - 1) for k in LOSS_NAMES})
    gaps = leaf_gaps(to_flat(state.model), flat_of_jax(jstate.params, jstate.batch_stats))
    worst = max(gaps, key=gaps.get)
    return {"loss_rel": loss_rel, "leaf_worst": worst, "leaf_max_rel_l2": gaps[worst],
            "leaf_median_rel_l2": float(np.median(list(gaps.values()))),
            "leaves_above_1e-5": sum(g > 1e-5 for g in gaps.values()), "leaves": len(gaps),
            "steps": state.step}


def test_losses_and_gradients_match_jax():
    gaps = one_step_gaps()
    assert max(gaps["loss_rel"].values()) <= LOSS_RTOL_STEP1, gaps
    assert gaps["grad_max_rel_l2"] <= GRAD_REL_L2, gaps


def test_three_steps_match_jax():
    gaps = three_step_gaps()
    assert max(gaps["loss_rel"][0].values()) <= LOSS_RTOL_STEP1, gaps
    assert max(max(r.values()) for r in gaps["loss_rel"]) <= 1e-4, gaps
    assert gaps["leaf_median_rel_l2"] <= LEAF_REL_L2_MEDIAN, gaps
    assert gaps["leaf_max_rel_l2"] <= LEAF_REL_L2_AFTER_3, gaps
    assert gaps["steps"] == 3


# ------------------------------- tests/integration/test_train_step.py cases


def test_one_step_runs_and_updates():
    state = port_state(port_model(), weight_decay=0.0)
    p0 = state.params[0].detach().clone()
    _, losses = port_step()(state, *(torch.from_numpy(a) for a in _batch(0, collide=False)))
    for name, value in losses.items():
        assert np.isfinite(float(value)), name
    assert state.step == 1
    assert not torch.allclose(p0, state.params[0])


def test_loss_decreases_overfit():
    state = port_state(port_model(), lr=5e-4, weight_decay=0.0)
    step = port_step()
    batch = tuple(torch.from_numpy(a) for a in _batch(1, collide=False))
    first = None
    for _ in range(30):
        _, losses = step(state, *batch)
        if first is None:
            first = float(losses["total"])
    last = float(losses["total"])
    assert last < 0.5 * first, (first, last)


def test_uint8_batch_matches_host_normalized():
    from viddet_tpu_torch.data.transforms import normalize

    rng = np.random.default_rng(7)
    u8 = rng.integers(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    _, boxes, ids = make_batch(rng)
    step = port_step()
    _, losses_u8 = step(port_state(port_model()), torch.from_numpy(u8), torch.from_numpy(boxes),
                        torch.from_numpy(ids))
    _, losses_f32 = step(port_state(port_model()), torch.from_numpy(normalize(u8)),
                         torch.from_numpy(boxes), torch.from_numpy(ids))
    for name in losses_f32:
        np.testing.assert_allclose(float(losses_u8[name]), float(losses_f32[name]), rtol=1e-4,
                                   err_msg=name)


# ---------------------------------------------- temporal: conv aggregation


def test_temporal_conv_aggregation_trains_like_jax():
    """Tiny temporal YOLOv3 (k = 2, ``conv``: a ConvBNLeaky over the
    time-stacked features) in train mode: one step's losses within rtol
    1e-5 of JAX's, and the aggregator's BatchNorm statistics updated."""
    from viddet_tpu.models.temporal import TemporalYOLOv3 as JaxTemporal
    from viddet_tpu.train.loop import make_train_step as jax_make_train_step
    from viddet_tpu_torch.models.temporal import TemporalYOLOv3

    model = TemporalYOLOv3(num_classes=3, k=2, backbone="tiny", aggregation="conv",
                           anchors=ANCHORS, strides=STRIDES, policy=TORCH_F32)
    model = model.to(memory_format=torch.channels_last).train()
    flat = seeded_flat(model, 2)
    from viddet_tpu_torch.weights import load_flat

    load_flat(model, flat)
    jmod = JaxTemporal(num_classes=3, k=2, backbone="tiny", aggregation="conv", anchors=ANCHORS,
                       strides=STRIDES, policy=FLOAT32_POLICY)
    jstep = jax_make_train_step(jmod, strides=STRIDES, anchors=ANCHORS, num_classes=3)
    images, boxes, ids = _batch(3)
    clips = np.stack([images, images[::-1]], axis=1)  # (B, 2, H, W, 3)
    _, want = jstep(jax_state(flat), jnp.asarray(clips), jnp.asarray(boxes), jnp.asarray(ids))
    var0 = model.aggregators[0].bn.running_var.clone()
    _, got = port_step()(port_state(model), torch.from_numpy(clips), torch.from_numpy(boxes),
                         torch.from_numpy(ids))
    for name in LOSS_NAMES:
        np.testing.assert_allclose(float(got[name]), float(want[name]), rtol=LOSS_RTOL_STEP1,
                                   err_msg=name)
    assert not torch.equal(model.aggregators[0].bn.running_var, var0)


# ------------------------------------- tests/integration/test_overfit_map.py


@pytest.mark.slow
def test_overfit_reaches_high_map():
    """The synthetic set of 8 images memorized by tiny YOLOv3 in 250 float32
    steps: the loss below a tenth of its first value, VOC mAP above 0.85
    through the port's eval path (BatchNorm on running statistics)."""
    from viddet_tpu_torch.data.loader import pad_label
    from viddet_tpu_torch.data.synthetic import SyntheticDetection
    from viddet_tpu_torch.data.transforms import ValTransform
    from viddet_tpu_torch.eval.voc_map import VOCMApMetric
    from viddet_tpu_torch.models.yolo3 import NMSConfig, forward_and_postprocess

    anchors = (((40, 40), (24, 44), (44, 24)), ((14, 14), (10, 20), (20, 10)))
    ds = SyntheticDetection(num_images=8, size=64, num_classes=3, seed=3)
    tf = ValTransform(size=(64, 64))
    images, labels = [], []
    for i in range(len(ds)):
        x, label, _ = tf(*ds[i])
        images.append(x)
        labels.append(pad_label(label, 10))
    images, labels = np.stack(images), np.stack(labels)
    batch = (torch.from_numpy(images), torch.from_numpy(labels[:, :, :4].copy()),
             torch.from_numpy(labels[:, :, 4].astype(np.int32)))
    model = port_model(anchors=anchors)
    state = port_state(model, weight_decay=0.0)
    step = port_step(anchors=anchors)
    totals = [float(step(state, *batch)[1]["total"]) for _ in range(250)]
    assert totals[-1] < 0.1 * totals[0], (totals[0], totals[-1])
    model.eval()
    with torch.inference_mode():
        ids, scores, boxes = forward_and_postprocess(model, batch[0], NMSConfig())
    metric = VOCMApMetric(class_names=[f"c{i}" for i in range(3)])
    metric.update(boxes.numpy(), ids.numpy(), scores.numpy(), labels[:, :, :4], labels[:, :, 4])
    names, values = metric.get()
    assert values[-1] > 0.85, dict(zip(names, values))


def batch_norm_statistic_errors(n: int = 8, seed: int = 0) -> dict:
    """The largest error of each side's float32 batch mean and variance over
    an (n, 64, 64, 16) activation (normal, mean 0.3, spread 0.7), relative
    to the largest float64 value: Flax's ``nn.BatchNorm`` as XLA compiles
    it on the CPU (its momentum 0 leaves the batch statistics in the
    running ones) and the port's ``native_batch_norm``."""
    import flax.linen as fnn

    x = (np.random.default_rng(seed).normal(size=(n, 64, 64, 16)) * 0.7 + 0.3).astype(np.float32)
    x64 = x.astype(np.float64)
    mean64 = x64.mean((0, 1, 2))
    var64 = x64.var((0, 1, 2))
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.0, epsilon=1e-5)
    variables = bn.init(jax.random.key(0), jnp.asarray(x))
    _, stats = jax.jit(lambda v, a: bn.apply(v, a, mutable=["batch_stats"]))(variables,
                                                                              jnp.asarray(x))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    _, mean, invstd = torch.native_batch_norm(xt, None, None, None, None, True, 0.0, 1e-5)

    def err(got, want):
        return float(np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max())

    return {"jax_mean": err(stats["batch_stats"]["mean"], mean64),
            "jax_var": err(stats["batch_stats"]["var"], var64),
            "port_mean": err(mean.numpy(), mean64),
            "port_var": err((invstd.pow(-2) - 1e-5).numpy(), var64)}


if __name__ == "__main__":
    import json

    # the measured gaps behind the limits above; batch 8 and the statistics'
    # errors for ROADMAP Queue 3
    print(json.dumps({"one_step": one_step_gaps(), "three_steps": three_step_gaps(),
                      "three_steps_batch_8": three_step_gaps(8),
                      "batch_norm_statistic_errors": batch_norm_statistic_errors()}, indent=1))
