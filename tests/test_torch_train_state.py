"""The port's schedule, optimizer, checkpoints, ``.npz`` export and mixup
against the JAX package's (``viddet_tpu/train/state.py``,
``cli/train_yolov3.py:106``), and resume bit for bit.

The schedule equals the reference's jitted one bit for bit.  The update is
held to optax's within 1e-6 over 50 steps: the compiled reference fuses
its multiply-adds as the XLA graph around them allows, and the port fuses
each line of the update, so an element can differ by an ulp a step.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.torch_train_helpers import (
    flat_of_jax,
    jax_state,
    jax_step,
    make_batch,
    port_model,
    port_state,
    port_step,
)
from viddet_tpu.cli.train_yolov3 import mixup_batch as jax_mixup_batch
from viddet_tpu.train.state import load_weights_npz as jax_load_npz
from viddet_tpu.train.state import make_lr_schedule as jax_schedule
from viddet_tpu.train.state import make_optimizer as jax_optimizer
from viddet_tpu.train.state import save_weights_npz as jax_save_npz
from viddet_tpu_torch.cli.train_yolov3 import mixup_batch
from viddet_tpu_torch.train import state as st
from viddet_tpu_torch.weights import load_flat, seeded_flat, to_flat

SCHEDULES = [
    dict(base_lr=1e-3, steps_per_epoch=7, warmup_epochs=2.0, decay_epochs=(3, 5), decay_factor=0.1),
    dict(base_lr=1e-3, steps_per_epoch=13, warmup_epochs=1.5, decay_epochs=(2,), decay_factor=0.3),
    dict(base_lr=3e-4, steps_per_epoch=11, warmup_epochs=3.0, decay_epochs=(), decay_factor=0.1),
    dict(base_lr=2e-2, steps_per_epoch=3, warmup_epochs=0.0, decay_epochs=(4,), decay_factor=0.1),
]


@pytest.mark.parametrize("kw", SCHEDULES, ids=range(len(SCHEDULES)))
def test_schedule_matches_jitted_reference(kw):
    steps = np.arange(80)
    want = np.asarray(jax.jit(jax.vmap(jax_schedule(**kw)))(steps))
    port = st.make_lr_schedule(**kw)
    np.testing.assert_array_equal(np.array([port(int(s)) for s in steps], np.float32), want)


@pytest.mark.parametrize("kw", SCHEDULES[:2], ids=range(2))
def test_optimizer_matches_optax_50_steps(kw):
    rng = np.random.default_rng(5)
    shapes = {"w": (3, 3, 8, 16), "b": (16,), "s": (17,)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    tx = jax_optimizer(jax_schedule(**kw), momentum=0.9, weight_decay=5e-4)
    opt_state = tx.init(params)

    @jax.jit
    def update(grads, opt_state, p):
        u, opt_state = tx.update(grads, opt_state, p)
        return optax.apply_updates(p, u), opt_state

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = [torch.from_numpy(params[k].copy()) for k in shapes]
    momenta = [torch.zeros_like(t) for t in tp]
    sgd = st.make_optimizer(st.make_lr_schedule(**kw), momentum=0.9, weight_decay=5e-4)
    for count in range(50):
        grads = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
        jp, opt_state = update({k: jnp.asarray(v) for k, v in grads.items()}, opt_state, jp)
        momenta = sgd.update(tp, [torch.from_numpy(grads[k]) for k in shapes], momenta, count)
        for k, t in zip(shapes, tp):
            np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-6,
                                       err_msg=f"{k} after update {count + 1}")
    trace = opt_state[1][0].trace
    for k, m in zip(shapes, momenta):
        np.testing.assert_allclose(m.numpy(), np.asarray(trace[k]), rtol=1e-6, atol=1e-6)


def test_weight_decay_reaches_batchnorm_not_statistics():
    """MXNet's rule: decay on every parameter (BN scale and bias included);
    the running statistics are not parameters."""
    model = port_model()
    state = port_state(model, lr=1.0, weight_decay=0.5, momentum=0.0)
    scale = dict(model.named_parameters())["backbone.cells.0.bn.weight"]
    mean = model.backbone.cells[0].bn.running_mean
    for p in state.params:
        p.grad = torch.zeros_like(p)
    before = mean.clone()
    state.apply_gradients()
    assert torch.equal(scale, torch.full_like(scale, 0.5))  # 1 - 1.0 * (0 + 0.5 * 1)
    assert torch.equal(mean, before)
    assert state.step == 1


# ------------------------------------------------ checkpoints and resume


def _steps(state, step, batch, n):
    for _ in range(n):
        step(state, *batch)
    return state


def test_resume_bit_identical(tmp_path):
    """4 steps straight against 2, save, restore into a fresh state, 2 more
    (``tests/integration/test_checkpoint.py:67``)."""
    batch = tuple(torch.from_numpy(a) for a in make_batch(np.random.default_rng(0)))
    step = port_step()
    straight = _steps(port_state(port_model()), step, batch, 4)

    first = _steps(port_state(port_model()), step, batch, 2)
    ckpt_dir = str(tmp_path / "ckpt")
    st.save_checkpoint(ckpt_dir, first, first.step)
    path = st.latest_checkpoint(ckpt_dir)
    assert path is not None and path.endswith("step_00000002")
    resumed = st.restore_checkpoint(path, port_state(port_model(seed=9)))
    assert resumed.step == 2
    _steps(resumed, step, batch, 2)

    for key, value in to_flat(straight.model).items():
        np.testing.assert_array_equal(to_flat(resumed.model)[key], value, err_msg=key)
    for a, b in zip(straight.momenta, resumed.momenta):
        assert torch.equal(a, b)
    assert resumed.step == straight.step == 4


def test_checkpoint_holds_the_npz_schema(tmp_path):
    state = _steps(port_state(port_model()), port_step(),
                   tuple(torch.from_numpy(a) for a in make_batch(np.random.default_rng(1))), 1)
    st.save_checkpoint(str(tmp_path), state, 1, block=True)
    saved = torch.load(tmp_path / "step_00000001" / "state.pt", weights_only=True)
    flat = to_flat(state.model)
    assert saved["step"] == 1
    assert set(saved["params"]) | set(saved["batch_stats"]) == set(flat)
    assert set(saved["momentum"]) == set(saved["params"])
    for key, value in {**saved["params"], **saved["batch_stats"]}.items():
        np.testing.assert_array_equal(value.numpy(), flat[key])


def test_latest_checkpoint_numeric_and_finished_only(tmp_path):
    for name in ("step_00000009", "step_00000010", "step_100000000",
                 "step_00000011.tmp-123", "step_12", "other"):
        (tmp_path / name).mkdir()
    assert st.latest_checkpoint(str(tmp_path)).endswith("step_100000000")
    assert st.latest_checkpoint(str(tmp_path / "missing")) is None


def test_async_save_lands_before_latest(tmp_path):
    """A save returns before its write; ``latest_checkpoint`` and
    ``restore_checkpoint`` wait for the write in flight, and a save waits
    for the previous one (one write in flight)."""
    state = port_state(port_model())
    ckpt = str(tmp_path / "ckpt")
    for step in (1, 2, 3):
        state.step = step
        st.save_checkpoint(ckpt, state, step)
    path = st.latest_checkpoint(ckpt)
    assert path.endswith("step_00000003")
    assert sorted(os.listdir(ckpt)) == ["step_00000001", "step_00000002", "step_00000003"]
    assert st.restore_checkpoint(path, port_state(port_model())).step == 3


def test_failed_write_raises_at_the_next_wait(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("")
    st.save_checkpoint(str(blocker), port_state(port_model()), 1)  # ckpt_dir is a file
    with pytest.raises(OSError):
        st.latest_checkpoint(str(tmp_path))
    assert st.latest_checkpoint(str(tmp_path)) is None  # the error is raised once


# ------------------------------------------------------------------- .npz


def test_npz_port_to_jax(tmp_path):
    model = _steps(port_state(port_model()), port_step(),
                   tuple(torch.from_numpy(a) for a in make_batch(np.random.default_rng(2))),
                   1).model
    path = str(tmp_path / "w.npz")
    st.save_weights_npz(path, model)
    params, batch_stats = jax_load_npz(path)
    got = flat_of_jax(params, batch_stats)
    want = to_flat(model)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_npz_jax_to_port(tmp_path):
    _, step = jax_step()
    state = jax_state(seeded_flat(port_model(), 4))
    images, boxes, ids = make_batch(np.random.default_rng(3))
    state, _ = step(state, jnp.asarray(images), jnp.asarray(boxes), jnp.asarray(ids))
    path = str(tmp_path / "j.npz")
    jax_save_npz(path, state.params, state.batch_stats)
    model = port_model()
    load_flat(model, st.load_weights_npz(path))
    want = flat_of_jax(state.params, state.batch_stats)
    for key, value in to_flat(model).items():
        np.testing.assert_array_equal(value, want[key], err_msg=key)


def test_npz_weights_roundtrip(tmp_path):
    """``tests/integration/test_checkpoint.py:97`` on the port."""
    model = port_model(seed=6)
    path = str(tmp_path / "w.npz")
    st.save_weights_npz(path, model)
    flat = st.load_weights_npz(path)
    for key, value in to_flat(model).items():
        np.testing.assert_array_equal(flat[key], value)
    assert any(k.startswith("params/") for k in flat)
    assert any(k.startswith("batch_stats/") for k in flat)


# ------------------------------------------------------------------ mixup


def test_mixup_blends_and_concats():
    """``tests/unit/test_mixup.py`` on the port."""
    rng = np.random.default_rng(0)
    b, m = 4, 3
    images = rng.uniform(0, 1, (b, 16, 16, 3)).astype(np.float32)
    boxes = rng.uniform(0, 16, (b, m, 4)).astype(np.float32)
    ids = rng.integers(0, 3, (b, m)).astype(np.int32)
    ids[:, -1] = -1
    mixed, boxes2, ids2, w = mixup_batch(images, boxes, ids, rng)
    assert mixed.shape == images.shape
    assert boxes2.shape == (b, 2 * m, 4) and ids2.shape == (b, 2 * m) and w.shape == (b, 2 * m)
    assert np.all(w[ids2 < 0] == 0.0)
    valid_w = w[ids2 >= 0]
    assert np.all((valid_w > 0.0) & (valid_w <= 1.0))
    for i in range(b):
        first = w[i, :m][ids2[i, :m] >= 0]
        second = w[i, m:][ids2[i, m:] >= 0]
        if len(first) and len(second):
            np.testing.assert_allclose(first[0] + second[0], 1.0, atol=1e-6)
    assert mixed.min() >= images.min() - 1e-6
    assert mixed.max() <= images.max() + 1e-6


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_mixup_equals_jax(dtype):
    rng = np.random.default_rng(8)
    images = (rng.uniform(0, 255, (6, 2, 8, 8, 3))).astype(dtype)  # clips too
    boxes = rng.uniform(0, 8, (6, 5, 4)).astype(np.float32)
    ids = rng.integers(-1, 3, (6, 5)).astype(np.int32)
    got = mixup_batch(images, boxes, ids, np.random.default_rng(1))
    want = jax_mixup_batch(images, boxes, ids, np.random.default_rng(1))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
