"""Shared pieces of the SSD and Faster R-CNN training tests: the shallow
models of ``tests/unit/test_ssd.py`` / ``test_faster_rcnn.py`` (one
bottleneck a stage, widths 8..64) in both packages on the same seeded
weights, the batches, JAX's jitted steps (one compile each, cached) and
the recording of JAX's roi and RPN sampling draws.

JAX's Faster R-CNN samples inside the Flax module from ``make_rng``; its
draws are recorded rather than re-derived from Flax's key:
``recording_draws`` wraps the module's ``sample_rois`` and
``assign_rpn_targets`` while a step runs, and a ``jax.debug.callback``
hands each run's uniforms, proposals and sampling results to the host.
The uniforms are drawn as JAX's functions draw them (``jax.random.split``
per image, then per sampler), and ``test_torch_frcnn_train.py`` checks
that they reproduce JAX's own selection.  While recording, the module's
``_random_topk_select`` draws float32 uniforms under x64 too (in float32
it is JAX's own), so a float64-compute run samples as the float32 run.
Nothing in ``viddet_tpu`` changes: the wrappers are removed after each
call.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_train_helpers import flat_of_jax, jax_state, leaf_gaps, port_state  # noqa: F401
from viddet_tpu.core.precision import FLOAT32_POLICY
from viddet_tpu.core.precision import Policy as JaxPolicy
from viddet_tpu.models import faster_rcnn as JF
from viddet_tpu.models import ssd as JS
from viddet_tpu.train.loop import make_frcnn_train_step as jax_frcnn_step
from viddet_tpu.train.loop import make_ssd_train_step as jax_ssd_step
from viddet_tpu_torch.core.precision import FLOAT32_POLICY as TORCH_F32
from viddet_tpu_torch.core.precision import Policy as TorchPolicy
from viddet_tpu_torch.models import faster_rcnn as TF
from viddet_tpu_torch.models import ssd as TS
from viddet_tpu_torch.weights import load_flat, seeded_flat

@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each test on one torch thread, restored after: the port's CPU
    rounding then does not depend on the machine's core count (the float32
    gaps below were measured so), and the test workers, several to the
    machine, do not oversubscribe its cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SHALLOW = dict(backbone_blocks=(1, 1, 1, 1), backbone_widths=(8, 16, 32, 64))
# tests/unit/test_faster_rcnn.py's TINY_CFG counts
COUNTS = dict(rpn_pre_nms_topk=64, rpn_nms_input=128, rpn_post_nms_train=64,
              rpn_post_nms_test=32, rpn_batch=64, roi_batch=64)
NUM_CLASSES, SSD_SIZE, FRCNN_SIZE = 3, 64, 128
SSD_LOSSES = ("cls", "box", "total", "npos")
FRCNN_LOSSES = ("rpn_cls", "rpn_box", "cls", "box", "total")


# float64 compute (parameters, activations, BatchNorm) with the models' own
# float32 casts: the steps' semantics apart from float32 rounding
JAX_F64 = JaxPolicy(param_dtype=jnp.float64, compute_dtype=jnp.float64)
TORCH_F64 = TorchPolicy(torch.float64)


def ssd_model(seed=0, device="cpu", f64=False, num_classes=NUM_CLASSES):
    model = TS.SSD(num_classes, SSD_SIZE, TORCH_F64 if f64 else TORCH_F32, **SHALLOW)
    return _placed(model, seed, device, f64)


def frcnn_model(seed=0, device="cpu", f64=False, num_classes=NUM_CLASSES, **cfg):
    model = TF.FasterRCNN(num_classes, TF.FRCNNConfig(**{**COUNTS, **cfg}),
                          TORCH_F64 if f64 else TORCH_F32, **SHALLOW)
    return _placed(model, seed, device, f64)


def _placed(model, seed, device, f64):
    model = model.to(device=device, dtype=torch.float64 if f64 else torch.float32,
                     memory_format=torch.channels_last)
    load_flat(model, seeded_flat(model, seed))
    return model.train()


@functools.lru_cache(maxsize=None)
def jax_ssd(f64=False):
    module = JS.SSD(num_classes=NUM_CLASSES, image_size=SSD_SIZE,
                    policy=JAX_F64 if f64 else FLOAT32_POLICY, **SHALLOW)
    return module, jax_ssd_step(module)


@functools.lru_cache(maxsize=None)
def jax_frcnn(f64=False):
    cfg = JF.FRCNNConfig(**COUNTS, nms_backend="auto")
    module = JF.FasterRCNN(num_classes=NUM_CLASSES, config=cfg,
                           policy=JAX_F64 if f64 else FLOAT32_POLICY, **SHALLOW)
    return module, jax_frcnn_step(module)


def jax_runs(family: str, batch, steps: int = 3, f64: bool = False, key_seed: int = 5,
             lr=1e-3, weight_decay=5e-4, momentum=0.9) -> dict:
    """JAX's jitted step ``steps`` times from ``seeded_flat(model, 0)`` on
    ``batch``: the losses of each step, the state after the last, and for
    Faster R-CNN each step's recorded draws (``RECORDED`` copies).  The
    step keys split from ``key(key_seed)``, as the CLI's do."""
    module, step = (jax_ssd if family == "ssd" else jax_frcnn)(f64)
    flat = seeded_flat((ssd_model if family == "ssd" else frcnn_model)(), 0)
    dtype = jnp.float64 if f64 else jnp.float32
    out = {"losses": [], "records": []}
    with jax.enable_x64(f64):
        js = jax_state({k: v.astype(dtype) for k, v in flat.items()}, lr, weight_decay, momentum)
        args = (jnp.asarray(batch[0], dtype), jnp.asarray(batch[1]), jnp.asarray(batch[2]))
        key = jax.random.key(key_seed)
        for _ in range(steps):
            if family == "ssd":
                js, losses = step(js, *args)
            else:
                key, sub = jax.random.split(key)
                with recording_draws():
                    js, losses = step(js, sub, *args)
                out["records"].append({k: list(v) for k, v in RECORDED.items()})
            out["losses"].append({k: float(v) for k, v in losses.items()})
        out["flat"] = flat_of_jax(js.params, js.batch_stats)
    return out


def make_batch(rng, size, batch=2, max_gt=4, collide=False):
    """Two boxes an image of random pixels; ``collide`` adds a third box one
    pixel off the first, which shares its best anchor."""
    images = rng.uniform(0, 1, size=(batch, size, size, 3)).astype(np.float32)
    s = size / 64.0
    gt_boxes = -np.ones((batch, max_gt, 4), np.float32)
    gt_ids = -np.ones((batch, max_gt), np.int32)
    gt_boxes[:, 0] = np.asarray([5, 6, 30, 40]) * s
    gt_ids[:, 0] = 0
    gt_boxes[:, 1] = np.asarray([30, 20, 60, 50]) * s
    gt_ids[:, 1] = 2
    if collide:
        gt_boxes[:, 2] = gt_boxes[:, 0] + [1, 0, 1, 0]
        gt_ids[:, 2] = 1
    return images, gt_boxes, gt_ids


def fixture_batch(family: str, seed: int = 11, batch: int = 2):
    """The fixtures' batch: float32 images in [0, 1) of 8x8-pixel blocks
    (a few KB compressed) and ``make_batch``'s boxes with the collision."""
    size = SSD_SIZE if family == "ssd" else FRCNN_SIZE
    rng = np.random.default_rng(seed)
    low = rng.uniform(0, 1, size=(batch, size // 8, size // 8, 3)).astype(np.float32)
    images = np.repeat(np.repeat(low, 8, axis=1), 8, axis=2)
    _, gt_boxes, gt_ids = make_batch(rng, size, batch=batch, collide=True)
    return images, gt_boxes, gt_ids


def jax_draws(key, batch: int, n: int) -> jnp.ndarray:
    """(B, 2, n) uniforms: ``_random_topk_select``'s positive and negative
    draws of each image, split from ``key`` as ``sample_rois`` and
    ``assign_rpn_targets`` split it."""

    def one(k):
        kp, kn = jax.random.split(k)
        return jnp.stack([jax.random.uniform(kp, (n,), jnp.float32),
                          jax.random.uniform(kn, (n,), jnp.float32)])

    return jax.vmap(one)(jax.random.split(key, batch))


RECORDED: dict = {}


def _random_topk_select_f32(rng, eligible, k):
    """``faster_rcnn._random_topk_select`` drawing float32 uniforms under
    x64 too, so a float64 run samples as the float32 run does."""
    priority = jax.random.uniform(rng, (eligible.shape[0],), jnp.float32) + (~eligible) * 10.0
    return eligible & (jnp.argsort(jnp.argsort(priority)) < k)


@contextlib.contextmanager
def recording_draws():
    """While active, a JAX Faster R-CNN traced here records into
    ``RECORDED`` at each run: "roi" = (uniforms, proposals, their validity,
    rois, cls targets, box targets, mask), "rpn" = (uniforms, labels, box
    targets)."""
    sample, assign = JF.sample_rois, JF.assign_rpn_targets

    def put(name):
        return lambda *a: RECORDED.__setitem__(name, [np.array(v) for v in a])

    def sample_rois(key, proposals, p_valid, gt_boxes, gt_ids, cfg):
        u = jax_draws(key, proposals.shape[0], proposals.shape[1] + gt_boxes.shape[1])
        out = sample(key, proposals, p_valid, gt_boxes, gt_ids, cfg)
        jax.debug.callback(put("roi"), u, proposals, p_valid, *out)
        return out

    def assign_rpn_targets(anchors, gt_boxes, gt_ids, cfg, key):
        u = jax_draws(key, gt_boxes.shape[0], anchors.shape[0])
        out = assign(anchors, gt_boxes, gt_ids, cfg, key)
        jax.debug.callback(put("rpn"), u, *out)
        return out

    select = JF._random_topk_select
    JF.sample_rois, JF.assign_rpn_targets = sample_rois, assign_rpn_targets
    JF._random_topk_select = _random_topk_select_f32
    try:
        yield RECORDED
    finally:
        JF.sample_rois, JF.assign_rpn_targets = sample, assign
        JF._random_topk_select = select
        jax.effects_barrier()


def summary(gaps: dict) -> dict:
    worst = max(gaps, key=gaps.get)
    return {"worst": worst, "max_rel_l2": gaps[worst],
            "median_rel_l2": float(np.median(list(gaps.values()))),
            "above_1e-5": sum(g > 1e-5 for g in gaps.values()), "leaves": len(gaps)}


def port_runs(family: str, batch, steps: int = 3, f64: bool = False, records=(),
              lr=1e-3, weight_decay=5e-4, momentum=0.9) -> dict:
    """The port's step as ``jax_runs`` runs JAX's; a Faster R-CNN step
    samples from the uniforms of ``records`` (JAX's draws, one per step)."""
    from viddet_tpu_torch.train import loop
    from viddet_tpu_torch.weights import to_flat

    model = (ssd_model if family == "ssd" else frcnn_model)(f64=f64)
    st = port_state(model, lr, weight_decay, momentum)
    images = torch.from_numpy(batch[0]).to(torch.float64 if f64 else torch.float32)
    boxes, ids = torch.from_numpy(batch[1]), torch.from_numpy(batch[2])
    out = {"losses": []}
    if family == "ssd":
        step = loop.make_ssd_train_step(model)
        for _ in range(steps):
            out["losses"].append({k: float(v) for k, v in step(st, images, boxes, ids)[1].items()})
    else:
        step = loop.make_frcnn_train_step(model)
        for rec in records[:steps]:
            uniforms = (torch.from_numpy(rec["roi"][0]), torch.from_numpy(rec["rpn"][0]))
            _, losses = step(st, None, images, boxes, ids, uniforms=uniforms)
            out["losses"].append({k: float(v) for k, v in losses.items()})
    out["flat"] = to_flat(model)
    out["model"] = model
    return out


def loss_gaps(got: list, want: list) -> list:
    """Each step's largest relative loss gap."""
    return [max(abs(g[k] / w[k] - 1) for k in w if w[k]) for g, w in zip(got, want)]
