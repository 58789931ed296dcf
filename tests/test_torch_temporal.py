"""Temporal k-frame YOLOv3: the port against the JAX package.

The tiny backbone at 64 px in float32 (as ``tests/unit/test_temporal.py:13``)
with VID's 30 classes, so that the hierarchical tail applies (C > 10).  The
same weights (JAX init -> ``.npz`` schema -> ``load_flat``) and the same
numpy clips go through both.  Head outputs are held within atol 1e-5, as
``tests/test_torch_yolo3.py``; detections at the golden tolerances (ids
exact, scores 1e-5, boxes 1e-3): under the deterministic ranking against
JAX's XLA chain, under the default hierarchical one against JAX's fused
tail with ``backend="pallas_interpret"``.  bf16 heads are held within one
bf16 rounding of the largest reference value, as the YOLOv3 bf16 test.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viddet_tpu.cli.common import make_predictor as jax_make_predictor
from viddet_tpu.core.precision import DEFAULT_POLICY as JAX_BF16
from viddet_tpu.core.precision import FLOAT32_POLICY
from viddet_tpu.models.temporal import TemporalYOLOv3 as JaxTemporal
from viddet_tpu.models.yolo3 import NMSConfig as JaxNMSConfig
from viddet_tpu.models.yolo3 import forward_and_postprocess as jax_forward_and_postprocess
from viddet_tpu.train.state import _flatten
from viddet_tpu_torch.cli.common import make_predictor
from viddet_tpu_torch.core.precision import DEFAULT_POLICY as TORCH_BF16
from viddet_tpu_torch.core.precision import FLOAT32_POLICY as TORCH_F32
from viddet_tpu_torch.models.temporal import TemporalYOLOv3
from viddet_tpu_torch.models.yolo3 import NMSConfig, forward_and_postprocess
from viddet_tpu_torch.models.zoo import get_model, temporal_yolo3_custom
from viddet_tpu_torch.weights import load_flat

AGGREGATIONS = ("stack", "max", "mean", "conv")
NUM_CLASSES, SIZE, B = 30, 64, 2
NMS = dict(topk=32, post_nms=8, valid_thresh=0.001)


def _clips(k, seed=3):
    return np.random.default_rng(seed).uniform(-1, 1, (B, k, SIZE, SIZE, 3)).astype(np.float32)


def _jax_dets(module, variables, x, nms):
    """JAX's forward_and_postprocess, jitted as its docstring asks."""
    return jax.jit(functools.partial(jax_forward_and_postprocess, module),
                   static_argnums=2)(variables, jnp.asarray(x), nms)


def _jax_heads(module, variables, x):
    return jax.jit(lambda v, im: module.apply(v, im, train=False))(
        variables, jnp.asarray(x))["raws_cells"]


@functools.lru_cache(maxsize=None)
def _setup(aggregation, k=3, bf16=False):
    """One JAX init per configuration: (module, variables, port model, clips)."""
    module = JaxTemporal(num_classes=NUM_CLASSES, k=k, backbone="tiny",
                         aggregation=aggregation, policy=JAX_BF16 if bf16 else FLOAT32_POLICY)
    x = _clips(k)
    variables = jax.jit(lambda: module.init(jax.random.key(k), jnp.asarray(x), train=False))()
    flat = _flatten({"params": variables["params"]})
    flat.update(_flatten({"batch_stats": variables["batch_stats"]}))
    model = TemporalYOLOv3(NUM_CLASSES, k, "tiny", aggregation,
                           policy=TORCH_BF16 if bf16 else TORCH_F32)
    model = model.to(memory_format=torch.channels_last).eval()
    load_flat(model, flat)
    return module, variables, model, x


def _assert_dets(got, want, score_atol=1e-5, box_atol=1e-3):
    ids, scores, boxes = (np.asarray(t) for t in got)
    np.testing.assert_array_equal(ids, np.asarray(want[0]))
    np.testing.assert_allclose(scores, np.asarray(want[1]), rtol=0, atol=score_atol)
    np.testing.assert_allclose(boxes, np.asarray(want[2]), rtol=0, atol=box_atol)


@pytest.mark.parametrize("aggregation", AGGREGATIONS)
def test_temporal_matches_jax(aggregation, monkeypatch):
    module, variables, model, x = _setup(aggregation)
    want = _jax_heads(module, variables, x)
    with torch.inference_mode():
        out = model(torch.from_numpy(x))
    for got, w in zip(out["raws_cells"], want):
        assert tuple(got.shape) == w.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=0, atol=1e-5)
    assert [m[:3] for m in out["meta"]] == [(4, 2, 32), (16, 4, 16)]

    # det: the XLA chain, bit for bit under ties
    want = _jax_dets(module, variables, x, JaxNMSConfig(backend="xla", **NMS))
    with torch.inference_mode():
        got = forward_and_postprocess(model, torch.from_numpy(x),
                                      NMSConfig(ranking="det", **NMS))
    assert int((np.asarray(want[0]) >= 0).sum()) > 4
    _assert_dets(got, want)

    # hier (the default): JAX's fused tail in interpret mode, stage 2 by lax.top_k
    monkeypatch.delenv("VIDDET_PAIR_TOPK", raising=False)
    jax.clear_caches()  # JAX reads VIDDET_PAIR_TOPK when it traces
    want = _jax_dets(module, variables, x, JaxNMSConfig(backend="pallas_interpret", **NMS))
    with torch.inference_mode():
        got = forward_and_postprocess(model, torch.from_numpy(x), NMSConfig(**NMS))
    _assert_dets(got, want)


@pytest.mark.parametrize("aggregation", ["max", "mean"])
def test_temporal_heads_match_jax_bfloat16(aggregation):
    """bf16 heads within one bf16 rounding (2^-7) of the largest reference
    value: the convolutions sum in another order before they round."""
    module, variables, model, x = _setup(aggregation, bf16=True)
    want = _jax_heads(module, variables, x)
    with torch.inference_mode():
        out = model(torch.from_numpy(x))
    for got, w in zip(out["raws_cells"], want):
        assert got.dtype == torch.bfloat16
        w = np.asarray(w).astype(np.float32)
        np.testing.assert_allclose(got.float().numpy(), w, rtol=0,
                                   atol=2.0**-7 * np.abs(w).max())


@pytest.mark.parametrize("k", [3, 5])
def test_stack_widens_the_stem_frame_major(k):
    module, variables, model, x = _setup("stack", k=k)
    assert model.backbone.cells[0].conv.weight.shape[1] == 3 * k
    want = _jax_heads(module, variables, x)
    with torch.inference_mode():
        out = model(torch.from_numpy(x))
    for got, w in zip(out["raws_cells"], want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=0, atol=1e-5)


def test_make_predictor_serves_uint8_clips():
    """uint8 (B, k, H, W, 3) clips, normalized on the device, against JAX's
    jitted predictor on the same clips (default NMS, XLA chain) and against
    the port's float path on the same normalized clips."""
    module, variables, model, _ = _setup("max")
    clips = np.random.default_rng(8).integers(0, 256, (B, 3, SIZE, SIZE, 3), dtype=np.uint8)
    nms = NMSConfig(ranking="det", valid_thresh=0.001)
    got = make_predictor(model, nms)(torch.from_numpy(clips))
    want = jax_make_predictor(module)(variables, jnp.asarray(clips))
    _assert_dets(got, want)
    mean = torch.tensor([0.485, 0.456, 0.406])
    std = torch.tensor([0.229, 0.224, 0.225])
    with torch.inference_mode():
        normed = (torch.from_numpy(clips).float() / 255.0 - mean) / std
        direct = forward_and_postprocess(model, normed, nms)
    assert all(torch.equal(a, b) for a, b in zip(got, direct))


def test_zoo_and_custom_temporal_models():
    model, classes = get_model("yolo3_tiny_darknet_k3_vid", device="cpu")
    assert len(classes) == 30 and isinstance(model, TemporalYOLOv3) and model.k == 3
    assert model.aggregation == "max"
    custom, names = temporal_yolo3_custom(("a", "b"), k=4, aggregation="conv", backbone="tiny")
    assert names == ("a", "b") and custom.k == 4 and len(custom.aggregators) == 2
    with pytest.raises(ValueError):
        TemporalYOLOv3(3, aggregation="sum")
    with pytest.raises(ValueError):
        model(torch.zeros((1, 2, SIZE, SIZE, 3)))
