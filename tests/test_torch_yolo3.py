"""The port's YOLOv3 against the JAX package: tail, head and end to end.

Tolerances: the tail on identical float32 inputs holds ids exact, scores
within 1e-6 and boxes within 1e-4 (XLA's and PyTorch's CPU sigmoid and exp
differ by an ulp or two).  The tiny end-to-end run holds the golden
tolerances of tests/integration/test_golden.py:84-96 (ids exact, scores
1e-5, boxes 1e-3): convolutions sum in another order in the two
frameworks.  The full-width run holds boxes at 1e-2 px (see its test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.integration.test_golden import (
    FIXTURE,
    FLAGSHIP_FIXTURE,
    compute_detections,
    compute_flagship_detections,
)
from viddet_tpu.core.precision import DEFAULT_POLICY as JAX_BF16
from viddet_tpu.core.precision import FLOAT32_POLICY
from viddet_tpu.models import yolo3 as jax_yolo3
from viddet_tpu.train.state import _flatten
from viddet_tpu_torch.core.precision import DEFAULT_POLICY as TORCH_BF16
from viddet_tpu_torch.core.precision import FLOAT32_POLICY as TORCH_F32
from viddet_tpu_torch.models import yolo3 as torch_yolo3
from viddet_tpu_torch.models.zoo import get_model
from viddet_tpu_torch.ops.nms import multiclass_nms_late_decode_cells
from viddet_tpu_torch.weights import load_flat

# ------------------------------------------------------------------ tail


def _tail_inputs(data: str, b=2, size=128, num_classes=80):
    anchors, strides = jax_yolo3.ANCHORS_DARKNET53, jax_yolo3.STRIDES_DARKNET53
    rng = np.random.default_rng(21)
    meta, cells = [], []
    for anc, st in zip(anchors, strides):
        w = size // st
        meta.append((w * w, w, st, tuple((float(a), float(h)) for a, h in anc)))
        x = rng.normal(0, 2, size=(b, w * w, len(anc) * (5 + num_classes))).astype(np.float32)
        if data == "ties":  # coarse levels: many exact score ties
            x = np.round(x * 2) / 2
        cells.append(x)
    return tuple(meta), cells


def _jax_outputs(meta, cells):
    b, na = cells[0].shape[0], len(meta[0][3])
    raw = jnp.concatenate([jnp.asarray(c).reshape(b, -1, c.shape[-1] // na) for c in cells], 1)
    consts = [jax_yolo3._scale_constants(m[0] // m[1], m[1], m[3], m[2]) for m in meta]
    return {
        "raw_xy": raw[..., 0:2], "raw_wh": raw[..., 2:4], "raw_obj": raw[..., 4:5],
        "raw_cls": raw[..., 5:], "cls_max": jnp.max(raw[..., 5:], axis=-1),
        "grid_xy": jnp.concatenate([c[0] for c in consts]),
        "anchors": jnp.concatenate([c[1] for c in consts]),
        "strides": jnp.concatenate([c[2] for c in consts]),
    }


def _assert_dets(got, want, score_atol, box_atol):
    ids, scores, boxes = (np.asarray(t) for t in got)
    w_ids, w_scores, w_boxes = (np.asarray(t) for t in want)
    np.testing.assert_array_equal(ids, w_ids)
    np.testing.assert_allclose(scores, w_scores, rtol=0, atol=score_atol)
    np.testing.assert_allclose(boxes, w_boxes, rtol=0, atol=box_atol)


@pytest.mark.parametrize("entry", ["cells", "flat"])
@pytest.mark.parametrize("data", ["random", "ties"])
def test_tail_matches_xla_oracle(entry, data):
    meta, cells = _tail_inputs(data)
    want = jax_yolo3.postprocess(_jax_outputs(meta, cells), jax_yolo3.NMSConfig(backend="xla"))
    tcells = tuple(torch.from_numpy(c) for c in cells)
    if entry == "cells":
        got = multiclass_nms_late_decode_cells(tcells, meta)
    else:
        flat = torch_yolo3.flatten_outputs({"raws_cells": tcells, "meta": meta})
        got = torch_yolo3.postprocess(flat, torch_yolo3.NMSConfig())
    assert int((np.asarray(want[0]) >= 0).sum()) > 50  # a real workload
    _assert_dets(got, want, 1e-6, 1e-4)


def test_tail_backends_agree_on_cpu():
    meta, cells = _tail_inputs("random", num_classes=4)
    tcells = tuple(torch.from_numpy(c) for c in cells)
    auto = multiclass_nms_late_decode_cells(tcells, meta, topk=64, post_nms=16)
    plain = multiclass_nms_late_decode_cells(tcells, meta, topk=64, post_nms=16,
                                             backend="plain")
    assert all(torch.equal(a, b) for a, b in zip(auto, plain))
    with pytest.raises(ValueError):
        multiclass_nms_late_decode_cells(tcells, meta, backend="cuda")
    with pytest.raises(ValueError):
        multiclass_nms_late_decode_cells(tcells, meta, backend="xla")


# ------------------------------------------------------------ head, e2e


def _golden_setup(jax_policy=FLOAT32_POLICY, torch_policy=TORCH_F32):
    """The golden recipe (tests/integration/test_golden.py:34-44)."""
    module = jax_yolo3.YOLOv3(num_classes=4, backbone="tiny", policy=jax_policy)
    x = np.random.default_rng(1234).uniform(-1, 1, (2, 96, 96, 3)).astype(np.float32)
    variables = module.init(jax.random.key(99), jnp.asarray(x), train=False)
    flat = _flatten({"params": variables["params"]})
    flat.update(_flatten({"batch_stats": variables["batch_stats"]}))
    model = torch_yolo3.YOLOv3(num_classes=4, backbone="tiny", policy=torch_policy)
    model = model.to(memory_format=torch.channels_last).eval()
    load_flat(model, flat)
    return module, variables, model, x


@pytest.fixture(scope="module")
def golden():
    return _golden_setup()


def test_head_matches_jax_float32(golden):
    """Raw head outputs of the tiny model in float32, within atol 1e-5: the
    outputs are below 0.5 in magnitude and a dozen conv layers summed in
    another order leave them about 1e-6 apart."""
    module, variables, model, x = golden
    want = module.apply(variables, jnp.asarray(x), train=False)["raws_cells"]
    with torch.inference_mode():
        out = model(torch.from_numpy(x))
    for got, w in zip(out["raws_cells"], want):
        assert tuple(got.shape) == w.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=0, atol=1e-5)
    assert [m[:3] for m in out["meta"]] == [(9, 3, 32), (36, 6, 16)]


def test_head_matches_jax_bfloat16():
    """The default bf16 policy: head outputs come out in bf16 and within two
    bf16 roundings (2 * 2^-7 relative) of the largest reference value.  The
    frameworks round conv outputs, BatchNorm and leaky ReLU at different
    points (Flax multiplies by bf16(0.1), PyTorch by 0.1 in float32), so
    elements land a rounding apart and the next layers carry it; one
    rounding at the largest magnitude was measured."""
    module, variables, model, x = _golden_setup(JAX_BF16, TORCH_BF16)
    want = module.apply(variables, jnp.asarray(x), train=False)["raws_cells"]
    with torch.inference_mode():
        out = model(torch.from_numpy(x))
    for got, w in zip(out["raws_cells"], want):
        assert got.dtype == torch.bfloat16
        w = np.asarray(w).astype(np.float32)
        np.testing.assert_allclose(got.float().numpy(), w, rtol=0,
                                   atol=2 * 2.0**-7 * np.abs(w).max())


def _assert_ref_scores_separated(ids, scores):
    """A failure must show a real difference, not a near-tie."""
    for row_ids, row in zip(ids, scores):
        kept = row[row_ids >= 0]
        assert len(kept) > 0 and np.all(-np.diff(kept) > 1e-5)


def test_golden_recipe_matches_fixture_and_live_jax(golden):
    _, _, model, x = golden
    nms = torch_yolo3.NMSConfig(topk=64, post_nms=16, valid_thresh=0.001)
    with torch.inference_mode():
        got = torch_yolo3.forward_and_postprocess(model, torch.from_numpy(x), nms)
    with np.load(FIXTURE) as data:
        fixture = (data["ids"], data["scores"], data["boxes"])
    _assert_ref_scores_separated(fixture[0], fixture[1])
    _assert_dets(got, fixture, 1e-5, 1e-3)
    live = compute_detections()
    _assert_ref_scores_separated(live[0], live[1])
    _assert_dets(got, live, 1e-5, 1e-3)


@pytest.mark.slow
def test_flagship_darknet53_416_matches_golden_and_live_jax():
    """The flagship recipe (tests/integration/test_golden.py:56-69) at full
    width: Darknet-53, 416 px, float32, default NMS geometry.

    Ids exact and scores within 1e-5, as in the tiny recipe.  Boxes are
    held at 1e-2 px, not 1e-3: after 75 conv layers summed in another
    order the raw head outputs sit up to 3.5e-5 apart (measured), and the
    decode's half size 0.5 * exp(wh) * anchor (up to about 300 px here)
    moves both corners of a box by that times the half size, 6e-3 px
    measured."""
    from viddet_tpu.models import get_model as jax_get_model

    module, _ = jax_get_model("yolo3_darknet53_coco", policy=FLOAT32_POLICY)
    x = np.random.default_rng(77).uniform(0, 1, (1, 416, 416, 3)).astype(np.float32)
    variables = module.init(jax.random.key(7), jnp.asarray(x), train=False)
    flat = _flatten({"params": variables["params"]})
    flat.update(_flatten({"batch_stats": variables["batch_stats"]}))
    model, _ = get_model("yolo3_darknet53_coco", device="cpu", policy=TORCH_F32)
    load_flat(model, flat)
    with torch.inference_mode():
        got = torch_yolo3.forward_and_postprocess(
            model, torch.from_numpy(x), torch_yolo3.NMSConfig(valid_thresh=0.001))
    with np.load(FLAGSHIP_FIXTURE) as data:
        fixture = (data["ids"], data["scores"], data["boxes"])
    _assert_ref_scores_separated(fixture[0], fixture[1])
    for want in (fixture, compute_flagship_detections("xla")):
        _assert_dets(got, want, 1e-5, 1e-2)
