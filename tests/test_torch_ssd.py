"""SSD-512 ResNet-50 and the dense NMS entry points: the port against JAX.

The anchors are numpy constants and equal JAX's bit for bit.  The box
decode is held within rtol 1e-6 / atol 1e-4 px, as Faster R-CNN's
(``tests/test_torch_frcnn.py``): PyTorch's CPU exp and XLA's differ by an
ulp on some inputs, and XLA's jitted decode already differs from its eager
one on about a tenth of the elements here.  A shallow SSD (one bottleneck a
stage, widths 8..64, 128 px, float32) against live JAX holds ids exact,
scores 1e-6 and boxes 1e-4 px.  The three NMS entry points against JAX's
``backend="xla"`` chain hold ids exact (both sides rank exactly, ties
lowest index first), scores 1e-6 and boxes 1e-4.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.integration.test_golden import SSD_FIXTURE, compute_ssd_detections
from viddet_tpu.core.precision import FLOAT32_POLICY
from viddet_tpu.models import ssd as JS
from viddet_tpu.ops import nms as jax_nms
from viddet_tpu.train.state import _flatten
from viddet_tpu_torch.cli.common import make_predictor
from viddet_tpu_torch.core.precision import FLOAT32_POLICY as TORCH_F32
from viddet_tpu_torch.models import ssd as TS
from viddet_tpu_torch.models.yolo3 import NMSConfig
from viddet_tpu_torch.models.zoo import get_model
from viddet_tpu_torch.ops import nms as torch_nms
from viddet_tpu_torch.ops import topk_cuda as topk_ops
from viddet_tpu_torch.weights import init_flat, load_flat

SHALLOW = dict(backbone_blocks=(1, 1, 1, 1), backbone_widths=(8, 16, 32, 64))
IMAGE, NUM_CLASSES = 128, 4
NMS = dict(topk=128, post_nms=32, valid_thresh=0.001)


def _flat(variables):
    flat = _flatten({"params": variables["params"]})
    flat.update(_flatten({"batch_stats": variables["batch_stats"]}))
    return flat


def _assert_dets(got, want, score_atol=1e-6, box_atol=1e-4):
    ids, scores, boxes = (np.asarray(t) for t in got)
    np.testing.assert_array_equal(ids, np.asarray(want[0]))
    np.testing.assert_allclose(scores, np.asarray(want[1]), rtol=0, atol=score_atol)
    np.testing.assert_allclose(boxes, np.asarray(want[2]), rtol=0, atol=box_atol)


@pytest.mark.parametrize("size", [256, 512, 300])
def test_anchors_equal_jax(size):
    got = TS.generate_ssd_anchors(size)
    np.testing.assert_array_equal(got, JS.generate_ssd_anchors(size))
    assert got.dtype == np.float32
    if size == 512:  # 64^2*4 + 32^2*6 + 16^2*6 + 8^2*6 + 4^2*6 + 2^2*4 + 1*4
        assert got.shape == (24564, 4)


def test_decode_matches_jax():
    rng = np.random.default_rng(0)
    anchors = JS.generate_ssd_anchors(128)
    deltas = rng.normal(0, 3, (2, anchors.shape[0], 4)).astype(np.float32)
    deltas[0, :4, 2:] = [[100.0, -100.0], [60.0, 60.0], [0.0, 0.0], [-70.0, 3.0]]  # clipped
    want = np.asarray(JS.decode_ssd_boxes(jnp.asarray(deltas), jnp.asarray(anchors)))
    got = TS.decode_ssd_boxes(torch.from_numpy(deltas), torch.from_numpy(anchors))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-4)


@functools.lru_cache(maxsize=None)
def _shallow():
    """One JAX init of the shallow SSD, its flat weights, two images and
    JAX's outputs and detections."""
    x = np.random.default_rng(5).uniform(0, 1, (2, IMAGE, IMAGE, 3)).astype(np.float32)
    module = JS.SSD(num_classes=NUM_CLASSES, image_size=IMAGE, policy=FLOAT32_POLICY, **SHALLOW)
    variables = jax.jit(lambda: module.init(jax.random.key(0), jnp.asarray(x), train=False))()
    out = jax.jit(lambda v, im: module.apply(v, im, train=False))(variables, jnp.asarray(x))
    dets = JS.ssd_forward_and_postprocess(module, variables, jnp.asarray(x),
                                          JS.SSDNMSConfig(backend="xla", **NMS))
    return (_flat(variables), x, {k: np.asarray(v) for k, v in out.items()},
            [np.asarray(d) for d in dets])


def _port_model(flat):
    model = TS.SSD(NUM_CLASSES, IMAGE, TORCH_F32, **SHALLOW)
    model = model.to(memory_format=torch.channels_last).eval()
    load_flat(model, flat)
    return model


def test_shallow_ssd_matches_jax():
    flat, x, want_out, want = _shallow()
    model = _port_model(flat)
    with torch.inference_mode():
        out = model(torch.from_numpy(x))
        got = TS.ssd_forward_and_postprocess(model, torch.from_numpy(x), TS.SSDNMSConfig(**NMS))
    assert out["cls_logits"].shape == (2, 1542, NUM_CLASSES + 1)
    np.testing.assert_array_equal(out["anchors"].numpy(), want_out["anchors"])
    for key in ("cls_logits", "box_deltas"):
        np.testing.assert_allclose(out[key].numpy(), want_out[key], rtol=0, atol=1e-5)
    assert (want[0] >= 0).sum() > 20
    _assert_dets(got, want)


def test_make_predictor_dispatches_ssd_and_serves_uint8():
    """``make_predictor`` runs an SSD through the dense two-stage tail; its
    plain backend gives the same detections on the CPU."""
    flat, x, _, want = _shallow()
    model = _port_model(flat)
    got = make_predictor(model, NMSConfig(**NMS))(torch.from_numpy(x))
    _assert_dets(got, want)
    frames = torch.from_numpy((x * 255).round().astype(np.uint8))
    auto = make_predictor(model)(frames)
    plain = make_predictor(model, NMSConfig(backend="plain"))(frames)
    assert all(torch.equal(a, b) for a, b in zip(auto, plain))
    assert auto[0].shape == (2, 100)


def _nms_inputs(data, b=2, n=300, c=6, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 200, (b, n, 2, 2)).astype(np.float32)
    boxes = np.concatenate([pts.min(2), pts.max(2) + 3.0], -1)
    scores = rng.uniform(0, 1, (b, n, c)).astype(np.float32)
    logits = rng.normal(0, 2, (b, n, c + 1)).astype(np.float32)
    if data == "ties":  # coarse levels: many exact ties within and across rows
        scores = np.round(scores * 8) / 8
        logits = np.round(logits * 2) / 2
        boxes[:, n // 2:] = boxes[:, : n - n // 2]
    return boxes, scores, logits


@pytest.mark.parametrize("topk", [64, 2000])
@pytest.mark.parametrize("data", ["random", "ties"])
@pytest.mark.parametrize("entry", ["dense_two_stage", "multiclass_nms", "from_logits"])
def test_nms_entry_points_match_jax(entry, data, topk):
    """topk 2000 exceeds the anchor count (and k*C for two-stage), so the
    pair ranking is padded to topk as JAX pads it."""
    boxes, scores, logits = _nms_inputs(data)
    kw = dict(iou_thresh=0.45, valid_thresh=0.05, topk=topk, post_nms=40)
    tb, ts, tl = (torch.from_numpy(a) for a in (boxes, scores, logits))
    jb, js, jl = (jnp.asarray(a) for a in (boxes, scores, logits))
    if entry == "dense_two_stage":
        want = jax_nms.multiclass_nms_dense_two_stage(jb, js, backend="xla", **kw)
        port = functools.partial(torch_nms.multiclass_nms_dense_two_stage, tb, ts)
    elif entry == "multiclass_nms":
        want = jax_nms.multiclass_nms(jb, js, **kw)
        port = functools.partial(torch_nms.multiclass_nms, tb, ts)
    else:
        want = jax_nms.multiclass_nms_from_logits(jb, jl[..., :1], jl[..., 1:], backend="xla",
                                                  **kw)
        port = functools.partial(torch_nms.multiclass_nms_from_logits, tb, tl[..., :1],
                                 tl[..., 1:])
    got = port(**kw)
    assert int((np.asarray(want[0]) >= 0).sum()) > 20
    _assert_dets(got, want)
    assert all(torch.equal(a, b) for a, b in zip(got, port(backend="plain", **kw)))


@pytest.mark.parametrize("data", ["random", "ties"])
@pytest.mark.parametrize("entry,n,c", [("multiclass_nms", 1000, 80),  # N*C = 80,000
                                       ("dense_two_stage", 60000, 2),  # N = 60,000
                                       ("from_logits", 60000, 2)])
def test_nms_entry_points_past_k2_width_match_jax(entry, n, c, data):
    """A ranking wider than K2's MAX_N (57,344) is ranked in slices and
    once more over their winners: still exactly JAX's lax.top_k, ties
    lowest index first."""
    assert (n * c if entry == "multiclass_nms" else n) > topk_ops.MAX_N
    boxes, scores, logits = _nms_inputs(data, b=2, n=n, c=c, seed=1)
    kw = dict(iou_thresh=0.45, valid_thresh=0.05, topk=400, post_nms=100)
    tb, ts, tl = (torch.from_numpy(a) for a in (boxes, scores, logits))
    jb, js, jl = (jnp.asarray(a) for a in (boxes, scores, logits))
    if entry == "dense_two_stage":
        want = jax_nms.multiclass_nms_dense_two_stage(jb, js, backend="xla", **kw)
        got = torch_nms.multiclass_nms_dense_two_stage(tb, ts, **kw)
    elif entry == "multiclass_nms":
        want = jax_nms.multiclass_nms(jb, js, **kw)
        got = torch_nms.multiclass_nms(tb, ts, **kw)
    else:
        want = jax_nms.multiclass_nms_from_logits(jb, jl[..., :1], jl[..., 1:], backend="xla",
                                                  **kw)
        got = torch_nms.multiclass_nms_from_logits(tb, tl[..., :1], tl[..., 1:], **kw)
    assert int((np.asarray(want[0]) >= 0).sum()) > 20
    _assert_dets(got, want)


@pytest.mark.parametrize("width,k", [(7, 1), (7, 6), (64, 1), (64, 6), (64, 50), (100, 50),
                                     (100, 99)])
def test_sliced_ranking_equals_the_whole_row(monkeypatch, width, k):
    """The sliced ranking (``_top_k_set``) at a small MAX_N (k < MAX_N), on
    tie-heavy rows, equals the one-pass ranking; with 333 columns the last
    slice is narrower than k in some cases, and the slices' winners are
    more than MAX_N in others, so they are ranked in slices again."""
    rng = np.random.default_rng(width * 100 + k)
    x = torch.from_numpy(np.round(rng.uniform(0, 1, (3, 333)) * 5).astype(np.float32) / 5)
    x[1] = 0.5  # one value throughout
    want = torch_nms._pair_top_k_det(x, k, topk_ops.topk_indices_plain)
    monkeypatch.setattr(topk_ops, "MAX_N", width)
    calls = []

    def counted(scores, kk):
        calls.append(scores.shape[1])
        return topk_ops.topk_indices_plain(scores, kk)

    got = torch_nms._pair_top_k_det(x, k, counted)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert len(calls) > 1 and max(calls) <= width


def test_zoo_builds_the_full_ssd_on_the_meta_device():
    with torch.device("meta"):
        model = TS.SSD(80)
    assert [len(s) for s in model.backbone.stages] == [3, 4, 6, 3]
    assert model.cls_preds[0].weight.shape == (4 * 81, 512, 3, 3)
    assert model.box_preds[1].weight.shape == (6 * 4, 1024, 3, 3)
    model, classes = get_model("ssd_512_resnet50_voc", device="cpu", **SHALLOW)
    assert len(classes) == 20 and isinstance(model, TS.SSD)
    flat = init_flat("ssd_512_resnet50_coco", seed=0)
    assert flat["params/cls_pred_6/kernel"].shape == (3, 3, 256, 4 * 81)
    assert flat["params/_ConvBN_7/Conv_0/kernel"].shape == (3, 3, 128, 256)


@pytest.mark.slow
def test_full_depth_reproduces_the_golden_fixture():
    """The golden recipe (tests/integration/test_golden.py:105-118): full
    ResNet-50 SSD at 256 px in float32, JAX's init, topk 128, post 32.

    Ids exact and boxes within the fixture's 1e-4 px (9.2e-5 measured), but
    scores within 2.5e-6, not the fixture's 1e-6 (1.25e-6 measured): after
    about 60 conv layers summed in another order the raw logits sit up to
    7.5e-6 apart, and the softmax carries a part of that into the scores.
    The fixture pins XLA's summation order (ROADMAP.md, Queue 3)."""
    module = JS.SSD(num_classes=4, image_size=256, policy=FLOAT32_POLICY)
    x = np.random.default_rng(55).uniform(0, 1, (1, 256, 256, 3)).astype(np.float32)
    variables = module.init(jax.random.key(3), jnp.asarray(x), train=False)
    model = TS.SSD(4, 256, TORCH_F32).to(memory_format=torch.channels_last).eval()
    load_flat(model, _flat(variables))
    with torch.inference_mode():
        got = TS.ssd_forward_and_postprocess(
            model, torch.from_numpy(x), TS.SSDNMSConfig(topk=128, post_nms=32,
                                                        valid_thresh=0.001))
    with np.load(SSD_FIXTURE) as data:
        fixture = (data["ids"], data["scores"], data["boxes"])
    for want in (fixture, compute_ssd_detections()):
        _assert_dets(got, want, score_atol=2.5e-6, box_atol=1e-4)
