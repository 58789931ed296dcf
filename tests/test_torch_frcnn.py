"""Faster R-CNN ResNet-50 FPN inference: the port against the JAX package.

The shallow model of ``tests/unit/test_faster_rcnn.py:101`` (one block a
stage, widths 8..64, the full FPN, RPN and box head) at 128 px in float32
with ``TINY_CFG``'s counts, one cached JAX init for the file.  The same
weights (JAX init -> ``.npz`` schema -> ``load_flat``) and the same numpy
inputs go through both; JAX runs under its "xla" backends (the packed
ROIAlign oracle, the jnp NMS) and under "pallas_interpret" (K5, K6 and K7
in interpret mode).  Detections are held at the golden tolerances: ids
exact, scores 1e-5, boxes 1e-3 px.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viddet_tpu.core.precision import FLOAT32_POLICY
from viddet_tpu.models import faster_rcnn as JF
from viddet_tpu.train.state import _flatten
from viddet_tpu_torch.cli.common import make_predictor
from viddet_tpu_torch.core.precision import FLOAT32_POLICY as TORCH_F32
from viddet_tpu_torch.models import faster_rcnn as TF
from viddet_tpu_torch.models.yolo3 import NMSConfig
from viddet_tpu_torch.models.zoo import get_model
from viddet_tpu_torch.weights import init_flat, load_flat, to_flat

COUNTS = dict(rpn_pre_nms_topk=64, rpn_nms_input=128, rpn_post_nms_train=64,
              rpn_post_nms_test=32, rpn_batch=64, roi_batch=64)  # TINY_CFG
SHALLOW = dict(backbone_blocks=(1, 1, 1, 1), backbone_widths=(8, 16, 32, 64))
POST = dict(topk=64, post_nms=16)  # the golden recipe's detection counts
IMAGE = 128


def _jax_module(backend="xla", num_classes=3, nms_thresh=0.7, **shape):
    cfg = JF.FRCNNConfig(nms_backend=backend, roi_backend=backend, rpn_nms_thresh=nms_thresh,
                         **COUNTS)
    return JF.FasterRCNN(num_classes=num_classes, config=cfg, policy=FLOAT32_POLICY, **shape)


def _flat(variables):
    flat = _flatten({"params": variables["params"]})
    flat.update(_flatten({"batch_stats": variables["batch_stats"]}))
    return flat


@functools.lru_cache(maxsize=None)
def _shallow():
    """One JAX init of the shallow model, its flat weights and two images."""
    x = np.random.default_rng(5).uniform(0, 1, (2, IMAGE, IMAGE, 3)).astype(np.float32)
    module = _jax_module(**SHALLOW)
    variables = jax.jit(lambda: module.init({"params": jax.random.key(0)},
                                            jnp.asarray(x[:1]), train=False))()
    return variables, _flat(variables), x


def _port_model(flat, **cfg):
    model = TF.FasterRCNN(3, TF.FRCNNConfig(**COUNTS, **cfg), TORCH_F32, **SHALLOW).eval()
    load_flat(model, flat)
    return model


@functools.lru_cache(maxsize=None)
def _jax_run(backend, nms_thresh=0.7):
    variables, _, x = _shallow()
    module = _jax_module(backend, nms_thresh=nms_thresh, **SHALLOW)
    out = jax.jit(lambda v, im: module.apply(v, im, train=False))(variables, jnp.asarray(x))
    dets = JF.frcnn_postprocess(out["proposals"], out["roi_cls_logits"], out["roi_box_deltas"],
                                jnp.asarray([IMAGE, IMAGE], jnp.float32), backend=backend,
                                **POST)
    return {k: np.asarray(v) for k, v in out.items()}, [np.asarray(d) for d in dets]


def _assert_detections(got, want):
    ids, scores, boxes = (t.numpy() for t in got)
    np.testing.assert_array_equal(ids, want[0])
    np.testing.assert_allclose(scores, want[1], rtol=0, atol=1e-5)
    np.testing.assert_allclose(boxes, want[2], rtol=0, atol=1e-3)


def test_decode_rcnn_and_level_anchors_match_jax():
    rng = np.random.default_rng(0)
    pts = rng.uniform(0, 300, (50, 2, 2)).astype(np.float32)
    anchors = np.concatenate([pts.min(1), pts.max(1) + 2.0], -1)
    deltas = rng.normal(0, 2, (50, 4)).astype(np.float32)
    deltas[:4, 2:] = [[30.0, -30.0], [-25.0, 25.0], [0.0, 0.0], [60.0, 60.0]]  # clipped at +-10
    for weights in ((1.0, 1.0, 1.0, 1.0), TF.HEAD_DELTA_WEIGHTS):
        want = np.asarray(JF.decode_rcnn(jnp.asarray(deltas), jnp.asarray(anchors), weights))
        got = TF.decode_rcnn(torch.from_numpy(deltas), torch.from_numpy(anchors), weights)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-4)
    for args in ((2, 3, 16, 64.0), (32, 32, 4, 32.0), (2, 2, 64, 512.0)):
        np.testing.assert_array_equal(TF._level_anchors(*args), JF._level_anchors(*args))


def test_weights_round_trip_byte_for_byte():
    _, flat, _ = _shallow()
    model = _port_model(flat)
    back = to_flat(model)
    assert sorted(back) == sorted(flat)
    for key, want in flat.items():
        assert back[key].dtype == want.dtype and back[key].tobytes() == want.tobytes(), key
    fc1 = flat["params/fc1/kernel"]
    np.testing.assert_array_equal(model.fc1.weight.detach().numpy(), fc1.T)
    bad = dict(flat)
    bad.pop("params/RPNHead_0/rpn_obj/bias")
    with pytest.raises(KeyError):
        load_flat(model, bad)


def test_init_flat_matches_jax_schema():
    module = JF.FasterRCNN(num_classes=80)
    shapes = jax.eval_shape(lambda: module.init({"params": jax.random.key(0)},
                                                jnp.zeros((1, 64, 64, 3)), train=False))
    want = _flat(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes))
    got = init_flat("faster_rcnn_resnet50_fpn_coco", seed=0)
    assert sorted(got) == sorted(want)
    for key, arr in got.items():
        assert arr.shape == want[key].shape and arr.dtype == np.float32, key
    kernel = got["params/fc1/kernel"]  # (12544, 1024) Dense: lecun-normal over fan_in
    assert abs(kernel.std() * np.sqrt(kernel.shape[0]) - 1.0) < 0.01


@pytest.mark.parametrize("nms_thresh", [0.7, 0.05])
@pytest.mark.parametrize("backend", ["xla", "pallas_interpret"])
def test_forward_matches_jax(backend, nms_thresh):
    """At IoU 0.05 proposal NMS keeps fewer than the 32 proposals: the
    unkept ones follow the kept ones, invalid, and still reach the head."""
    _, flat, x = _shallow()
    want, _ = _jax_run(backend, nms_thresh)
    with torch.inference_mode():
        model = _port_model(flat, rpn_nms_thresh=nms_thresh)
        got = {k: v.numpy() for k, v in model(torch.from_numpy(x)).items()}
    np.testing.assert_allclose(got["rpn_obj"], want["rpn_obj"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["rpn_delta"], want["rpn_delta"], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got["proposal_valid"], want["proposal_valid"])
    np.testing.assert_allclose(got["proposals"], want["proposals"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["roi_cls_logits"], want["roi_cls_logits"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["roi_box_deltas"], want["roi_box_deltas"], rtol=0, atol=1e-4)
    assert got["proposal_valid"].all() == (nms_thresh == 0.7)


@pytest.mark.parametrize("backend", ["xla", "pallas_interpret"])
def test_detections_match_jax(backend):
    _, flat, x = _shallow()
    _, want = _jax_run(backend)
    predictor = make_predictor(_port_model(flat), NMSConfig(iou_thresh=0.5, valid_thresh=0.05,
                                                            **POST))
    got = predictor(torch.from_numpy(x))
    assert (got[0] >= 0).any()
    _assert_detections(got, want)


def test_plain_backends_and_uint8_frames_agree():
    """``nms_backend`` / ``roi_backend`` "plain" give the wrappers' result on
    the CPU, and uint8 frames are normalized as the float path expects."""
    _, flat, x = _shallow()
    frames = (x * 255).round().astype(np.uint8)
    with torch.inference_mode():
        auto = make_predictor(_port_model(flat))(torch.from_numpy(frames))
        plain_model = _port_model(flat, nms_backend="plain", roi_backend="plain")
        mean = torch.tensor([0.485, 0.456, 0.406])
        std = torch.tensor([0.229, 0.224, 0.225])
        normed = (torch.from_numpy(frames).float() / 255.0 - mean) / std
        plain = TF.frcnn_forward_and_postprocess(plain_model, normed, backend="plain")
    assert all(torch.equal(a, b) for a, b in zip(auto, plain))


def test_tie_heavy_postprocess_matches_jax():
    """Rounded logits give exact probability ties within and across rows."""
    rng = np.random.default_rng(11)
    b, r, c = 2, 40, 5
    pts = rng.uniform(0, 120, (b, r, 2, 2)).astype(np.float32)
    proposals = np.concatenate([pts.min(2), pts.max(2) + 4.0], -1)
    proposals[:, 20:] = proposals[:, :20]  # repeated proposals
    logits = np.round(rng.normal(0, 1.5, (b, r, c + 1))).astype(np.float32)
    logits[:, 10:20] = logits[:, :10]
    deltas = np.round(rng.normal(0, 1, (b, r, c, 4)) * 4).astype(np.float32) / 4
    want = JF.frcnn_postprocess(jnp.asarray(proposals), jnp.asarray(logits), jnp.asarray(deltas),
                                jnp.asarray([IMAGE, IMAGE], jnp.float32), backend="xla",
                                valid_thresh=0.01, topk=100, post_nms=30)
    got = TF.frcnn_postprocess(torch.from_numpy(proposals), torch.from_numpy(logits),
                               torch.from_numpy(deltas), (IMAGE, IMAGE), valid_thresh=0.01,
                               topk=100, post_nms=30)
    _assert_detections(got, [np.asarray(w) for w in want])


def test_zoo_builds_the_full_model_on_the_cpu():
    model, classes = get_model("faster_rcnn_resnet50_fpn_coco", device="cpu")
    assert len(classes) == 80 and isinstance(model, TF.FasterRCNN)
    assert model.cls_score.weight.shape == (81, 1024) and model.fc1.weight.shape == (1024, 12544)
    assert [len(s) for s in model.backbone.stages] == [3, 4, 6, 3]
    assert next(model.parameters()).device == torch.device("cpu")


@pytest.mark.slow
def test_full_depth_reproduces_the_golden_fixture():
    """``tests/integration/test_golden.py:121-143``'s recipe (ResNet-50 FPN,
    4 classes, 128 px, float32, JAX init key 4) against its fixture, at this
    file's tolerances: the fixture's own 1e-6 / 1e-4 are XLA's summation
    order (ROADMAP Queue 3)."""
    import os

    x = np.random.default_rng(66).uniform(0, 1, (1, IMAGE, IMAGE, 3)).astype(np.float32)
    module = _jax_module(num_classes=4)
    variables = jax.jit(lambda: module.init(
        {"params": jax.random.key(4), "sampling": jax.random.key(5)}, jnp.asarray(x),
        train=False))()
    model = TF.FasterRCNN(4, TF.FRCNNConfig(**COUNTS), TORCH_F32).eval()
    load_flat(model, _flat(variables))
    with torch.inference_mode():
        got = TF.frcnn_forward_and_postprocess(model, torch.from_numpy(x), **POST)
    fixture = os.path.join(os.path.dirname(__file__), "fixtures",
                           "golden_dets_frcnn_r50fpn_128.npz")
    with np.load(fixture) as data:
        _assert_detections(got, [data["ids"], data["scores"], data["boxes"]])
