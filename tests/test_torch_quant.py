"""int8 post-training quantization in the port (``viddet_tpu_torch/quant.py``
and the int8 branch of ``ConvBNLeaky`` / ``ConvBN``) against the JAX
package's (``viddet_tpu/quant.py``).

The first seven tests mirror ``tests/unit/test_quant.py`` on the port.
Then the port against JAX on the same numpy inputs:

* ``int8_conv_bn``: given XLA's CPU ``rsqrt`` values (which the port's
  ``quant.rsqrt`` hook takes here; see below) the activation and weight
  codes, the int32 accumulators and the float32 and bf16 outputs equal
  JAX's bit for bit.  With the port's own ``rsqrt`` (``1 / sqrt``) the
  codes and accumulators still equal JAX's on these inputs, and the
  outputs differ by at most ``OWN_RSQRT_F32_ATOL`` (float32; measured
  3.8e-6 on values up to ~30): XLA's CPU rsqrt is ``vrsqrtps`` and two
  Newton steps, an ulp off the correctly rounded value in ~7 % of
  channels, which moves the folded bias by an ulp;
* the calibrated ranges of a tiny YOLOv3, a shallow SSD and a shallow
  Faster R-CNN in float32 compute equal JAX's ``quant`` collection within
  ``AMAX_RTOL`` (the float convs sum in another order);
* tiny int8 YOLOv3 and shallow int8 SSD on JAX's ranges (carried through
  ``weights.load_flat``): detection ids exact, scores and boxes at the
  golden tolerances, head outputs within ``HEAD_ATOL``: given XLA's rsqrt,
  within 1e-5 (measured 2.5e-6 and 9e-7: the float output heads sum in
  another order); with the port's own, within 5e-3 (measured 9.6e-5 and
  1.6e-3): an ulp of a folded bias moves a few activations across a
  rounding boundary of the next layer's codes, a step of one code there
  (ROADMAP Queue 3);
* the card route (im2col, K padding, ``torch._int_mm``; run here on the
  CPU) equals the plain float64 route bit for bit;
* the CLIs' ``--quant int8``.
"""

import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_detector_helpers import one_torch_thread  # noqa: F401 (a fixture)
from viddet_tpu import quant as jq
from viddet_tpu.core.precision import Policy as JaxPolicy
from viddet_tpu.train.state import _flatten
from viddet_tpu_torch import quant
from viddet_tpu_torch.core.precision import FLOAT32_POLICY, INT8_POLICY, Policy
from viddet_tpu_torch.models.common import ConvBNLeaky
from viddet_tpu_torch.models.yolo3 import YOLOv3, flatten_outputs
from viddet_tpu_torch.weights import load_flat, to_flat

F32_INT8 = Policy(compute_dtype=torch.float32, quant="int8")
JAX_F32_INT8 = JaxPolicy(compute_dtype=jnp.float32, quant="int8")
OWN_RSQRT_F32_ATOL = 1e-5
AMAX_RTOL = 1e-5
HEAD_ATOL = {"xla": 1e-5, "own": 5e-3}
TINY = dict(num_classes=3, backbone="tiny",
            anchors=(((40, 40), (24, 48), (48, 24)), ((10, 10), (16, 8), (8, 16))),
            strides=(32, 16))
SHALLOW = dict(backbone_blocks=(1, 1, 1, 1), backbone_widths=(8, 16, 32, 64))


def nchw(x: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype).permute(0, 3, 1, 2)


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).float().numpy()


def bn_params(rng, cout):
    return (rng.uniform(0.5, 1.5, cout).astype(np.float32), rng.normal(size=cout).astype(np.float32),
            (rng.normal(size=cout) * 0.1).astype(np.float32),
            rng.uniform(0.5, 2.0, cout).astype(np.float32))


# ------------------------------------------------ tests/unit/test_quant.py


def test_int8_cell_exact_on_grid_points():
    """Grid-point inputs and weights quantize losslessly: the int8 cell
    equals the float cell."""
    rng = np.random.default_rng(0)
    cin, cout, h = 8, 16, 12
    amax = 63.5  # sx = 0.5
    x = rng.integers(-127, 128, size=(2, h, h, cin)).astype(np.float32) * 0.5
    w = rng.integers(-127, 128, size=(3, 3, cin, cout)).astype(np.float32)
    w[0, 0, 0, :] = 127.0
    eps = 1e-5
    var = torch.ones(cout)
    scale = torch.sqrt(var + eps)
    bias = torch.from_numpy(rng.normal(size=cout).astype(np.float32))
    mean = torch.zeros(cout)
    wt = torch.from_numpy(w).permute(3, 2, 0, 1)
    got = quant.int8_conv_bn(nchw(x), wt, scale, bias, mean, var, torch.tensor(amax),
                             stride=1, out_dtype=torch.float32)
    ref = torch.nn.functional.conv2d(nchw(x), wt, padding=1) + bias[:, None, None]
    ref = torch.where(ref >= 0, ref, ref * 0.1)
    np.testing.assert_allclose(nhwc(got), nhwc(ref), rtol=0, atol=1e-4)


def test_int8_cell_stride2_shapes_and_error_bound():
    rng = np.random.default_rng(1)
    x = nchw(rng.normal(size=(2, 16, 16, 8)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(3, 3, 8, 16)) * 0.2).astype(np.float32)).permute(3, 2, 0, 1)
    scale, bias, mean, var = (torch.from_numpy(v) for v in bn_params(rng, 16))
    got = quant.int8_conv_bn(x, w, scale, bias, mean, var, x.abs().max(), stride=2,
                             out_dtype=torch.float32)
    inv = scale / torch.sqrt(var + 1e-5)
    ref = torch.nn.functional.conv2d(torch.nn.functional.pad(x, (0, 1, 0, 1)),
                                     w * inv[:, None, None, None], stride=2)
    ref = ref + (bias - mean * inv)[:, None, None]
    ref = torch.where(ref >= 0, ref, ref * 0.1)
    assert got.shape == ref.shape == (2, 16, 8, 8)
    err = float((got - ref).abs().max())
    assert err < 0.15, err


def _cell(policy=F32_INT8):
    return ConvBNLeaky(4, 4, 3, policy=policy, scope="ConvBNLeaky_0").to(
        memory_format=torch.channels_last).eval()


def test_calibration_records_absmax_and_is_monotone():
    cell = _cell()
    b1 = torch.full((1, 4, 8, 8), 2.0)
    b2 = torch.full((1, 4, 8, 8), -5.0)
    quant.calibrate(cell, [b1, b2])
    assert float(cell.act_amax) == 5.0
    quant.calibrate(cell, [b1])  # a smaller batch must not shrink the range
    assert float(cell.act_amax) == 5.0


def test_uncalibrated_deploy_raises():
    cell = _cell()
    flat = to_flat(cell)
    with pytest.raises(ValueError, match="calibrate"):
        quant.check_calibrated({k: v for k, v in flat.items() if not k.startswith("quant/")})
    with pytest.raises(ValueError, match="uncalibrated"):
        quant.check_calibrated(flat)
    with pytest.raises(ValueError, match="uncalibrated"):
        quant.check_calibrated(cell)
    from viddet_tpu_torch.cli.common import make_predictor

    model = YOLOv3(policy=F32_INT8, **TINY).to(memory_format=torch.channels_last).eval()
    with pytest.raises(ValueError, match="uncalibrated"):
        make_predictor(model)
    with pytest.raises(ValueError, match="calibrate"):
        quant.check_calibrated(YOLOv3(policy=FLOAT32_POLICY, **TINY))


def _corr(a, b) -> float:
    a = a.detach().double().flatten().numpy()
    b = b.detach().double().flatten().numpy()
    return float(np.corrcoef(a, b)[0, 1])


def test_quantized_tiny_yolo_close_to_float_twin():
    """The same weights through the float and the int8 model: head outputs
    correlate tightly, boxes stay finite."""
    torch.manual_seed(0)
    f_model = YOLOv3(policy=FLOAT32_POLICY, **TINY).to(memory_format=torch.channels_last).eval()
    q_model = YOLOv3(policy=F32_INT8, **TINY).to(memory_format=torch.channels_last).eval()
    load_flat(q_model, to_flat(f_model))
    images = torch.from_numpy(np.random.default_rng(2).uniform(0, 1, (2, 64, 64, 3))
                              .astype(np.float32))
    quant.calibrate(q_model, [images])
    with torch.inference_mode():
        f_out = flatten_outputs(f_model(images))
        q_out = flatten_outputs(q_model(images))
    for key in ("raw_obj", "cls_max"):
        corr = _corr(f_out[key], q_out[key])
        assert corr > 0.99, (key, corr)
    assert bool(torch.isfinite(q_out["boxes"]).all())


def test_quantized_ssd_resnet_close_to_float_twin():
    from viddet_tpu_torch.models.ssd import SSD

    torch.manual_seed(0)
    f_model = SSD(3, 128, FLOAT32_POLICY, **SHALLOW).to(memory_format=torch.channels_last).eval()
    q_model = SSD(3, 128, F32_INT8, **SHALLOW).to(memory_format=torch.channels_last).eval()
    load_flat(q_model, to_flat(f_model))
    images = torch.from_numpy(np.random.default_rng(4).uniform(0, 1, (1, 128, 128, 3))
                              .astype(np.float32))
    quant.calibrate(q_model, [images])
    with torch.inference_mode():
        corr = _corr(f_model(images)["cls_logits"], q_model(images)["cls_logits"])
    assert corr > 0.99, corr


def test_int8_policy_trains_on_float_path():
    cell = _cell().train()
    assert "act_amax" in dict(cell.named_buffers())
    x = torch.ones((1, 4, 8, 8))
    loss = (cell(x) ** 2).sum()
    loss.backward()
    grads = [p.grad for p in cell.parameters()]
    assert all(g is not None and bool(torch.isfinite(g).all()) for g in grads)
    assert float(cell.act_amax) == 0.0  # the range is inert in training


# ------------------------------------------------------- against JAX


@functools.lru_cache(maxsize=None)
def _jax_codes(stride: int):
    """The quantize and conv lines of ``viddet_tpu/quant.py:155-170``, jitted."""
    def codes(x, kernel, scale, bias, mean, var, amax):
        f32 = jnp.float32
        inv = scale * jax.lax.rsqrt(var + 1e-5)
        w = kernel * inv
        sw = jnp.maximum(jnp.max(jnp.abs(w), axis=(0, 1, 2)), 1e-12) / 127.0
        wq = jnp.clip(jnp.round(w / sw), -127, 127).astype(jnp.int8)
        sx = jnp.maximum(amax.astype(f32), 1e-12) / 127.0
        xq = jnp.clip(jnp.round(x.astype(f32) / sx), -127, 127).astype(jnp.int8)
        acc = jax.lax.conv_general_dilated(xq, wq, (stride, stride), "SAME",
                                           dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                           preferred_element_type=jnp.int32)
        return xq, wq, acc
    return jax.jit(codes)


@functools.lru_cache(maxsize=None)
def _jax_int8_conv_bn(stride: int, act: str, dtype):
    """JAX's ``int8_conv_bn`` as the package runs it: jitted (eager JAX
    rounds each operation apart, without XLA's fusions)."""
    return jax.jit(functools.partial(jq.int8_conv_bn, strides=stride, act=act, out_dtype=dtype))


_XLA_RSQRT = jax.jit(jax.lax.rsqrt)


def xla_rsqrt(v: torch.Tensor) -> torch.Tensor:
    """XLA's CPU rsqrt of the same float32 values (``vrsqrtps`` and two
    Newton steps)."""
    return torch.from_numpy(np.array(_XLA_RSQRT(v.numpy())))


CASES = [(3, 32, 3, 1), (16, 32, 3, 2), (64, 32, 1, 1), (24, 16, 1, 2), (3, 64, 7, 2),
         (32, 64, 3, 2)]


def _case(i: int, cin, cout, k):
    rng = np.random.default_rng(100 + i)
    h = int(rng.integers(6, 20))
    x = (rng.normal(size=(2, h, h + 1, cin)) * 2).astype(np.float32)
    w = (rng.normal(size=(k, k, cin, cout)) * 0.2).astype(np.float32)
    return x, w, bn_params(rng, cout), np.float32(np.abs(x).max() * 0.8)


@pytest.mark.parametrize("act", ["leaky", "relu", "none"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_int8_conv_bn_equals_jax(case, act, monkeypatch):
    cin, cout, k, s = CASES[case]
    x, w, bn, amax = _case(case, cin, cout, k)
    xq_j, wq_j, acc_j = (np.asarray(a) for a in _jax_codes(s)(x, w, *bn, amax))
    wt = torch.from_numpy(w).permute(3, 2, 0, 1)
    bnt = [torch.from_numpy(v) for v in bn]
    for rsqrt in ("xla", "own"):
        if rsqrt == "xla":
            monkeypatch.setattr(quant, "rsqrt", xla_rsqrt)
        else:
            monkeypatch.undo()
        wq, _, _ = quant.fold_weights(wt, *bnt)
        xq = quant.quantize_activations(nchw(x), torch.tensor(amax)).permute(0, 2, 3, 1)
        np.testing.assert_array_equal(xq.numpy(), xq_j)
        np.testing.assert_array_equal(wq.permute(1, 2, 3, 0).numpy(), wq_j)
        acc = quant.conv_acc_plain(xq.contiguous(), wq, s)
        np.testing.assert_array_equal(acc.numpy(), acc_j)
        for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
            xj = jnp.asarray(x, jdt)
            want = np.asarray(_jax_int8_conv_bn(s, act, jdt)(xj, w, *bn, amax)).astype(
                np.float32)
            got = nhwc(quant.int8_conv_bn(nchw(np.asarray(xj.astype(jnp.float32)), tdt), wt,
                                          *bnt, torch.tensor(amax), stride=s, act=act,
                                          out_dtype=tdt))
            if rsqrt == "xla":
                np.testing.assert_array_equal(got, want)
            elif tdt == torch.float32:
                np.testing.assert_allclose(got, want, rtol=0, atol=OWN_RSQRT_F32_ATOL)


@pytest.mark.parametrize("case", [(2, 13, 15, 3, 32, 3, 1), (2, 13, 15, 3, 64, 7, 2),
                                  (1, 9, 9, 16, 24, 3, 2), (2, 8, 8, 64, 32, 1, 1),
                                  (2, 7, 9, 12, 16, 1, 1), (1, 1, 1, 64, 32, 1, 1),
                                  (1, 3, 3, 32, 16, 1, 2), (3, 5, 6, 40, 8, 3, 1)])
def test_card_route_equals_plain_route(case):
    """The im2col (K ordered kh, kw, cin; zero-padded to a multiple of 8),
    the row padding and ``torch._int_mm`` against the float64 convolution."""
    b, h, w, cin, cout, k, s = case
    rng = np.random.default_rng(sum(case))
    xq = torch.from_numpy(rng.integers(-127, 128, (b, h, w, cin)).astype(np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (cout, k, k, cin)).astype(np.int8))
    card = quant.conv_acc_card(xq, wq, s)
    plain = quant.conv_acc_plain(xq, wq, s)
    assert card.dtype == plain.dtype == torch.int32
    assert card.shape == plain.shape == (b, -(-h // s), -(-w // s), cout)
    assert torch.equal(card, plain)


def _flat(variables) -> dict:
    flat = {}
    for col in ("params", "batch_stats", "quant"):
        if col in variables:
            flat.update(_flatten({col: variables[col]}))
    return flat


@functools.lru_cache(maxsize=None)
def _jax_family(family: str):
    """A JAX int8 model in float32 compute, initialized and calibrated on
    one batch: (flat weights with the ranges, images, JAX's calibrated
    variables, the module)."""
    if family == "yolo":
        from viddet_tpu.models.yolo3 import YOLOv3 as JY

        module = JY(policy=JAX_F32_INT8, **TINY)
        size = 64
    elif family == "ssd":
        from viddet_tpu.models.ssd import SSD as JS

        module = JS(num_classes=3, image_size=64, policy=JAX_F32_INT8, **SHALLOW)
        size = 64
    else:
        from viddet_tpu.models import faster_rcnn as JF

        from tests.test_torch_frcnn import COUNTS

        module = JF.FasterRCNN(num_classes=3, config=JF.FRCNNConfig(**COUNTS),
                               policy=JAX_F32_INT8, **SHALLOW)
        size = 64
    rng = np.random.default_rng({"yolo": 2, "ssd": 4, "frcnn": 5}[family])
    images = rng.uniform(0, 1, (2, size, size, 3)).astype(np.float32)
    variables = jax.jit(lambda x: module.init(jax.random.key(0), x, train=False))(
        jnp.asarray(images[:1]))
    calibrated = jq.calibrate(module, dict(variables), [jnp.asarray(images)])
    return _flat(calibrated), images, calibrated, module


def _port_family(family: str, policy: Policy):
    from viddet_tpu_torch.models.faster_rcnn import FasterRCNN, FRCNNConfig
    from viddet_tpu_torch.models.ssd import SSD

    from tests.test_torch_frcnn import COUNTS

    if family == "yolo":
        model = YOLOv3(policy=policy, **TINY)
    elif family == "ssd":
        model = SSD(3, 64, policy, **SHALLOW)
    else:
        model = FasterRCNN(3, FRCNNConfig(**COUNTS), policy, **SHALLOW)
    return model.to(memory_format=torch.channels_last).eval()


@pytest.mark.parametrize("family", ["yolo", "ssd", "frcnn"])
def test_calibrated_ranges_equal_jax(family):
    flat, images, _, _ = _jax_family(family)
    model = _port_family(family, F32_INT8)
    load_flat(model, {k: v for k, v in flat.items() if not k.startswith("quant/")})
    quant.calibrate(model, [torch.from_numpy(images)])
    got = {k: v for k, v in to_flat(model).items() if k.startswith("quant/")}
    want = {k: v for k, v in flat.items() if k.startswith("quant/")}
    assert sorted(got) == sorted(want) and len(got) > 5
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=AMAX_RTOL, err_msg=key)


@functools.lru_cache(maxsize=None)
def _jax_detections(family: str):
    from viddet_tpu.models import ssd as JS
    from viddet_tpu.models import yolo3 as JY

    _, images, variables, module = _jax_family(family)
    x = jnp.asarray(images)
    out = jax.jit(lambda v, x: module.apply(v, x, train=False))(variables, x)
    if family == "yolo":
        heads = [np.asarray(c, np.float32) for c in out["raws_cells"]]
        nms = JY.NMSConfig(backend="xla", topk=64, post_nms=16)
        dets = jax.jit(lambda v, x: JY.forward_and_postprocess(module, v, x, nms))(variables, x)
    else:
        heads = [np.asarray(out[k], np.float32) for k in ("cls_logits", "box_deltas")]
        nms = JS.SSDNMSConfig(backend="xla", topk=64, post_nms=16)
        dets = jax.jit(lambda v, x: JS.ssd_forward_and_postprocess(module, v, x, nms))(
            variables, x)
    return heads, [np.asarray(d) for d in dets]


@pytest.mark.parametrize("rsqrt", ["xla", "own"])
@pytest.mark.parametrize("family", ["yolo", "ssd"])
def test_int8_model_on_jax_ranges_equals_jax(family, rsqrt, monkeypatch):
    """Both packages' int8 models on JAX's calibrated ranges: the
    detections' ids exact, scores and boxes at the golden tolerances, head
    outputs within HEAD_ATOL (see the module docstring)."""
    from viddet_tpu_torch.models.ssd import ssd_forward_and_postprocess
    from viddet_tpu_torch.models.yolo3 import NMSConfig, forward_and_postprocess

    monkeypatch.setenv("VIDDET_PAIR_TOPK", "det")
    if rsqrt == "xla":
        monkeypatch.setattr(quant, "rsqrt", xla_rsqrt)
    flat, images, _, _ = _jax_family(family)
    model = _port_family(family, F32_INT8)
    load_flat(model, flat)
    want_heads, want = _jax_detections(family)
    x = torch.from_numpy(images)
    nms = NMSConfig(topk=64, post_nms=16)
    with torch.inference_mode():
        out = model(x)
        if family == "yolo":
            heads = [c.numpy() for c in out["raws_cells"]]
            got = forward_and_postprocess(model, x, nms)
        else:
            heads = [out[k].numpy() for k in ("cls_logits", "box_deltas")]
            got = ssd_forward_and_postprocess(model, x, nms)
    for g, w in zip(heads, want_heads):
        np.testing.assert_allclose(g, w, rtol=0, atol=HEAD_ATOL[rsqrt])
    assert int((want[0] >= 0).sum()) > 10
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_allclose(got[1].numpy(), want[1], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[2].numpy(), want[2], rtol=0, atol=1e-3)


# ------------------------------------------------------------ CLIs, env


def test_mode_from_env(monkeypatch):
    monkeypatch.delenv("VIDDET_QUANT", raising=False)
    assert quant.mode_from_env() is None
    monkeypatch.setenv("VIDDET_QUANT", "int8")
    assert quant.mode_from_env() == "int8"
    for bad in ("1", "in8"):
        monkeypatch.setenv("VIDDET_QUANT", bad)
        with pytest.raises(ValueError, match="only 'int8'"):
            quant.mode_from_env()


@pytest.fixture(scope="module")
def calib_dir(tmp_path_factory):
    from viddet_tpu_torch.utils.image import imwrite

    d = tmp_path_factory.mktemp("calib")
    rng = np.random.default_rng(11)
    for i in range(3):
        imwrite(str(d / f"c{i}.png"), rng.integers(0, 256, (40, 56, 3), np.uint8))
    return d


def _cli_model(policy=INT8_POLICY):
    from viddet_tpu_torch.cli.common import build_model, load_weights_or_seed

    model, names = build_model("yolo3_tiny_darknet", "voc", device="cpu", policy=policy)
    return load_weights_or_seed(model, ""), names


def test_detect_quant_int8(calib_dir, tmp_path):
    """``detect --quant int8`` calibrates on ``--calib-images`` (2 batches of
    2 here) and writes what the direct predictor of that calibrated model
    gives; without ``--calib-images`` it exits."""
    from viddet_tpu_torch.cli import detect
    from viddet_tpu_torch.cli.common import make_predictor
    from viddet_tpu_torch.data.base import imread_rgb
    from viddet_tpu_torch.data.transforms import ValTransform

    argv = ["--platform", "cpu", "--network", "yolo3_tiny_darknet", "--dataset", "voc",
            "--data-shape", "64", "--batch-size", "2", "--input", str(calib_dir),
            "--output", str(tmp_path), "--save-detections", "--no-draw", "--thresh", "0.0",
            "--quant", "int8", "--calib-batches", "2"]
    with pytest.raises(SystemExit, match="calib-images"):
        detect.main(argv)
    model, names = _cli_model()
    assert detect.main(argv + ["--calib-images", str(calib_dir)], built=(model, names)) == 3
    cells = quant.quant_cells(model)
    assert cells and all(float(c.act_amax) > 0 for c in cells)
    again, _ = _cli_model()
    detect.main(argv + ["--calib-images", str(calib_dir)], built=(again, names))
    for a, b in zip(to_flat(model).items(), to_flat(again).items()):
        np.testing.assert_array_equal(a[1], b[1])
    transform = ValTransform(size=(64, 64), letterbox_resize=True, normalize=False)
    x, _, affine = transform(imread_rgb(str(calib_dir / "c0.png")))
    ids, scores, boxes = (t.numpy() for t in make_predictor(model)(torch.from_numpy(x[None])))
    from viddet_tpu_torch.data.transforms import invert_affine_to_boxes

    want = detect.detection_lines(ids[0], scores[0], invert_affine_to_boxes(boxes[0], affine),
                                  names, 0.0)
    assert (tmp_path / "c0.txt").read_text() == want and want


def test_serve_quant_int8(calib_dir):
    import json
    import urllib.request

    from viddet_tpu_torch.cli import serve

    args = serve.parse_args(["--platform", "cpu", "--network", "yolo3_tiny_darknet",
                             "--dataset", "voc", "--data-shape", "64", "--port", "0",
                             "--batch-size", "2", "--quant", "int8", "--calib-images",
                             str(calib_dir), "--calib-batches", "1"])
    server = serve.serve_forever(args, logging.getLogger("test"))
    try:
        port = server.server_address[1]
        data = (calib_dir / "c1.png").read_bytes()
        req = urllib.request.Request(f"http://127.0.0.1:{port}/detect?thresh=0", data=data)
        reply = json.loads(urllib.request.urlopen(req, timeout=60).read())
        assert reply["width"] == 56 and reply["height"] == 40 and reply["detections"]
    finally:
        server.shutdown()
        server.server_close()
        server.viddet_service.close()


def test_evaluate_quant_int8(tmp_path, monkeypatch):
    """``evaluate --quant int8`` calibrates on its first ``--calib-batches``
    loader batches: its saved detections equal evaluating a model
    calibrated by hand on the same normalized batches."""
    from viddet_tpu_torch.cli import evaluate as ev

    out = tmp_path / "q.jsonl"
    argv = ["--platform", "cpu", "--network", "yolo3_tiny_darknet", "--dataset", "synthetic",
            "--data-root", "synthetic", "--data-shape", "64", "--batch-size", "4",
            "--max-images", "8", "--num-workers", "1", "--quant", "int8", "--calib-batches",
            "2", "--save-detections", str(out)]
    ev.main(argv)
    args = ev.parse_args(argv[:-1] + [str(tmp_path / "hand.jsonl")])
    dataset, factory = ev.get_dataset("synthetic", "synthetic", split="val")
    model, names = ev.build_model("yolo3_tiny_darknet", "synthetic", classes=dataset.classes,
                                  device="cpu", policy=INT8_POLICY)
    from viddet_tpu_torch.weights import seeded_flat

    load_flat(model, seeded_flat(model, seed=0))
    it = iter(ev.val_loader(dataset, args))  # float32 batches: normalized by the loader
    batches = [torch.from_numpy(next(it)[0]) for _ in range(2)]
    it.close()
    quant.calibrate(model, batches)
    ev.evaluate(model, dataset, factory(names), args, logging.getLogger("test"))
    assert out.read_text() == (tmp_path / "hand.jsonl").read_text()
    assert len(out.read_text().splitlines()) == 8
