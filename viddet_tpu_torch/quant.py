"""Post-training int8 quantization for inference (counterpart of
``viddet_tpu/quant.py``).

The scheme is the JAX package's, step by step:

* **BatchNorm folded into the conv** at apply time:
  ``inv = scale * rsqrt(var + eps)``, ``W' = W * inv`` per output channel,
  ``b' = bias - mean * inv``;
* **weights**: symmetric per-output-channel int8,
  ``sw = max(max|W'_c|, 1e-12) / 127``;
* **activations**: symmetric per-tensor int8 with a calibrated range,
  ``sx = max(amax, 1e-12) / 127``;
* **codes**: ``round`` (half to even), clipped to +-127, cast to int8;
* an int8 x int8 -> int32 convolution ("SAME" padding; zero is code 0);
* **epilogue** in float32: ``acc * (sx * sw) + b'``, then leaky ReLU
  (0.1, on the float32 ``y``: not the bf16 slope of ``models/common.py``),
  ReLU or nothing, then a cast to the compute dtype.

Output heads (YOLOv3's ``output_i``, SSD's and Faster R-CNN's predictors)
stay in the float compute dtype, as in JAX.

Rounding, where it decides a code.  XLA's CPU program, the reference the
tests hold the port to, computes these lines as follows (its optimized
HLO and object code): ``/ 127.0`` is a multiplication by
``float32(1/127)``; ``sx * sw`` is ``max(w_amax, 1e-12) * (max(amax,
1e-12) * float32(1/127)**2)``; ``x / sx`` and ``W' / sw`` are true
divisions; ``bias - mean * inv`` and ``acc * scale + b'`` are fused
multiply-adds.  The port computes each the same way, the fused
multiply-adds in float64 (the product of two float32 values is exact
there) rounded once to float32.  XLA's ``rsqrt`` is the x86 ``vrsqrtps``
approximation refined by two Newton steps, which no PyTorch operation
reproduces; the port's ``rsqrt`` is ``1 / sqrt``, the same on the CPU and
the card, and differs from XLA's by an ulp in ~7 % of channels (ROADMAP
Queue 3).  Given XLA's rsqrt values the port's codes, accumulators and
outputs equal JAX's bit for bit (``tests/test_torch_quant.py``).

The convolution has two routes, the same function:

* the **card route** (``conv_acc_card``), which every CUDA tensor takes:
  an NHWC im2col of kh*kw shifted, strided views of the padded codes, K
  ordered (kh, kw, cin) as the weight rows, zero-padded to a multiple of
  8, then ``torch._int_mm`` (int8 x int8 -> int32).  A 1x1 stride-1 conv
  with Cin % 8 == 0 multiplies the codes in place.  Rows are padded to
  ``INT_MM_MIN_ROWS`` where fewer (``_int_mm``'s rule on CUDA); any shape
  ``_int_mm`` refuses raises;
* the **plain route** (``conv_acc_plain``), which every CPU tensor takes:
  a float64 ``F.conv2d`` of the codes, rounded to int32.  It is exact:
  |acc| <= 127**2 * kh * kw * Cin < 2**31 < 2**53.

Calibration runs the float forward while each cell records ``max|x|`` of
its input into its ``act_amax`` buffer (``calibrate``); deploying reads
those ranges, and a zero range is an error (``check_calibrated``).
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterable, Mapping

import numpy as np
import torch
import torch.nn.functional as F

_CALIBRATING = False
INV_127 = float(np.float32(1.0) / np.float32(127.0))
# XLA folds (a / 127) * (w / 127) into a * (1/127 * 1/127) * w
INV_127_SQ = float(np.float32(INV_127) * np.float32(INV_127))
INT_MM_MIN_ROWS = 17  # torch._int_mm on CUDA takes more than 16 rows
ACTS = ("leaky", "relu", "none")


def mode_from_env() -> str | None:
    """Validated ``VIDDET_QUANT``: ``"int8"`` or None; any other value
    raises, so that a typo never measures the float path by mistake."""
    mode = os.environ.get("VIDDET_QUANT")
    if mode and mode != "int8":
        raise ValueError(f"VIDDET_QUANT={mode!r}: only 'int8' exists")
    return mode or None


def is_calibrating() -> bool:
    """Inside ``calibration()`` the int8 cells record their input ranges
    and run the float path."""
    return _CALIBRATING


@contextlib.contextmanager
def calibration():
    """Calibration mode for the enclosed forward passes."""
    global _CALIBRATING
    prev = _CALIBRATING
    _CALIBRATING = True
    try:
        yield
    finally:
        _CALIBRATING = prev


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add: the
    product of two float32 values is exact in float64."""
    return torch.addcmul(c.double(), a, b.double()).float()


def rsqrt(v: torch.Tensor) -> torch.Tensor:
    """``1 / sqrt(v)``: a correctly rounded square root, then a correctly
    rounded division, on the CPU and the card."""
    return 1.0 / torch.sqrt(v)


def fold_weights(weight: torch.Tensor, bn_scale, bn_bias, bn_mean, bn_var,
                 eps: float = 1e-5):
    """BatchNorm folded into the weights and quantized per output channel.

    weight (Cout, Cin, kh, kw).  Returns (wq (Cout, kh, kw, Cin) int8, the
    weight rows in the im2col's (kh, kw, cin) order; ``max(w_amax, 1e-12)``
    (Cout,) float32; the folded bias b' (Cout,) float32)."""
    inv = bn_scale.float() * rsqrt(bn_var.float() + eps)
    w = weight.float() * inv[:, None, None, None]
    b = fma32(-bn_mean.float(), inv, bn_bias.float())
    w_amax = w.abs().amax(dim=(1, 2, 3)).clamp_min(1e-12)
    sw = w_amax * INV_127
    wq = torch.round(w / sw[:, None, None, None]).clamp_(-127, 127).to(torch.int8)
    return wq.permute(0, 2, 3, 1).contiguous(), w_amax, b


def quantize_activations(x: torch.Tensor, act_amax: torch.Tensor) -> torch.Tensor:
    """Per-tensor int8 codes of ``x`` (any layout, kept) at the calibrated
    range: ``clip(round(x / sx), -127, 127)``."""
    sx = act_amax.float().clamp_min(1e-12) * INV_127
    return torch.div(x.float(), sx).round_().clamp_(-127, 127).to(torch.int8)


def _pad_nhwc(xq: torch.Tensor, kh: int, kw: int, stride: int) -> torch.Tensor:
    from viddet_tpu_torch.models.common import same_pads  # common imports this module

    ph = same_pads(xq.shape[1], kh, stride)
    pw = same_pads(xq.shape[2], kw, stride)
    if ph == pw == (0, 0):
        return xq
    return F.pad(xq, (0, 0, pw[0], pw[1], ph[0], ph[1]))


def im2col(xq: torch.Tensor, kh: int, kw: int, stride: int) -> torch.Tensor:
    """The card route's left operand: NHWC codes (B, H, W, Cin) -> (M, K')
    int8, a row per output pixel of the "SAME" convolution, K ordered (kh,
    kw, cin) and zero-padded to K' (a multiple of 8), M at least
    ``INT_MM_MIN_ROWS``.  A 1x1 stride-1 conv with Cin % 8 == 0 is a view
    of the codes."""
    b, h, w, cin = xq.shape
    ho, wo = -(-h // stride), -(-w // stride)
    k = kh * kw * cin
    kp = -(-k // 8) * 8
    if kh == kw == stride == 1 and kp == k:
        a = xq.reshape(b * h * w, cin)
    else:
        xp = _pad_nhwc(xq, kh, kw, stride)
        views = [xp[:, i:i + stride * (ho - 1) + 1:stride, j:j + stride * (wo - 1) + 1:stride]
                 for i in range(kh) for j in range(kw)]
        if kp > k:
            views.append(xq.new_zeros((b, ho, wo, kp - k)))
        a = torch.cat(views, dim=-1).reshape(b * ho * wo, kp)
    if a.shape[0] < INT_MM_MIN_ROWS:
        a = F.pad(a, (0, 0, 0, INT_MM_MIN_ROWS - a.shape[0]))
    return a


def weight_matrix(wq: torch.Tensor) -> torch.Tensor:
    """The card route's right operand: ``wq`` (Cout, kh, kw, Cin) as a
    column-major (K', Cout) int8 matrix, K zero-padded as ``im2col``'s."""
    cout = wq.shape[0]
    k = wq[0].numel()
    wmat = wq.reshape(cout, k)
    if k % 8:
        wmat = F.pad(wmat, (0, -(-k // 8) * 8 - k))
    return wmat.t()


def conv_acc_card(xq: torch.Tensor, wq: torch.Tensor, stride: int) -> torch.Tensor:
    """int32 accumulator (B, Ho, Wo, Cout) of the "SAME" convolution of
    NHWC codes ``xq`` (B, H, W, Cin) with ``wq`` (Cout, kh, kw, Cin): the
    ``im2col`` of shifted, strided views and ``torch._int_mm``."""
    b, h, w, _ = xq.shape
    cout, kh, kw, _ = wq.shape
    ho, wo = -(-h // stride), -(-w // stride)
    acc = torch._int_mm(im2col(xq, kh, kw, stride), weight_matrix(wq))
    return acc[:b * ho * wo].reshape(b, ho, wo, cout)


def conv_acc_plain(xq: torch.Tensor, wq: torch.Tensor, stride: int) -> torch.Tensor:
    """``conv_acc_card``'s function as a float64 convolution of the codes,
    rounded to int32 (exact: every partial sum is an integer below
    2**53)."""
    cout, kh, kw, _ = wq.shape
    xp = _pad_nhwc(xq, kh, kw, stride).permute(0, 3, 1, 2).double()
    acc = F.conv2d(xp, wq.permute(0, 3, 1, 2).double(), stride=stride)
    return torch.round(acc).to(torch.int32).permute(0, 2, 3, 1)


def conv_acc(xq: torch.Tensor, wq: torch.Tensor, stride: int) -> torch.Tensor:
    """The card route for a CUDA tensor, the plain route on the CPU; a
    tensor on another device raises."""
    if xq.device.type == "cpu":
        return conv_acc_plain(xq, wq, stride)
    if xq.device.type != "cuda":
        raise ValueError(f"int8 conv: expected a CUDA or CPU tensor, got one on {xq.device}")
    return conv_acc_card(xq, wq, stride)


def epilogue(acc: torch.Tensor, w_amax: torch.Tensor, act_amax: torch.Tensor,
             b: torch.Tensor, act: str, out_dtype: torch.dtype) -> torch.Tensor:
    """Dequantize, add the folded bias and activate: ``acc * (sx * sw) +
    b'`` in float32, then the activation on that float32 ``y``, then a cast
    to ``out_dtype``.  acc (..., Cout) int32."""
    if act not in ACTS:
        raise ValueError(f"act={act!r} is not one of {ACTS}")
    scale = w_amax * (act_amax.float().clamp_min(1e-12) * INV_127_SQ)
    y = fma32(acc.float(), scale, b)  # acc rounds to float32 first, as in XLA
    if act == "leaky":  # where(y >= 0, y, y * float32(0.1)), as jax.nn.leaky_relu
        y = F.leaky_relu_(y, 0.1)
    elif act == "relu":
        y = torch.relu_(y)
    return y.to(out_dtype)


def int8_conv_bn(x: torch.Tensor, weight: torch.Tensor, bn_scale, bn_bias, bn_mean, bn_var,
                 act_amax: torch.Tensor, *, stride: int = 1, act: str = "leaky",
                 eps: float = 1e-5, out_dtype: torch.dtype = torch.bfloat16,
                 folded=None) -> torch.Tensor:
    """BN-folded int8 conv + bias + activation (``viddet_tpu/quant.py:133``).

    x (B, Cin, H, W), weight (Cout, Cin, kh, kw); returns (B, Cout, Ho,
    Wo) in ``out_dtype``, channels_last.  ``folded``: ``fold_weights``'s
    result when the caller keeps it."""
    wq, w_amax, b = folded if folded is not None else fold_weights(
        weight, bn_scale, bn_bias, bn_mean, bn_var, eps)
    xq = quantize_activations(x, act_amax).permute(0, 2, 3, 1)
    if not xq.is_contiguous():
        xq = xq.contiguous()
    acc = conv_acc(xq, wq, stride)
    y = epilogue(acc, w_amax, act_amax, b, act, out_dtype)
    return y.permute(0, 3, 1, 2)


class Int8Cell:
    """The int8 branch of a conv+BN cell (``ConvBNLeaky``, ``ConvBN``):
    the cell owns ``conv``, ``bn``, ``stride`` and an ``act_amax`` buffer.
    The folded weights are kept between calls and made again when a weight
    or statistic tensor changes (its version counter), or on a new device;
    while tracing (``torch.export``) they are folded in the graph."""

    def int8_forward(self, x: torch.Tensor, act: str, out_dtype: torch.dtype) -> torch.Tensor:
        bn = self.bn
        tensors = (self.conv.weight, bn.weight, bn.bias, bn.running_mean, bn.running_var)
        if torch.compiler.is_compiling() or any(t.is_inference() for t in tensors):
            folded = fold_weights(*tensors)  # no version counter to key a copy on
        else:
            key = tuple((t.data_ptr(), t._version) for t in tensors)
            cache = getattr(self, "_int8_folded", None)
            if cache is None or cache[0] != key:
                with torch.no_grad():
                    cache = (key, fold_weights(*tensors))
                self._int8_folded = cache
            folded = cache[1]
        return int8_conv_bn(x, None, None, None, None, None, self.act_amax, stride=self.stride,
                            act=act, out_dtype=out_dtype, folded=folded)

    def record_range(self, x: torch.Tensor) -> None:
        """Calibration: act_amax = max(act_amax, max|x|)."""
        with torch.no_grad():
            self.act_amax.copy_(torch.maximum(self.act_amax, x.abs().amax().float()))


def quant_cells(model: torch.nn.Module):
    """The model's int8 cells (those with an ``act_amax`` buffer)."""
    return [m for m in model.modules() if isinstance(m, Int8Cell) and hasattr(m, "act_amax")]


@torch.no_grad()
def calibrate(model: torch.nn.Module, batches: Iterable, **forward_kwargs) -> torch.nn.Module:
    """Record activation ranges over ``batches`` (each the model's input, or
    a tuple of inputs) with the float forward in eval mode; returns the
    model, calibrated in place.  ``model`` must be built with an int8
    policy (``core.precision.INT8_POLICY``)."""
    if not quant_cells(model):
        raise ValueError("model has no quant-aware conv cells; was it built with a quant "
                         "policy (e.g. INT8_POLICY)?")
    was_training = model.training
    model.eval()
    n = 0
    try:
        with calibration():
            for batch in batches:
                if not isinstance(batch, (tuple, list)):
                    batch = (batch,)
                model(*batch, **forward_kwargs)
                n += 1
    finally:
        model.train(was_training)
    if n == 0:
        raise ValueError("calibrate() got an empty batch iterable")
    check_calibrated(model)
    return model


def check_calibrated(model_or_flat) -> None:
    """Raise unless every activation range is present and positive.

    Takes a model, or a flat ``.npz``-schema dict whose ``quant/.../act_amax``
    keys carry the ranges (``weights.to_flat``)."""
    if isinstance(model_or_flat, Mapping):
        ranges = {k: np.asarray(v) for k, v in model_or_flat.items() if k.startswith("quant/")}
    else:
        ranges = {m.scope: m.act_amax for m in quant_cells(model_or_flat)}
    if not ranges:
        raise ValueError("int8 inference needs calibrated activation ranges: run "
                         "viddet_tpu_torch.quant.calibrate(model, batches) first")
    bad = [k for k, v in ranges.items() if float(v.min()) <= 0.0]
    if bad:
        raise ValueError(f"{len(bad)} uncalibrated (non-positive) activation ranges, e.g. "
                         f"{bad[:3]}: calibration data never reached these cells")
