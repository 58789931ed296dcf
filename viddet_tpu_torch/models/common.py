"""Shared building blocks (counterpart of ``viddet_tpu/models/common.py``).

Modules take NCHW tensors in ``torch.channels_last`` memory format, which
is the JAX package's NHWC layout in memory.  Parameters are float32; each
conv runs on a compute-dtype copy of its weights, as Flax does at apply
time.  In eval mode BatchNorm uses its running statistics; in train mode
(``module.train()``) it normalizes with the batch's and updates the
running ones as Flax's ``nn.BatchNorm(momentum=0.9)`` does
(``batch_norm_train``).

Every module that owns parameters records its Flax scope (``scope``), e.g.
``"Darknet53_0/DarknetResidual_3/ConvBNLeaky_1"``, so that ``weights.py``
maps the JAX package's ``.npz`` keys onto it.  ``FlaxNames`` reproduces
Flax's automatic names (class name + per-class counter, in creation order).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from viddet_tpu_torch import quant
from viddet_tpu_torch.core.platform import conv_backend
from viddet_tpu_torch.core.precision import DEFAULT_POLICY, Policy
from viddet_tpu_torch.ops.conv_cuda import conv_down2_bn_leaky
from viddet_tpu_torch.parallel import mesh

BN_EPS = 1e-5
BN_MOMENTUM = 0.9  # Flax's: running = 0.9 * running + 0.1 * batch
LEAKY_SLOPE = 0.1
# Flax's ``nn.leaky_relu(x, 0.1)`` multiplies by 0.1 in x's dtype: in bf16 by
# bf16(0.1) = 0.10009765625.  K8 keeps LEAKY_SLOPE: it applies the slope to
# its float32 accumulator, as the JAX package's Pallas kernel does.
LEAKY_SLOPES = {torch.float32: LEAKY_SLOPE, torch.float64: LEAKY_SLOPE,
                torch.bfloat16: float(torch.tensor(LEAKY_SLOPE, dtype=torch.bfloat16))}


class FlaxNames:
    """Flax's automatic submodule names under ``prefix``, in creation order."""

    def __init__(self, prefix: str):
        self.prefix = prefix
        self.counts: dict[str, int] = {}

    def __call__(self, cls_name: str) -> str:
        i = self.counts.get(cls_name, 0)
        self.counts[cls_name] = i + 1
        return f"{self.prefix}/{cls_name}_{i}"


_CHANNEL_DIMS = (0, 2, 3)


def _per_channel(v: torch.Tensor) -> torch.Tensor:
    return v[:, None, None]


class GlobalBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm of an NCHW tensor over the global batch of the
    process group: ``apply(x, weight, bias, eps) -> (y, mean, var)``.

    Forward: each process's (count, mean, M2) per channel (a Welford pass,
    ``var_mean``), gathered in process order and merged by Chan's parallel
    formula (mean = sum n_p m_p / N, M2 = sum M2_p + n_p (m_p - mean)^2),
    the same sums in the same order on every process, so every process
    normalizes with the same bits.  The statistics and the affine run in
    float32 for a bf16 or float16 ``x`` (in its own dtype otherwise) and
    the output is rounded once to ``x``'s dtype.  ``mean`` and the biased
    ``var`` are for the running update and carry no gradient.

    Backward: the per-channel sums of ``dy`` and ``dy * (x - mean)`` are
    all-reduced and divided by the global count, as the global program's
    gradient needs; ``dweight`` and ``dbias`` stay this process's shares,
    which the gradient average over processes sums.  Each process's
    ``dy`` is that of its own loss, the global loss times the processes,
    so every gradient is the process count times its share and the average
    (``train/state.py``) is the global gradient.

    It does not round as ``native_batch_norm``'s one Welford pass over the
    whole batch does: the merged mean and M2 are a few float32 ulps from
    it."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        acc = torch.float32 if x.dtype in (torch.float16, torch.bfloat16) else x.dtype
        xf = x.to(acc)
        var, mean = torch.var_mean(xf, dim=_CHANNEL_DIMS, correction=0)
        n = float(x.numel() // x.shape[1])
        counts, means, m2s = mesh.all_gather_rows(
            torch.stack([torch.full_like(mean, n), mean, var * n])).unbind(1)
        total = counts.sum(0)
        gmean = (counts * means).sum(0) / total
        gvar = (m2s + counts * (means - gmean) ** 2).sum(0) / total
        invstd = torch.rsqrt(gvar + eps)
        scale = weight.to(acc) * invstd
        y = (xf * _per_channel(scale) + _per_channel(bias.to(acc) - gmean * scale)).to(x.dtype)
        ctx.save_for_backward(x, weight, gmean, invstd, total)
        ctx.mark_non_differentiable(gmean, gvar)
        return y, gmean, gvar

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, invstd, total = ctx.saved_tensors
        acc = mean.dtype
        dyf = dy.to(acc)
        xmu = x.to(acc) - _per_channel(mean)
        local = torch.stack([dyf.sum(_CHANNEL_DIMS), (dyf * xmu).sum(_CHANNEL_DIMS)])
        sums = local.clone()
        mesh.all_reduce_([sums])
        mean_dy, mean_dy_xmu = sums / total
        dx = (dyf - _per_channel(mean_dy) - xmu * _per_channel(invstd * invstd * mean_dy_xmu)) \
            * _per_channel(invstd * weight.to(acc))
        return (dx.to(x.dtype), (local[1] * invstd).to(weight.dtype), local[0].to(weight.dtype),
                None)


def batch_norm_train(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """Flax's train-mode ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` on an
    NCHW tensor: ``x`` normalized with its batch mean and biased variance,
    both in float32, then scaled, shifted and rounded once to its dtype;
    the running statistics become ``0.9 * running + 0.1 * batch``, with
    the biased variance (torch's own train-mode BatchNorm would fold in
    the unbiased one).

    The statistics come from ``native_batch_norm`` (one Welford pass in
    float32, differentiated by autograd), not from Flax's fast form
    ``E[x^2] - E[x]^2``: the same quantities, rounded otherwise, and more
    accurately (the fast form cancels where the mean is large against the
    spread).  The variance is recovered from the saved ``1 / sqrt(var +
    eps)`` for the running update.

    Under a process group of several processes the statistics are the
    global batch's, as JAX's single SPMD program computes them
    (``GlobalBatchNorm``), and the running statistics follow them, the
    same on every process; at one process the result is the above, bit
    for bit."""
    if mesh.process_count() > 1:
        y, mean, var = GlobalBatchNorm.apply(x, bn.weight, bn.bias, BN_EPS)
    else:
        y, mean, invstd = torch.native_batch_norm(x, bn.weight, bn.bias, None, None, True,
                                                  0.0, BN_EPS)
        var = None
    with torch.no_grad():
        if var is None:
            var = (invstd.pow(-2) - BN_EPS).clamp_min(0.0)
        bn.running_mean.copy_(BN_MOMENTUM * bn.running_mean + (1.0 - BN_MOMENTUM) * mean)
        bn.running_var.copy_(BN_MOMENTUM * bn.running_var + (1.0 - BN_MOMENTUM) * var)
    return y


def same_pads(size: int, window: int, stride: int) -> tuple[int, int]:
    """(low, high) padding of XLA's "SAME": the extra pixel goes high.

    A stride-2 3x3 conv on an even size pads (0, 1), where torch's
    ``padding=1`` would pad (1, 1).
    """
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, window: int, stride: int, value: float = 0.0):
    """Pad H and W of an NCHW tensor as "SAME" would; returns (x, pad)
    where ``pad`` is a symmetric padding left for the op itself."""
    ph = same_pads(x.shape[2], window, stride)
    pw = same_pads(x.shape[3], window, stride)
    if ph[0] == ph[1] == pw[0] == pw[1]:
        return x, ph[0]
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value), 0


class ConvBNLeaky(nn.Module, quant.Int8Cell):
    """kxk conv ("SAME", no bias) -> BatchNorm -> LeakyReLU(0.1).

    Under an int8 policy (``policy.quant == "int8"``) the cell carries a
    float32 ``act_amax`` buffer, and in eval mode runs the BN-folded int8
    conv of ``quant.py`` (leaky ReLU on its float32 epilogue) before any
    other route, as ``viddet_tpu/models/common.py:96-104`` does: K8 never
    runs under int8.  Inside ``quant.calibration()`` it records max|x| of
    its input, then takes the float path; train mode takes the float path.

    As in ``viddet_tpu/models/common.py:106-138``, in eval mode a stride-2
    3x3 layer with Cin < 256 on an even H and W runs K8
    ``conv_down2_bn_leaky`` (``ops/conv_cuda.py``) with its own conv and BN
    parameters when ``conv_backend()`` is "pallas": on Darknet-53 at 416 px
    the 32->64, 64->128 and 128->256 downsamples.  The default ("xla"), and
    every layer in train mode (K8 has no backward), is PyTorch's
    convolution, BatchNorm (``batch_norm_train`` in train mode) and leaky
    ReLU.
    """

    def __init__(self, cin: int, cout: int, kernel_size: int = 3, stride: int = 1,
                 policy: Policy = DEFAULT_POLICY, scope: str = ""):
        super().__init__()
        self.kernel_size, self.stride = kernel_size, stride
        self.policy, self.scope = policy, scope
        self.conv = nn.Conv2d(cin, cout, kernel_size, stride, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=BN_EPS)
        if policy.quant == "int8":
            self.register_buffer("act_amax", torch.zeros((), dtype=torch.float32))

    def fused_down2(self, x: torch.Tensor) -> bool:
        """Whether this call runs K8 (the JAX package's routing condition)."""
        return (not self.training and self.stride == 2 and self.kernel_size == 3
                and x.shape[1] < 256 and x.shape[2] % 2 == 0 and x.shape[3] % 2 == 0
                and conv_backend() == "pallas")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.policy.quant == "int8" and not self.training:
            if not quant.is_calibrating():
                return self.int8_forward(x, "leaky", self.policy.compute_dtype)
            self.record_range(x)
        if self.fused_down2(x):
            bn = self.bn
            return conv_down2_bn_leaky(x, self.conv.weight, bn.weight, bn.bias,
                                       bn.running_mean, bn.running_var, BN_EPS, LEAKY_SLOPE)
        cd = self.policy.compute_dtype
        x, pad = _pad_same(x, self.kernel_size, self.stride)
        x = F.conv2d(x, self.conv.weight.to(cd), stride=self.stride, padding=pad)
        # (x - mean) * (scale * rsqrt(var + eps)) + bias, computed in float32
        # inside the op and rounded to the compute dtype, as Flax does.
        bn = self.bn
        if self.training:
            x = batch_norm_train(x, bn)
        else:
            x = F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                             training=False, eps=BN_EPS)
        # in place under autograd too: leaky ReLU's backward reads its output
        return F.leaky_relu(x, LEAKY_SLOPES[x.dtype], inplace=True)


class BiasConv(nn.Module):
    """kxk stride-1 "SAME" conv with bias (Flax ``nn.Conv``), in the
    compute dtype: the conv rounds to it, then the bias is added in it, as
    Flax does.  Weights ``params/<scope>/{kernel,bias}``."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 1,
                 policy: Policy = DEFAULT_POLICY, scope: str = ""):
        super().__init__()
        self.kernel_size, self.policy, self.scope = kernel_size, policy, scope
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(cout))
        nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.policy.compute_dtype
        x, pad = _pad_same(x, self.kernel_size, 1)
        return F.conv2d(x, self.weight.to(cd), padding=pad) + self.bias.to(cd)[:, None, None]


class DarknetResidual(nn.Module):
    """1x1 (c/2) -> 3x3 (c) with additive skip: the Darknet-53 residual unit."""

    def __init__(self, channels: int, policy: Policy = DEFAULT_POLICY, scope: str = ""):
        super().__init__()
        names = FlaxNames(scope)
        self.reduce = ConvBNLeaky(channels, channels // 2, 1, policy=policy,
                                  scope=names("ConvBNLeaky"))
        self.expand = ConvBNLeaky(channels // 2, channels, 3, policy=policy,
                                  scope=names("ConvBNLeaky"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.expand(self.reduce(x)) + x


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x spatial upsample of an NCHW tensor."""
    return F.interpolate(x, scale_factor=2.0, mode="nearest")


def maxpool2d(x: torch.Tensor, window: int = 2, stride: int = 2) -> torch.Tensor:
    """"SAME" max-pool of an NCHW tensor; padding is -inf, high side first."""
    x, pad = _pad_same(x, window, stride, value=float("-inf"))
    return F.max_pool2d(x, window, stride, padding=pad)
