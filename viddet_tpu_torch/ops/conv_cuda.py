"""K8 ``conv_down2_bn_leaky``: stride-2 3x3 convolution, folded inference
BatchNorm and leaky ReLU in one kernel.

Replaces ``viddet_tpu/ops/conv_pallas.py:91`` ``conv_down2_bn_leaky``
(``_kernel_pairview``, ``:34``); its CUDA kernel is ``csrc/conv_down2.cu``,
whose header says what bounds it on an H100 and how its design answers
that.  ``conv_down2_bn_leaky_plain`` follows the JAX package's oracle
``conv_down2_bn_leaky_reference`` (``:169-189``); the wrapper runs it for
a CPU tensor, and for a CUDA tensor it launches the kernel or raises.

Semantics, as in JAX ("SAME" for a stride-2 3x3 window on an even size):
the input is zero-padded by one row and one column at the high side only,
``out[i, j] = sum_{dy, dx} x[2i+dy, 2j+dx] . W[dy, dx]``, then
``y = conv * a + b`` with ``a = scale * rsqrt(var + eps)`` and
``b = bias - mean * a`` in float32, then ``where(y >= 0, y, y * slope)``,
rounded once to x's dtype.  The weights are rounded to x's dtype first, as
Flax's compute-dtype convolution does.

Layouts are the port's: x (B, Cin, H, W) in ``torch.channels_last`` memory
(the JAX package's NHWC), weight (Cout, Cin, 3, 3) as ``nn.Conv2d`` keeps
it; the result is (B, Cout, H/2, W/2), channels_last.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from viddet_tpu_torch.kernels import build, require

MAX_CIN = 255  # the routing's Cin < 256 (viddet_tpu/models/common.py:111)


def fold_bn(scale, bias, mean, var, eps: float):
    """The folded inference affine (``conv_pallas.py:116-118``), float32."""
    a = scale.float() * torch.rsqrt(var.float() + eps)
    return a, bias.float() - mean.float() * a


def _check_even(x: torch.Tensor) -> None:
    if x.dim() != 4 or x.shape[2] % 2 or x.shape[3] % 2:
        raise ValueError(f"conv_down2_bn_leaky: x must be (B, C, H, W) with H, W even, "
                         f"got {tuple(x.shape)}")


def conv_down2_bn_leaky_plain(x, weight, scale, bias, mean, var, eps: float = 1e-5,
                              negative_slope: float = 0.1) -> torch.Tensor:
    """The JAX oracle in plain PyTorch: the convolution in float32 on
    float32 copies of x and of the weights rounded to x's dtype (exact for
    bf16), TF32 off, then the affine and leaky ReLU in float32."""
    _check_even(x)
    a, b = fold_bn(scale, bias, mean, var, eps)
    w = weight.to(x.dtype).float()
    xf = F.pad(x.float(), (0, 1, 0, 1))
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        y = F.conv2d(xf, w, stride=2)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    y = y * a[:, None, None] + b[:, None, None]
    y = torch.where(y >= 0, y, y * negative_slope)
    return y.to(x.dtype).contiguous(memory_format=torch.channels_last)


def conv_down2_bn_leaky(x, weight, scale, bias, mean, var, eps: float = 1e-5,
                        negative_slope: float = 0.1) -> torch.Tensor:
    """K8 wrapper: the kernel for CUDA tensors, the plain version on the CPU.

    Raises for a CUDA x with odd H or W, Cin > MAX_CIN, a dtype other
    than bfloat16 or float32, or a layout other than channels_last."""
    if x.device.type == "cpu":
        return conv_down2_bn_leaky_plain(x, weight, scale, bias, mean, var, eps,
                                         negative_slope)
    _check_even(x)
    b, cin, h, w = x.shape
    if cin > MAX_CIN:
        raise ValueError(f"conv_down2_bn_leaky: Cin={cin} exceeds the kernel's {MAX_CIN}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"conv_down2_bn_leaky: dtype {x.dtype} is not bfloat16 or float32")
    if x.device.type != "cuda" or not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("conv_down2_bn_leaky: x must be a channels_last CUDA tensor")
    cout = weight.shape[0]
    if tuple(weight.shape) != (cout, cin, 3, 3):
        raise ValueError(f"conv_down2_bn_leaky: weight must be (Cout, {cin}, 3, 3), "
                         f"got {tuple(weight.shape)}")
    a, bb = (t.contiguous() for t in fold_bn(scale, bias, mean, var, eps))
    for name, t in (("a", a), ("b", bb)):
        require(t, name, torch.float32, shape=(cout,), device=x.device)
    # (Cout, Cin, 3, 3) -> (9*Cin, Cout), rows in (dy, dx, cin) order
    # (conv_pallas.py:120-122), in x's dtype.
    wmat = weight.to(x.dtype).permute(2, 3, 1, 0).reshape(9 * cin, cout).contiguous()
    require(wmat, "weight", x.dtype, device=x.device)
    out = torch.empty((b, cout, h // 2, w // 2), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    err = build.library().viddet_conv_down2_bn_leaky(
        x.data_ptr(), wmat.data_ptr(), a.data_ptr(), bb.data_ptr(), b, h, w, cin, cout,
        float(negative_slope), int(x.dtype == torch.bfloat16), out.data_ptr(),
        build.stream_of(out),
    )
    build.check(err, "conv_down2_bn_leaky")
    conv_down2_bn_leaky.launches += 1
    return out


conv_down2_bn_leaky.launches = 0
