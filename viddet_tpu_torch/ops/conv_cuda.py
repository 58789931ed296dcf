"""K8 ``conv_down2_bn_leaky``: stride-2 3x3 convolution, folded inference
BatchNorm and leaky ReLU in one kernel.

Replaces ``viddet_tpu/ops/conv_pallas.py:91`` ``conv_down2_bn_leaky``
(``_kernel_pairview``, ``:34``); its CUDA kernels are in
``csrc/conv_down2.cu``, whose header says what bounds them on an H100 and
how the design answers that.  The route is chosen by shape alone
(``route``): bf16 with Cin % 4 == 0, Cout % 8 == 0 and a 16-byte aligned
x runs the TMA-fed ``wgmma`` kernel on the schedule of 64-channel chunks
that ``k_schedule`` lists, on tiles of ``tile_shape`` pixels by ``tile_n``
channels; other bf16 shapes run the scalar-fill kernel, float32 its FMA
kernel.  ``conv_down2_bn_leaky_plain`` follows the JAX package's oracle
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

The kernel is the custom op ``viddet::conv_down2_bn_leaky``
(``ops/__init__.py``): its CUDA implementation launches it, so that an
artifact exported under ``VIDDET_CONV_BACKEND=pallas`` carries it.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from viddet_tpu_torch.kernels import build, on_card, require

MAX_CIN = 255  # the routing's Cin < 256 (viddet_tpu/models/common.py:111)
CHUNK = 64  # channels of one TMA box: 128 bytes of bf16, one swizzle span
TILE_M = 256  # output pixels of one tile: two warpgroups of 2 x 64
# (rows, columns) of output pixels a tile may take, in order of preference
TILE_SHAPES = ((16, 16), (8, 32), (32, 8), (4, 64), (64, 4), (2, 128))


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


def k_schedule(cin: int) -> list[tuple[int, int, int, int, int, int]]:
    """The TMA kernel's reduction, one entry per 64-channel chunk.

    In the pair view (B, H/2, 2, W/2, 2*Cin) of x, kernel row dy reads
    pair row ``oy + dy // 2`` at parity ``dy % 2``: the taps dx = 0, 1 are
    channels [0, 2*Cin) of pair column ``ox``, the tap dx = 2 channels
    [0, Cin) of pair column ``ox + 1``.  Each entry is (pair-row offset,
    parity, pair-column offset, first channel, width, first weight row),
    the weight rows being those of the (9*Cin, Cout) matrix in (dy, dx,
    ci) order.  The kernel loads 64 channels for every chunk; those past
    the box (2*Cin or Cin) are out of the tensor map and read as zero."""
    out = []
    for dy in range(3):
        for col, span, row0 in ((0, 2 * cin, 3 * cin * dy), (1, cin, 3 * cin * dy + 2 * cin)):
            for c0 in range(0, span, CHUNK):
                out.append((dy // 2, dy % 2, col, c0, min(CHUNK, span - c0), row0 + c0))
    return out


def tile_waste(h2: int, w2: int, r: int, c: int) -> float:
    """Share of a layer's tile pixels that lie past the output's edge."""
    return 1.0 - h2 * w2 / (-(-h2 // r) * r * -(-w2 // c) * c)


def tile_shape(h2: int, w2: int) -> tuple[int, int]:
    """The (rows, columns) of ``TILE_SHAPES`` that wastes the fewest
    padded pixels on an (h2, w2) output; the first of equals."""
    return min(TILE_SHAPES, key=lambda rc: tile_waste(h2, w2, *rc))


def tile_n(cout: int) -> int:
    """Output channels of a tile: one ``wgmma`` width, 64 where Cout fits
    in it, else 128 (the widest whose four-stage ring fits in shared
    memory)."""
    return 64 if cout <= 64 else 128


def route(x: torch.Tensor, cout: int) -> str:
    """Which K8 kernel a CUDA call runs: "tma" where the tensor maps can
    describe the shape (bf16, Cin % 4 == 0 so a pair column is a multiple
    of 16 bytes, Cout % 8 == 0, x 16-byte aligned), else "scalar" (bf16)
    or "f32"."""
    if x.dtype == torch.float32:
        return "f32"
    if x.shape[1] % 4 == 0 and cout % 8 == 0 and x.data_ptr() % 16 == 0:
        return "tma"
    return "scalar"


def conv_down2_bn_leaky(x, weight, scale, bias, mean, var, eps: float = 1e-5,
                        negative_slope: float = 0.1) -> torch.Tensor:
    """K8 wrapper: the kernel for CUDA tensors, the plain version on the CPU.

    Raises for a CUDA x with odd H or W, Cin > MAX_CIN, a dtype other
    than bfloat16 or float32, or a layout other than channels_last."""
    if x.device.type == "cpu":
        return conv_down2_bn_leaky_plain(x, weight, scale, bias, mean, var, eps,
                                         negative_slope)
    on_card(x, "conv_down2_bn_leaky")
    return torch.ops.viddet.conv_down2_bn_leaky(x, weight, scale, bias, mean, var, float(eps),
                                                float(negative_slope))


@torch.library.custom_op("viddet::conv_down2_bn_leaky", mutates_args=(), device_types="cpu")
def _conv_down2_op(x: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor, mean: torch.Tensor, var: torch.Tensor, eps: float,
                   negative_slope: float) -> torch.Tensor:
    return conv_down2_bn_leaky_plain(x, weight, scale, bias, mean, var, eps, negative_slope)


@_conv_down2_op.register_kernel("cuda")
def _conv_down2_cuda(x, weight, scale, bias, mean, var, eps, negative_slope):
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
    sched, nsched, tile, packed = None, 0, (0, 0, 0), None
    if route(x, cout) == "tma":
        schedule = k_schedule(cin)
        nsched = len(schedule)
        sched = (ctypes.c_int * (6 * nsched))(*(v for e in schedule for v in e))
        tile = (*tile_shape(h // 2, w // 2), tile_n(cout))
        # the kernel packs the weights into this scratch: K-major (Cout,
        # 64 * chunks), chunk j's weight rows at columns [64 j, 64 j + width)
        wmat = weight if weight.dtype in (torch.float32, torch.bfloat16) else weight.float()
        wmat = wmat.contiguous()
        require(wmat, "weight", wmat.dtype, device=x.device)
        packed = torch.empty((cout, CHUNK * nsched), dtype=x.dtype, device=x.device)
    else:
        # (Cout, Cin, 3, 3) -> (9*Cin, Cout), rows in (dy, dx, cin) order
        # (conv_pallas.py:120-122), in x's dtype.
        wmat = weight.to(x.dtype).permute(2, 3, 1, 0).reshape(9 * cin, cout).contiguous()
        require(wmat, "weight", x.dtype, device=x.device)
    out = torch.empty((b, cout, h // 2, w // 2), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    err = build.library().viddet_conv_down2_bn_leaky(
        x.data_ptr(), wmat.data_ptr(), int(wmat.dtype == torch.bfloat16), a.data_ptr(),
        bb.data_ptr(), b, h, w, cin, cout, float(negative_slope), int(x.dtype == torch.bfloat16),
        None if sched is None else ctypes.addressof(sched), nsched, *tile,
        None if packed is None else packed.data_ptr(), out.data_ptr(), build.stream_of(out),
    )
    build.check(err, "conv_down2_bn_leaky")
    conv_down2_bn_leaky.launches += 1
    return out



@_conv_down2_op.register_fake
def _(x, weight, scale, bias, mean, var, eps, negative_slope):
    _check_even(x)
    b, _, h, w = x.shape
    return torch.empty((b, weight.shape[0], h // 2, w // 2), dtype=x.dtype, device=x.device,
                       memory_format=torch.channels_last)


conv_down2_bn_leaky.launches = 0
