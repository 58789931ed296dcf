"""K8 ``conv_down2_bn_leaky`` and the conv backend of the port against the
JAX package.

The plain version is held to the Pallas kernel in interpret mode and to
``conv_down2_bn_leaky_reference`` at the shapes and tolerances of
``tests/unit/test_conv_pallas.py``: float32 at rtol/atol 1e-5 (the
convolutions sum in another order), bf16 at 5e-2.  Darknet-53 at 64 px in
float32 with the K8 route holds JAX's ``pallas_interpret`` route at
rtol/atol 2e-4, as ``test_conv_pallas.py:86-108`` holds JAX's two routes,
with the same ``.npz`` weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viddet_tpu.core import platform as jax_platform
from viddet_tpu.core.precision import FLOAT32_POLICY as JAX_F32
from viddet_tpu.models.darknet import Darknet53 as JaxDarknet53
from viddet_tpu.ops.conv_pallas import conv_down2_bn_leaky as jax_conv_down2
from viddet_tpu.ops.conv_pallas import conv_down2_bn_leaky_reference
from viddet_tpu.train.state import save_weights_npz
from viddet_tpu_torch.core import platform
from viddet_tpu_torch.core.precision import FLOAT32_POLICY as TORCH_F32
from viddet_tpu_torch.models import common
from viddet_tpu_torch.models.darknet import Darknet53
from viddet_tpu_torch.ops import conv_cuda
from viddet_tpu_torch.ops.conv_cuda import conv_down2_bn_leaky, conv_down2_bn_leaky_plain
from viddet_tpu_torch.weights import load_flat


def _rand_case(rng, b, h, w, cin, cout):
    """tests/unit/test_conv_pallas.py:19: NHWC x, HWIO kernel, BN vectors."""
    x = rng.normal(size=(b, h, w, cin)).astype(np.float32)
    k = (rng.normal(size=(3, 3, cin, cout)) * 0.1).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, cout).astype(np.float32)
    bias = rng.normal(size=cout).astype(np.float32)
    mean = (rng.normal(size=cout) * 0.1).astype(np.float32)
    var = rng.uniform(0.5, 2.0, cout).astype(np.float32)
    return x, k, scale, bias, mean, var


def _torch_args(x, k, *vecs, dtype=torch.float32):
    """NHWC -> the port's channels_last NCHW; HWIO -> (Cout, Cin, 3, 3)."""
    tx = torch.from_numpy(x).to(dtype).permute(0, 3, 1, 2)
    assert tx.is_contiguous(memory_format=torch.channels_last)
    return (tx, torch.from_numpy(k.transpose(3, 2, 0, 1).copy()),
            *(torch.from_numpy(v) for v in vecs))


def _nhwc(y):
    return y.permute(0, 2, 3, 1).float().numpy()


@pytest.mark.parametrize("shape", [(2, 16, 16, 8, 16), (1, 32, 32, 32, 64), (2, 26, 26, 64, 128)])
def test_conv_down2_plain_matches_pallas_and_oracle(shape):
    args = _rand_case(np.random.default_rng(0), *shape)
    got = conv_down2_bn_leaky(*_torch_args(*args))
    assert got.dtype == torch.float32 and got.is_contiguous(memory_format=torch.channels_last)
    b, h, w, _, cout = shape
    assert tuple(got.shape) == (b, cout, h // 2, w // 2)
    jargs = [jnp.asarray(a) for a in args]
    for want in (jax_conv_down2(*jargs, interpret=True), conv_down2_bn_leaky_reference(*jargs)):
        np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_conv_down2_plain_bf16_close():
    """tests/unit/test_conv_pallas.py:44: bf16 input, weights rounded to bf16."""
    args = _rand_case(np.random.default_rng(1), 2, 32, 32, 32, 64)
    got = conv_down2_bn_leaky(*_torch_args(*args, dtype=torch.bfloat16))
    assert got.dtype == torch.bfloat16
    x = jnp.asarray(args[0]).astype(jnp.bfloat16)
    jargs = [jnp.asarray(a) for a in args[1:]]
    for want in (jax_conv_down2(x, *jargs, interpret=True),
                 conv_down2_bn_leaky_reference(x, *jargs)):
        np.testing.assert_allclose(_nhwc(got), np.asarray(want, np.float32), rtol=5e-2,
                                   atol=5e-2)


def test_conv_down2_rejects_odd_sizes():
    args = _torch_args(*_rand_case(np.random.default_rng(2), 1, 10, 9, 8, 8))
    with pytest.raises(ValueError, match="even"):
        conv_down2_bn_leaky_plain(*args)
    with pytest.raises(ValueError, match="even"):
        conv_down2_bn_leaky(*args)


# ------------------------------------------------------------------ routing


@pytest.fixture
def conv_backend_reset():
    yield
    platform.set_conv_backend("auto")


def _routed_layers(model, x, monkeypatch):
    """(Cin, Cout, H) of every ConvBNLeaky call that runs K8."""
    seen = []
    real = common.conv_down2_bn_leaky

    def spy(x, weight, *args):
        seen.append((x.shape[1], weight.shape[0], x.shape[2]))
        return real(x, weight, *args)

    monkeypatch.setattr(common, "conv_down2_bn_leaky", spy)
    with torch.inference_mode():
        model(x)
    return seen


def test_pallas_backend_routes_the_shallow_downsamples(monkeypatch, conv_backend_reset):
    """Darknet-53: stride 2, 3x3, Cin < 256 and an even size route; the
    256->512 and 512->1024 downsamples and every stride-1 layer do not."""
    model = Darknet53(TORCH_F32).to(memory_format=torch.channels_last).eval()
    x = torch.zeros((1, 3, 64, 64)).contiguous(memory_format=torch.channels_last)
    monkeypatch.delenv("VIDDET_CONV_BACKEND", raising=False)
    assert platform.conv_backend() == "xla"
    assert _routed_layers(model, x, monkeypatch) == []
    monkeypatch.setenv("VIDDET_CONV_BACKEND", "pallas")
    assert _routed_layers(model, x, monkeypatch) == [(32, 64, 64), (64, 128, 32), (128, 256, 16)]
    platform.set_conv_backend("xla")  # the pin wins over the environment
    assert _routed_layers(model, x, monkeypatch) == []


@pytest.mark.parametrize("value", ["palas", "pallas_interpret", "cuda"])
def test_unknown_conv_backend_raises(monkeypatch, conv_backend_reset, value):
    monkeypatch.setenv("VIDDET_CONV_BACKEND", value)
    with pytest.raises(ValueError, match="VIDDET_CONV_BACKEND"):
        platform.conv_backend()
    layer = common.ConvBNLeaky(8, 16, 3, stride=2, policy=TORCH_F32).eval()
    with pytest.raises(ValueError):
        layer(torch.zeros((1, 8, 8, 8)))
    with pytest.raises(ValueError):
        platform.set_conv_backend(value)


def test_darknet53_k8_route_matches_jax_pallas_interpret(tmp_path, conv_backend_reset):
    """The whole backbone at 64 px in float32, one .npz of weights with
    perturbed BN statistics for both packages."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(1, 64, 64, 3)).astype(np.float32)
    module = JaxDarknet53(policy=JAX_F32)
    variables = jax.tree_util.tree_map(np.asarray, module.init(jax.random.key(0), x, False))

    def perturb(path, v):
        if path[-1].key == "mean":
            return (rng.normal(size=v.shape) * 0.1).astype(np.float32)
        return rng.uniform(0.5, 2.0, v.shape).astype(np.float32)

    variables["batch_stats"] = jax.tree_util.tree_map_with_path(perturb, variables["batch_stats"])
    path = str(tmp_path / "darknet53.npz")
    save_weights_npz(path, variables["params"], variables["batch_stats"])
    jax_platform.set_conv_backend("pallas_interpret")
    try:
        want = module.apply(variables, jnp.asarray(x), False)
    finally:
        jax_platform.set_conv_backend("auto")

    model = Darknet53(TORCH_F32).to(memory_format=torch.channels_last).eval()
    with np.load(path) as data:  # the bare backbone's keys, under the model's scope
        load_flat(model, {k.replace("/", "/Darknet53_0/", 1): data[k] for k in data.files})
    platform.set_conv_backend("pallas")
    with torch.inference_mode():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(_nhwc(g), np.asarray(w), rtol=2e-4, atol=2e-4)


# ------------------------------------------------------------------ the TMA kernel's plan
# The card's K8 kernel reduces over the 64-channel chunks that
# ``k_schedule`` lists, each a box of the pair view (B, H/2, 2, W/2, 2*Cin)
# whose out-of-bounds cells (the SAME pad, a ragged chunk's channels past
# the box) read as zero, times the matching columns of the weights as the
# kernel's ``pack_weights_kernel`` packs them (``pack_weight``).  Here that
# reduction runs in numpy with the same out-of-bounds rule.

K8_PATH_LAYERS = ((32, 64, 416), (64, 128, 208), (128, 256, 104))  # (Cin, Cout, H = W)


def pack_weight(weight: torch.Tensor, schedule, dtype) -> torch.Tensor:
    """(Cout, Cin, 3, 3) -> the TMA kernel's K-major (Cout, 64 * chunks):
    chunk j's weight rows at columns [64 j, 64 j + width), zeros after."""
    cout, cin = weight.shape[:2]
    wmat = weight.to(dtype).permute(0, 2, 3, 1).reshape(cout, 9 * cin)  # (dy, dx, ci) order
    packed = wmat.new_zeros((cout, conv_cuda.CHUNK * len(schedule)))
    for j, (*_, width, row0) in enumerate(schedule):
        packed[:, conv_cuda.CHUNK * j:conv_cuda.CHUNK * j + width] = wmat[:, row0:row0 + width]
    return packed


def _schedule_conv(x, packed, schedule):
    """sum over chunks of box(x) @ packed chunk, float64, out (B, H2, W2, Cout)."""
    b, h, w, cin = x.shape
    h2, w2 = h // 2, w // 2
    pair = x.astype(np.float64).reshape(b, h2, 2, w2, 2 * cin)
    # one pair row and column past the edge, channels past the widest box: all zero
    padded = np.zeros((b, h2 + 1, 2, w2 + 1, 2 * cin + conv_cuda.CHUNK))
    padded[:, :h2, :, :w2, :2 * cin] = pair
    acc = np.zeros((b, h2, w2, packed.shape[0]))
    for j, (row, parity, col, c0, _, _) in enumerate(schedule):
        extent = cin if col else 2 * cin  # the map's channels: past them reads zero
        box = padded[:, row:row + h2, parity, col:col + w2, c0:c0 + conv_cuda.CHUNK].copy()
        box[..., max(0, extent - c0):] = 0.0
        acc += box @ packed[:, conv_cuda.CHUNK * j:conv_cuda.CHUNK * (j + 1)].T.astype(np.float64)
    return acc


@pytest.mark.parametrize("b,cin,cout,h,w", [
    *((1, cin, cout, hw, hw) for cin, cout, hw in K8_PATH_LAYERS),
    (2, 4, 8, 18, 26), (1, 40, 24, 26, 18), (1, 248, 16, 18, 18), (2, 96, 64, 10, 14),
    (1, 192, 264, 6, 22),
])
def test_tma_schedule_reproduces_the_plain_conv(b, cin, cout, h, w):
    """The chunk boxes with their zero fill, times the packed weights, then
    the affine and leaky ReLU, equal the plain version in float32 within
    1e-5 of the sum of |products| (the orders of summation differ)."""
    x, k, *vecs = _rand_case(np.random.default_rng(cin + cout), b, h, w, cin, cout)
    tx, tw, *tvecs = _torch_args(x, k, *vecs)
    schedule = conv_cuda.k_schedule(cin)
    packed = pack_weight(tw, schedule, torch.float32).numpy()
    acc = _schedule_conv(x, packed, schedule)
    a, bb = (t.numpy().astype(np.float64) for t in conv_cuda.fold_bn(*tvecs, 1e-5))
    y = acc * a + bb
    got = np.where(y >= 0, y, y * 0.1)
    want = _nhwc(conv_down2_bn_leaky_plain(tx, tw, *tvecs))
    abs_sum = _schedule_conv(np.abs(x), np.abs(packed), schedule) * np.abs(a)
    np.testing.assert_array_less(np.abs(got - want), 1e-5 * abs_sum + 1e-6)


@pytest.mark.parametrize("cin", [1, 4, 8, 32, 40, 64, 96, 128, 192, 248, 255])
def test_tma_schedule_covers_each_weight_row_once(cin):
    schedule = conv_cuda.k_schedule(cin)
    rows = [r for *_, width, row0 in schedule for r in range(row0, row0 + width)]
    assert sorted(rows) == list(range(9 * cin))
    assert len(schedule) <= 36  # the kernel's kMaxChunks
    for row, parity, col, c0, width, row0 in schedule:
        dy = 2 * row + parity
        assert c0 % conv_cuda.CHUNK == 0 and 1 <= width <= conv_cuda.CHUNK
        # weight row (dy, dx, ci) of the box's first channel
        assert row0 == 3 * cin * dy + (2 * cin if col else 0) + c0
        assert c0 + width == min(c0 + conv_cuda.CHUNK, cin if col else 2 * cin)
    w = torch.randn((8, cin, 3, 3), generator=torch.Generator().manual_seed(cin))
    packed = pack_weight(w, schedule, torch.float32)
    wmat = w.permute(0, 2, 3, 1).reshape(8, 9 * cin)
    for j, (*_, width, row0) in enumerate(schedule):
        chunk = packed[:, conv_cuda.CHUNK * j:conv_cuda.CHUNK * (j + 1)]
        assert torch.equal(chunk[:, :width], wmat[:, row0:row0 + width])
        assert not chunk[:, width:].any()


def test_tma_tile_shapes_of_the_path_layers():
    """256-pixel tiles: exact at 208 x 208, 13.8 % padded pixels at
    104 x 104, 18.75 % at 52 x 52; each warpgroup's half is whole rows;
    64 output channels a tile where Cout fits, else 128."""
    got = [conv_cuda.tile_shape(hw // 2, hw // 2) for _, _, hw in K8_PATH_LAYERS]
    assert got == [(16, 16), (16, 16), (4, 64)]
    assert [conv_cuda.tile_n(cout) for _, cout, _ in K8_PATH_LAYERS] == [64, 128, 128]
    assert [conv_cuda.tile_n(cout) for cout in (8, 64, 72, 264)] == [64, 64, 128, 128]
    wastes = [conv_cuda.tile_waste(hw // 2, hw // 2, *rc) for (_, _, hw), rc
              in zip(K8_PATH_LAYERS, got)]
    np.testing.assert_allclose(wastes, [0.0, 1 - 104 ** 2 / 112 ** 2, 0.1875])
    assert all(r * c == conv_cuda.TILE_M and r % 2 == 0 for r, c in conv_cuda.TILE_SHAPES)


def test_route_by_shape():
    def x(cin, dtype=torch.bfloat16):
        return torch.zeros((1, cin, 4, 4), dtype=dtype).contiguous(
            memory_format=torch.channels_last)

    assert conv_cuda.route(x(32), 64) == "tma"
    assert conv_cuda.route(x(4), 8) == "tma"
    assert conv_cuda.route(x(6), 8) == "scalar"  # a pair column of 24 bytes
    assert conv_cuda.route(x(8), 12) == "scalar"  # an output row of 24 bytes
    assert conv_cuda.route(x(32, torch.float32), 64) == "f32"
