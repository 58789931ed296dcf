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
