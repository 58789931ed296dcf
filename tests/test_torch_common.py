"""The port's ConvBNLeaky activation against Flax's ``nn.leaky_relu``.

Flax multiplies the negative side by the slope in the activation's own
dtype (bf16(0.1) = 0.10009765625 under the default bf16 policy), so the
port's activation must equal it bit for bit on the same values, in bf16 and
in float32.
"""

import flax.linen as nn
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viddet_tpu_torch.core.precision import DEFAULT_POLICY, FLOAT32_POLICY
from viddet_tpu_torch.models.common import LEAKY_SLOPE, LEAKY_SLOPES, ConvBNLeaky


def _values(n=1 << 16, seed=0):
    """Seeded float32 values over many binades, both signs, and 0 / -0."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32) * np.exp2(rng.integers(-20, 20, n))
    x[:4] = (0.0, -0.0, 1.0, -1.0)
    return x.astype(np.float32)


def test_bf16_slope_is_flax_rounding():
    assert LEAKY_SLOPES[torch.bfloat16] == 0.10009765625
    assert LEAKY_SLOPES[torch.float32] == LEAKY_SLOPE == 0.1


@pytest.mark.parametrize("policy", [DEFAULT_POLICY, FLOAT32_POLICY], ids=["bf16", "f32"])
def test_conv_bn_leaky_activation_equals_flax(policy):
    """An identity 1x1 conv and BatchNorm, so the layer's output is the
    activation of its bf16- (or float32-) rounded input."""
    dtype = policy.compute_dtype
    layer = ConvBNLeaky(1, 1, kernel_size=1, policy=policy).eval()
    with torch.no_grad():
        layer.conv.weight.fill_(1.0)
        layer.bn.running_var.fill_(1.0 - 1e-5)  # rsqrt(var + eps) = 1
    x = torch.from_numpy(_values()).to(dtype)
    with torch.inference_mode():
        got = layer(x.view(1, 1, 1, -1)).flatten()
    want = nn.leaky_relu(jnp.asarray(x.float().numpy()).astype(jnp.dtype(str(dtype)[6:])), 0.1)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want).astype(np.float32))
    assert (got < 0).sum() > 1000  # the negative side is exercised
