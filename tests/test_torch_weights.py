"""Weight bridge: JAX-package ``.npz`` schema <-> the PyTorch port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viddet_tpu.core.precision import FLOAT32_POLICY
from viddet_tpu.models.yolo3 import YOLOv3
from viddet_tpu.train.state import _flatten, save_weights_npz
from viddet_tpu_torch.cli.common import load_weights
from viddet_tpu_torch.core.precision import FLOAT32_POLICY as TORCH_F32
from viddet_tpu_torch.models.yolo3 import YOLOv3 as TorchYOLOv3
from viddet_tpu_torch.weights import init_flat, load_flat, to_flat


@pytest.fixture(scope="module")
def jax_flat():
    """The golden recipe's tiny model (tests/integration/test_golden.py:34-44)."""
    module = YOLOv3(num_classes=4, backbone="tiny", policy=FLOAT32_POLICY)
    x = jnp.zeros((1, 96, 96, 3), jnp.float32)
    variables = module.init(jax.random.key(99), x, train=False)
    flat = _flatten({"params": variables["params"]})
    flat.update(_flatten({"batch_stats": variables["batch_stats"]}))
    return variables, flat


def _tiny():
    return TorchYOLOv3(num_classes=4, backbone="tiny", policy=TORCH_F32).eval()


def test_round_trip_is_byte_equal(jax_flat, tmp_path):
    variables, flat = jax_flat
    path = str(tmp_path / "tiny.npz")
    save_weights_npz(path, variables["params"], variables["batch_stats"])
    model = load_weights(_tiny(), path)
    back = to_flat(model)
    assert sorted(back) == sorted(flat)
    for key, want in flat.items():
        got = back[key]
        assert got.dtype == want.dtype and got.shape == want.shape, key
        assert got.tobytes() == want.tobytes(), key


def test_conv_kernel_layout(jax_flat):
    _, flat = jax_flat
    model = _tiny()
    load_flat(model, flat)
    key = "params/DarknetTiny_0/ConvBNLeaky_1/Conv_0/kernel"
    hwio = flat[key]
    conv = model.backbone.cells[1].conv.weight.detach().numpy()
    np.testing.assert_array_equal(conv, hwio.transpose(3, 2, 0, 1))
    head = model.head.outputs[0]
    np.testing.assert_array_equal(head.bias.detach().numpy(),
                                  flat["params/YOLOv3Head_0/output_0/bias"])


@pytest.mark.parametrize("change", ["missing", "extra"])
def test_unmapped_or_missing_key_raises(jax_flat, change):
    _, flat = jax_flat
    bad = dict(flat)
    if change == "missing":
        bad.pop("batch_stats/YOLOv3Head_0/ConvBNLeaky_2/BatchNorm_0/var")
    else:
        bad["params/YOLOv3Head_0/output_9/kernel"] = np.zeros((1, 1, 8, 27), np.float32)
    with pytest.raises(KeyError):
        load_flat(_tiny(), bad)


def test_shape_mismatch_raises(jax_flat):
    _, flat = jax_flat
    bad = dict(flat)
    key = "params/YOLOv3Head_0/output_1/bias"
    bad[key] = np.zeros(bad[key].shape[0] + 1, np.float32)
    with pytest.raises(ValueError):
        load_flat(_tiny(), bad)


def test_init_flat_matches_jax_schema():
    """Seeded weights for the card carry exactly the JAX init's keys and
    shapes, so they load into either package."""
    module = YOLOv3(num_classes=80, backbone="tiny")
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.key(0), jnp.zeros((1, 64, 64, 3)), train=False)
    )
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    want = _flatten({"params": zeros["params"]})
    want.update(_flatten({"batch_stats": zeros["batch_stats"]}))
    got = init_flat("yolo3_tiny_darknet_coco", seed=3)
    assert sorted(got) == sorted(want)
    for key, arr in got.items():
        assert arr.shape == want[key].shape and arr.dtype == np.float32, key
    again = init_flat("yolo3_tiny_darknet_coco", seed=3)
    assert all(np.array_equal(again[k], v) for k, v in got.items())
    kernel = got["params/DarknetTiny_0/ConvBNLeaky_3/Conv_0/kernel"]
    fan_in = np.prod(kernel.shape[:-1])
    assert abs(kernel.std() * np.sqrt(fan_in) - 1.0) < 0.05  # lecun-normal scale
    assert np.abs(kernel).max() <= 2.0 / 0.87962566103423978 / np.sqrt(fan_in) + 1e-7


def test_init_flat_round_trip_through_get_model():
    """init_flat -> load_flat -> to_flat returns the same arrays."""
    flat = init_flat("yolo3_tiny_darknet_coco", seed=1)
    from viddet_tpu_torch.models.zoo import get_model

    model, classes = get_model("yolo3_tiny_darknet_coco", device="cpu")
    assert len(classes) == 80
    load_flat(model, flat)
    back = to_flat(model)
    assert all(back[k].tobytes() == v.tobytes() for k, v in flat.items())
    assert next(model.parameters()).device == torch.device("cpu")
