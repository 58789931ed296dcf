"""Weight bridge between the JAX package's ``.npz`` schema and the port.

The schema is ``viddet_tpu/train/state.py:122-134``: flat keys
``params/<flax scope>/<leaf>`` and ``batch_stats/<flax scope>/<leaf>``
holding numpy arrays.  Each module of the port that owns parameters
records its Flax scope, so the mapping is per module:

* ``ConvBNLeaky`` and ``ConvBN``: ``Conv_0/kernel`` (HWIO) ->
  ``conv.weight`` (OIHW); ``BatchNorm_0/scale``, ``bias`` -> ``bn.weight``,
  ``bn.bias``; batch_stats ``mean``, ``var`` -> ``bn.running_mean``,
  ``bn.running_var``;
* ``BiasConv`` (YOLO's ``output_{i}``, the FPN's ``lateral_{i}`` /
  ``post_{i}``, the RPN's convs): ``kernel`` (HWIO) / ``bias`` -> its
  weight (OIHW) / bias;
* ``Dense`` (the Faster R-CNN box head): ``kernel`` (in, out) -> its
  weight (out, in), ``bias`` -> bias.

A key the model lacks, or a key the model needs and the file lacks, raises.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

from viddet_tpu_torch.models.common import BiasConv, ConvBNLeaky
from viddet_tpu_torch.models.faster_rcnn import Dense
from viddet_tpu_torch.models.resnet import ConvBN


def leaves(model: torch.nn.Module) -> Iterator[Tuple[str, torch.Tensor, str]]:
    """(npz key, tensor, kind) for every parameter and statistic, where kind
    is "conv" for an OIHW conv kernel, "dense" for an (out, in) dense
    weight and "vec" for everything else."""
    for m in model.modules():
        if isinstance(m, (ConvBNLeaky, ConvBN)):
            p, s = f"params/{m.scope}", f"batch_stats/{m.scope}"
            yield f"{p}/Conv_0/kernel", m.conv.weight, "conv"
            yield f"{p}/BatchNorm_0/scale", m.bn.weight, "vec"
            yield f"{p}/BatchNorm_0/bias", m.bn.bias, "vec"
            yield f"{s}/BatchNorm_0/mean", m.bn.running_mean, "vec"
            yield f"{s}/BatchNorm_0/var", m.bn.running_var, "vec"
        elif isinstance(m, (BiasConv, Dense)):
            yield f"params/{m.scope}/kernel", m.weight, "conv" if m.weight.dim() == 4 else "dense"
            yield f"params/{m.scope}/bias", m.bias, "vec"


def load_flat(model: torch.nn.Module, flat: Mapping[str, np.ndarray]) -> None:
    """Copy a flat ``.npz``-schema dict into the model, in place."""
    expected = {key for key, _, _ in leaves(model)}
    missing = sorted(expected - set(flat))
    extra = sorted(set(flat) - expected)
    if missing or extra:
        raise KeyError(f"weight keys do not match the model: missing {missing[:5]} "
                       f"({len(missing)}), unmapped {extra[:5]} ({len(extra)})")
    with torch.no_grad():
        for key, t, kind in leaves(model):
            copy_from_schema(t, flat[key], kind, key)


def copy_from_schema(t: torch.Tensor, value: np.ndarray, kind: str, key: str = "") -> None:
    """Copy an ``.npz``-layout array into tensor ``t`` of the given kind
    (HWIO -> OIHW for "conv", (in, out) -> (out, in) for "dense")."""
    value = np.asarray(value)
    if kind == "conv":
        value = value.transpose(3, 2, 0, 1)
    elif kind == "dense":
        value = value.T
    if tuple(value.shape) != tuple(t.shape):
        raise ValueError(f"{key}: shape {value.shape}, model has {tuple(t.shape)}")
    t.copy_(torch.from_numpy(np.array(value)))  # a writable, contiguous copy


def schema_array(t: torch.Tensor, kind: str) -> np.ndarray:
    """Tensor ``t`` of the given kind as a float32 ``.npz``-layout array
    (OIHW -> HWIO for "conv", (out, in) -> (in, out) for "dense")."""
    value = t.detach().to("cpu", torch.float32).numpy()
    if kind == "conv":
        value = value.transpose(2, 3, 1, 0)
    elif kind == "dense":
        value = value.T
    return np.ascontiguousarray(value)


def to_flat(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    """The model's weights as a flat ``.npz``-schema dict (float32 numpy)."""
    return {key: schema_array(t, kind) for key, t, kind in leaves(model)}


def _lecun_normal(rng: np.random.Generator, shape) -> np.ndarray:
    """Flax's default conv and dense init: truncated normal (+-2 std) with
    variance 1/fan_in, fan_in = H*W*I of an HWIO kernel, I of an (I, O)
    one."""
    fan_in = int(np.prod(shape[:-1]))
    std = np.sqrt(1.0 / fan_in) / 0.87962566103423978  # truncation correction
    x = rng.standard_normal(shape)
    bad = np.abs(x) > 2.0
    while bad.any():
        x[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(x) > 2.0
    return (x * std).astype(np.float32)


def init_flat(model_name: str, seed: int = 0, **model_kwargs) -> Dict[str, np.ndarray]:
    """Seeded random weights for a registered model, in the ``.npz`` schema
    (Flax's initialisers: lecun-normal kernels, zero biases, BN scale 1,
    running mean 0 and var 1).  ``model_kwargs`` go to the model's factory
    (a temporal model's ``aggregation``, say), as ``zoo.get_model``'s do.
    Needs no JAX and no download."""
    from viddet_tpu_torch.models.zoo import _REGISTRY

    with torch.device("meta"):
        model, _ = _REGISTRY[model_name](**model_kwargs)
    return seeded_flat(model, seed)


def seeded_flat(model: torch.nn.Module, seed: int = 0) -> Dict[str, np.ndarray]:
    """``init_flat``'s seeded weights for any model, registered or a custom
    build (only its parameters' shapes are read)."""
    rng = np.random.default_rng(seed)
    flat = {}
    for key, t, kind in leaves(model):
        if kind == "conv":
            o, i, h, w = t.shape
            flat[key] = _lecun_normal(rng, (h, w, i, o))
        elif kind == "dense":
            flat[key] = _lecun_normal(rng, tuple(t.shape[::-1]))
        elif key.endswith(("/scale", "/var")):
            flat[key] = np.ones(tuple(t.shape), np.float32)
        else:
            flat[key] = np.zeros(tuple(t.shape), np.float32)
    return flat
