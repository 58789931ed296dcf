"""The port's model registry against the JAX package's.

The port registers exactly JAX's names, and for each one its weight schema
(the ``.npz`` keys and shapes ``weights.py`` maps, read off a model built
on the meta device) equals the JAX module's parameter tree, so ``init_flat``
and ``load_flat`` cover every name.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viddet_tpu.models import zoo as jax_zoo
from viddet_tpu.train.state import _flatten
from viddet_tpu_torch.models import zoo
from viddet_tpu_torch.weights import init_flat, leaves


def test_list_models_equals_jax():
    assert list(zoo.list_models()) == list(jax_zoo.list_models())
    assert len(zoo.list_models()) == 13


@pytest.mark.parametrize("name", jax_zoo.list_models())
def test_weight_schema_equals_jax_and_init_flat_covers_it(name):
    module, jax_classes = jax_zoo.get_model(name)
    k = getattr(module, "k", None)
    shape = (1, 64, 64, 3) if k is None else (1, k, 64, 64, 3)
    tree = jax.eval_shape(lambda: module.init({"params": jax.random.key(0)}, jnp.zeros(shape),
                                              train=False))
    tree = jax.tree.map(lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape), tree)
    want = {key: v.shape for key, v in _flatten({"params": tree["params"]}).items()}
    want.update({key: v.shape for key, v in _flatten({"batch_stats": tree["batch_stats"]}).items()})
    with torch.device("meta"):
        model, classes = zoo._REGISTRY[name]()
    assert tuple(classes) == tuple(jax_classes)
    got = {}
    for key, t, kind in leaves(model):
        got[key] = tuple(t.shape[2:] + t.shape[1::-1]) if kind == "conv" else tuple(
            t.shape[::-1])
    assert got == want
    flat = init_flat(name, seed=0)
    assert {key: v.shape for key, v in flat.items()} == want
    assert all(v.dtype == np.float32 for v in flat.values())
