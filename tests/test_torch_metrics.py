"""The port's VOC, COCO and VID metrics against the JAX package's, exactly.

Every case of the JAX package's metric tests (``tests/unit/test_voc_map.py``,
``test_coco_eval.py``, ``test_vid_metric.py``, ``test_metric_properties.py``
and the merge cases of ``test_sharded_eval.py``) runs here with each metric
class and function replaced by a twin: the twin feeds the same inputs to
the JAX object and to the port's, and every value either returns (``get()``,
``summarize()``, ``state_dict()``, the motion IoUs, the greedy match) must
be equal, name for name and float for float (NaN equal to NaN).  The JAX
test's own assertions then run on the values as before.
"""

import copy
import inspect
import math
import threading

import numpy as np
import pytest

import viddet_tpu.eval.coco_eval as jax_coco
import viddet_tpu.eval.vid_motion_iou as jax_vid
import viddet_tpu.eval.voc_map as jax_voc
import viddet_tpu_torch.eval.coco_eval as torch_coco
import viddet_tpu_torch.eval.vid_motion_iou as torch_vid
import viddet_tpu_torch.eval.voc_map as torch_voc
from tests.unit import (
    test_coco_eval,
    test_metric_properties,
    test_sharded_eval,
    test_vid_metric,
    test_voc_map,
)

# (JAX module, port module, names twinned)
TWINNED = (
    (jax_voc, torch_voc, ("VOCMApMetric", "VOC07MApMetric")),
    (jax_coco, torch_coco, ("COCOEvalBBox", "COCODetectionMetric", "_greedy_match")),
    (jax_vid, torch_vid, ("VIDDetectionMetric", "compute_motion_ious")),
)
MIRRORED = (test_voc_map, test_coco_eval, test_vid_metric, test_metric_properties,
            test_sharded_eval)
SKIPPED = {"test_gather_states_single_process_identity"}  # the JAX-only cross-process gather


def assert_same(a, b, where="value"):
    """Exact structural equality; floats bit-equal, NaN equal to NaN."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), f"{where}: keys {list(a)} != {list(b)}"
        for k in a:
            assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), f"{where}: {a!r} != {b!r}"
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        b = np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, f"{where}: {a.dtype}{a.shape} != {b.dtype}{b.shape}"
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, (float, np.floating)):
        assert isinstance(b, (float, np.floating)), f"{where}: {a!r} != {b!r}"
        assert (math.isnan(a) and math.isnan(b)) or a == b, f"{where}: {a!r} != {b!r}"
    else:
        assert a == b, f"{where}: {a!r} != {b!r}"


# Calls made from inside a twinned call (the JAX COCO metric building its
# evaluator, say) reach the JAX originals, so each twin compares one
# top-level call; per thread, since the loader and packed tests read from
# several.
_LOCAL = threading.local()


def _depth() -> int:
    return getattr(_LOCAL, "depth", 0)


def _side(value, i: int):
    """``value`` with every twin replaced by its JAX (0) or port (1) half, and
    containers copied, so neither side sees the other's objects."""
    if isinstance(value, Twin):
        return object.__getattribute__(value, "_pair")[i]
    if isinstance(value, (list, tuple)):
        return type(value)(_side(v, i) for v in value)
    if isinstance(value, dict):
        return {k: _side(v, i) for k, v in value.items()}
    if isinstance(value, np.ndarray):
        return value.copy()
    return value


def _lockstep(j, t, where: str):
    """The value a twinned call returns: a twin of two package objects or
    functions, else the JAX value after it was checked equal to the port's."""
    if isinstance(j, (list, tuple)) and not isinstance(j, np.ndarray):
        assert isinstance(t, (list, tuple)) and len(j) == len(t), f"{where}: {j!r} != {t!r}"
        return type(j)(_lockstep(a, b, f"{where}[{k}]") for k, (a, b) in enumerate(zip(j, t)))
    if type(j).__module__.startswith("viddet_tpu."):
        assert type(j).__name__ == type(t).__name__, f"{where}: {type(j)} != {type(t)}"
        return Twin((j, t))
    if inspect.isfunction(j) or inspect.ismethod(j):
        return twin_function(where, j, t)
    assert_same(j, t, where)
    return j


def twin_function(name, jax_fn, torch_fn):
    def call(*args, **kwargs):
        if _depth():
            return jax_fn(*args, **kwargs)
        return _both(name, lambda: jax_fn(*_side(args, 0), **_side(kwargs, 0)),
                     lambda: torch_fn(*_side(args, 1), **_side(kwargs, 1)))

    return call


def _both(name, jax_call, torch_call):
    """Both calls, the JAX one first; equal results, or the same exception
    type from both (the JAX one is raised)."""
    _LOCAL.depth = 1
    try:
        try:
            want = jax_call()
        except Exception as exc:  # noqa: BLE001 -- the port must raise alike
            with pytest.raises(type(exc)):
                torch_call()
            raise
        got = torch_call()
    finally:
        _LOCAL.depth = 0
    return _lockstep(want, got, name)


class _TwinIterator:
    """Two iterators advanced together (a loader's batches, say)."""

    def __init__(self, pair):
        self._pair = pair

    def __iter__(self):
        return self

    def __next__(self):
        j, t = self._pair
        return _both("next", lambda: next(j), lambda: next(t))

    def close(self):
        for it in self._pair:
            close = getattr(it, "close", None)
            if close is not None:
                close()


class Twin:
    """A JAX object and its port counterpart, driven in lockstep: every
    method call goes to both, and every value read or returned must be
    equal."""

    def __init__(self, pair):
        object.__setattr__(self, "_pair", pair)

    def __getattr__(self, attr):
        j, t = (getattr(obj, attr) for obj in object.__getattribute__(self, "_pair"))
        if callable(j):
            return twin_function(f"{type(j).__qualname__}.{attr}", j, t)
        return _lockstep(j, t, attr)

    def __setattr__(self, attr, value):
        for i, obj in enumerate(object.__getattribute__(self, "_pair")):
            setattr(obj, attr, _side(value, i))

    def __len__(self):
        return self.__getattr__("__len__")()

    def __getitem__(self, idx):
        return self.__getattr__("__getitem__")(idx)

    def __iter__(self):
        return _TwinIterator(tuple(iter(obj) for obj in object.__getattribute__(self, "_pair")))


def twin_class(name, jax_cls, torch_cls):
    def new(cls, *args, **kwargs):
        if _depth():
            return jax_cls(*args, **kwargs)
        pairs = []
        _both(name, lambda: pairs.append(jax_cls(*_side(args, 0), **_side(kwargs, 0))),
              lambda: pairs.append(torch_cls(*_side(args, 1), **_side(kwargs, 1))))
        twin = object.__new__(cls)
        object.__setattr__(twin, "_pair", tuple(pairs))
        return twin

    return type(name, (Twin,), {"__new__": new, "__init__": lambda self, *a, **k: None})


def install_twins(monkeypatch, twinned, mirrored):
    """Replace each twinned name in its JAX module, and in the JAX tests'
    globals, for the duration of one case."""
    for jax_mod, torch_mod, names in twinned:
        for name in names:
            j, t = getattr(jax_mod, name), getattr(torch_mod, name)
            twin = (twin_class if inspect.isclass(j) else twin_function)(name, j, t)
            monkeypatch.setattr(jax_mod, name, twin)
            for test_mod in mirrored:
                if getattr(test_mod, name, None) is j:
                    monkeypatch.setattr(test_mod, name, twin)


@pytest.fixture
def twinned(monkeypatch):
    install_twins(monkeypatch, TWINNED, MIRRORED)


def mirrored_cases(mirrored, skipped=()):
    """pytest params of every test function of the JAX test modules
    ``mirrored`` that tier 1 runs (parametrized ones expanded)."""
    for mod in mirrored:
        short = mod.__name__.split(".")[-1]
        for name, fn in sorted(vars(mod).items()):
            if not (name.startswith("test_") and inspect.isfunction(fn)) or name in skipped:
                continue
            marks = list(getattr(fn, "pytestmark", []))
            if any(m.name == "slow" for m in marks):
                continue
            params = [m for m in marks if m.name == "parametrize"]
            if not params:
                yield pytest.param(fn, {}, id=f"{short}::{name}")
                continue
            (param,) = params
            for value in param.args[1]:
                yield pytest.param(fn, {param.args[0]: value}, id=f"{short}::{name}[{value}]")


def run_mirrored(fn, kwargs, tmp_path):
    if "tmp_path" in inspect.signature(fn).parameters:
        kwargs = dict(kwargs, tmp_path=tmp_path)
    fn(**kwargs)


@pytest.mark.parametrize("fn, kwargs", list(mirrored_cases(MIRRORED, SKIPPED)))
def test_metric_case_matches_jax(fn, kwargs, twinned, tmp_path):
    run_mirrored(fn, kwargs, tmp_path)


def test_protocol_constants_match_jax():
    assert_same(jax_vid.MOTION_BINS, torch_vid.MOTION_BINS)
    assert_same(jax_coco.IOU_THRS, torch_coco.IOU_THRS)


@pytest.mark.parametrize("use_07", [False, True])
@pytest.mark.parametrize("seed", range(4))
def test_voc_metric_random_scenes_match_jax(seed, use_07):
    """Crowded random scenes (overlapping GTs, duplicates, difficult
    boxes, padding rows) in batches of three, with a merge of two halves."""
    rng = np.random.default_rng(seed)
    scenes = [test_sharded_eval.random_scene(rng, classes=5) for _ in range(12)]
    cls = "VOC07MApMetric" if use_07 else "VOCMApMetric"
    names = [f"c{i}" for i in range(5)]
    metrics = [getattr(mod, cls)(class_names=names) for mod in (jax_voc, torch_voc)]
    halves = [[getattr(mod, cls)(class_names=names) for mod in (jax_voc, torch_voc)]
              for _ in range(2)]
    for start in range(0, len(scenes), 3):
        chunk = scenes[start : start + 3]
        pad = max(len(s[0]) for s in chunk) + 2, max(len(s[3]) for s in chunk) + 2

        def stack(i, width, fill=-1.0):
            rows = [np.concatenate([s[i], np.full((width - len(s[i]),) + s[i].shape[1:], fill,
                                                  np.float32)]) for s in chunk]
            return np.stack(rows)

        batch = (stack(3, pad[1]), stack(4, pad[1]), stack(5, pad[1]), stack(0, pad[0]),
                 stack(1, pad[0]), stack(2, pad[0], 0.0))
        for m in metrics + halves[start // 6]:
            m.update(*copy.deepcopy(batch))
    assert_same(metrics[0].get(), metrics[1].get())
    assert_same(metrics[0].state_dict(), metrics[1].state_dict())
    merged = getattr(torch_voc, cls)(class_names=names)
    for half in halves:
        merged.merge_state(half[1].state_dict())
    assert_same(metrics[0].get(), merged.get())
