"""The port's pipelined ``stream_detect`` against the JAX package's, on the CPU
(mirrors ``tests/integration/test_stream.py``, whose video sources wait for
the port's video reader).

A tiny float32 YOLOv3 (2 classes, 64 px) and a k = 3 temporal one carry
JAX's initial weights across (``.npz`` schema -> ``weights.load_flat``).
The same seeded uint8 frames, through each package's ``ValTransform``,
feed JAX's ``stream_detect`` and the port's; the results come back in the
same order and equal at the golden tolerances (ids exact, scores 1e-5,
boxes 1e-3), the JAX tail on its XLA chain and the port's under the
deterministic ranking (the one equal to it).  The port's loop keeps one
batch in flight: batch N+1 is submitted before batch N is read back.
"""

import functools
import queue
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viddet_tpu.core.precision import FLOAT32_POLICY as JAX_F32
from viddet_tpu.data.transforms import ValTransform as JaxValTransform
from viddet_tpu.infer.stream import stream_detect as jax_stream_detect
from viddet_tpu.models.yolo3 import NMSConfig as JaxNMSConfig
from viddet_tpu.models.yolo3 import YOLOv3 as JaxYOLOv3
from viddet_tpu.models.yolo3 import forward_and_postprocess as jax_forward_and_postprocess
from viddet_tpu.models.zoo import temporal_yolo3_custom as jax_temporal_custom
from viddet_tpu.train.loop import _maybe_normalize
from viddet_tpu.train.state import _flatten
from viddet_tpu_torch.cli.common import make_predictor
from viddet_tpu_torch.core.precision import FLOAT32_POLICY
from viddet_tpu_torch.data.transforms import ValTransform
from viddet_tpu_torch.infer.service import to_device_batch
from viddet_tpu_torch.infer.stream import stop_aware_put, stream_detect
from viddet_tpu_torch.models.yolo3 import NMSConfig
from viddet_tpu_torch.models.zoo import place, temporal_yolo3_custom, yolo3_custom
from viddet_tpu_torch.weights import load_flat

SIZE = 64
CLASSES = ["a", "b"]
NMS = dict(topk=32, post_nms=8, valid_thresh=0.001)
CPU = torch.device("cpu")


@functools.lru_cache(maxsize=None)
def twin_models(k: int = 1):
    """(JAX infer(variables, batch), variables, port infer(batch)) on one set
    of weights: a tiny YOLOv3 for k = 1, a temporal one (max) for k > 1."""
    if k == 1:
        module = JaxYOLOv3(num_classes=len(CLASSES), backbone="tiny", policy=JAX_F32)
        model, _ = yolo3_custom(CLASSES, backbone="tiny", policy=FLOAT32_POLICY)
        shape = (1, SIZE, SIZE, 3)
    else:
        module, _ = jax_temporal_custom(CLASSES, k=k, aggregation="max", backbone="tiny",
                                        policy=JAX_F32)
        model, _ = temporal_yolo3_custom(CLASSES, k=k, aggregation="max", backbone="tiny",
                                         policy=FLOAT32_POLICY)
        shape = (1, k, SIZE, SIZE, 3)
    variables = jax.jit(lambda: module.init(jax.random.key(k), jnp.zeros(shape), train=False))()
    flat = _flatten({"params": variables["params"]})
    flat.update(_flatten({"batch_stats": variables["batch_stats"]}))
    model = place(model, CPU)
    load_flat(model, flat)
    nms = JaxNMSConfig(backend="xla", **NMS)

    @jax.jit
    def jax_infer(v, images):
        return jax_forward_and_postprocess(module, v, _maybe_normalize(images), nms)

    return jax_infer, variables, make_predictor(model, NMSConfig(ranking="det", **NMS))


def frames(n: int, seed: int = 0, transform=None):
    """(idx, rgb, x, affine) of ``n`` seeded frames of three sizes, through
    the given package's letterbox transform (the port's by default)."""
    transform = transform or ValTransform((SIZE, SIZE), letterbox_resize=True, normalize=False)
    rng = np.random.default_rng(seed)
    sizes = ((96, 128), (64, 64), (50, 90))
    for i in range(n):
        rgb = rng.integers(0, 256, sizes[i % 3] + (3,), dtype=np.uint8)
        x, _, affine = transform(rgb)
        yield i, rgb, x, affine


def jax_frames(n: int, seed: int = 0):
    return frames(n, seed, JaxValTransform(size=(SIZE, SIZE), letterbox_resize=True,
                                           normalize=False))


def assert_results_equal(got, want):
    """Lists of (key, ids, scores, boxes) in the same order, at the golden
    tolerances."""
    assert [g[0] for g in got] == [w[0] for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[1], np.asarray(w[1]), err_msg=str(g[0]))
        np.testing.assert_allclose(g[2], np.asarray(w[2]), rtol=0, atol=1e-5)
        np.testing.assert_allclose(g[3], np.asarray(w[3]), rtol=0, atol=1e-3)


@pytest.mark.parametrize("n,batch", [(14, 4), (8, 4), (3, 8)])
def test_stream_detect_equals_jax(n, batch):
    jax_infer, variables, infer = twin_models()
    got = [(idx, ids, scores, boxes) for idx, _rgb, _a, ids, scores, boxes in
           stream_detect(frames(n), infer, batch, (SIZE, SIZE), device=CPU)]
    want = [(idx, ids, scores, boxes) for idx, _rgb, _a, ids, scores, boxes in
            jax_stream_detect(jax_frames(n), jax_infer, variables, batch, (SIZE, SIZE))]
    assert [g[0] for g in got] == list(range(n))
    assert sum(int((g[1] >= 0).sum()) for g in got) > 0
    assert_results_equal(got, want)


def test_stream_detect_equals_the_direct_batched_call():
    """Each frame's result is the direct predictor's on its zero-padded batch."""
    _, _, infer = twin_models()
    items = list(frames(10, seed=1))
    got = list(stream_detect(iter(items), infer, 4, (SIZE, SIZE), device=CPU))
    for start in range(0, len(items), 4):
        chunk = items[start : start + 4]
        ids, scores, boxes = (t.numpy() for t in infer(
            to_device_batch(np.stack([c[2] for c in chunk]), 4, CPU)))
        for j, (idx, rgb, _x, affine) in enumerate(chunk):
            g = got[start + j]
            assert g[0] == idx and g[1] is rgb and g[2] is affine
            for a, b in zip(g[3:], (ids[j], scores[j], boxes[j])):
                np.testing.assert_array_equal(a, b)


def test_one_batch_in_flight():
    """Batch N+1 is submitted before batch N is read back (``.cpu()``)."""
    events = []

    class Result:
        def __init__(self, n, b):
            self.n, self.b = n, b

        def cpu(self):
            events.append(("drain", self.n))
            return torch.zeros((self.b, 3))

    calls = []

    def fake_infer(batch):
        calls.append(tuple(batch.shape))
        n = len(calls) - 1
        events.append(("submit", n))
        return Result(n, batch.shape[0]), Result(n, batch.shape[0]), Result(n, batch.shape[0])

    out = list(stream_detect(frames(10), fake_infer, 4, (SIZE, SIZE), device=CPU))
    assert len(out) == 10 and calls == [(4, SIZE, SIZE, 3)] * 3  # the short batch is padded
    order = [e for i, e in enumerate(events) if i == 0 or events[i - 1] != e]
    assert order == [("submit", 0), ("submit", 1), ("drain", 0), ("submit", 2),
                     ("drain", 1), ("drain", 2)]


def test_wrong_frame_size_raises():
    _, _, infer = twin_models()
    bad = iter([(0, None, np.zeros((32, 32, 3), np.uint8), np.zeros(4))])
    with pytest.raises(ValueError, match="input_shape"):
        list(stream_detect(bad, infer, 2, (SIZE, SIZE), device=CPU))


def test_stop_aware_put_gives_up_once_stopped():
    q = queue.Queue(maxsize=1)
    stop = threading.Event()
    assert stop_aware_put(q, 1, stop)
    timer = threading.Timer(0.3, stop.set)
    timer.start()
    assert not stop_aware_put(q, 2, stop)  # full queue: returns once stop is set
    assert q.get_nowait() == 1
