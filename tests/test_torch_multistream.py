"""The port's ``ClipBuffer`` and ``stream_detect_multi`` against the JAX
package's, on the CPU (mirrors ``tests/integration/test_multistream.py``,
whose video sources wait for the port's video reader).

Two seeded frame streams of different lengths feed JAX's
``stream_detect_multi`` and the port's, single-frame (a tiny float32
YOLOv3) and temporal (k = 3, max aggregation), on JAX's initial weights
carried across by ``weights.load_flat``.  Each stream's frames come back
in the same order from both, each equal at the golden tolerances (ids
exact, scores 1e-5, boxes 1e-3).  The clip windows, the end-of-stream
flush, the flush deadline anchored to a batch's first frame, the idle
drain while a source stalls and a source's error (raised, not a short
stream) are held as the JAX tests hold them.
"""

import time

import numpy as np
import pytest
import torch

from tests.test_torch_stream import SIZE, assert_results_equal, frames, jax_frames, twin_models
from viddet_tpu.infer.multistream import ClipBuffer as JaxClipBuffer
from viddet_tpu.infer.multistream import stream_detect_multi as jax_stream_detect_multi
from viddet_tpu_torch.infer.multistream import ClipBuffer, stream_detect_multi

CPU = torch.device("cpu")
LENGTHS = {"a": 11, "b": 7}


def _per_stream(results):
    out = {}
    for name, idx, _rgb, _affine, ids, scores, boxes in results:
        out.setdefault(name, []).append((idx, ids, scores, boxes))
    return out


@pytest.mark.parametrize("k", [1, 3])
def test_multistream_equals_jax(k):
    jax_infer, variables, infer = twin_models(k)
    got = _per_stream(stream_detect_multi(
        {name: frames(n, seed=i) for i, (name, n) in enumerate(LENGTHS.items())},
        infer, 4, (SIZE, SIZE), k=k, device=CPU))
    want = _per_stream(jax_stream_detect_multi(
        {name: jax_frames(n, seed=i) for i, (name, n) in enumerate(LENGTHS.items())},
        jax_infer, variables, 4, (SIZE, SIZE), k=k))
    assert sorted(got) == sorted(want) == sorted(LENGTHS)
    for name, n in LENGTHS.items():
        # k = 3: keys are the window centres 1 .. n-2, then the flush's n-1
        keys = list(range(n)) if k == 1 else list(range(1, n))
        assert [g[0] for g in got[name]] == keys
        assert_results_equal(got[name], want[name])
    assert sum(int((g[1] >= 0).sum()) for g in got["a"]) > 0


def _push_all(buf, n, shape=(4, 4, 3)):
    keys = []
    for i in range(n):
        for item in buf.push(i, None, np.full(shape, i, np.float32), np.zeros(4)):
            keys.append(item.frame_idx)
            if buf.k > 1:
                assert item.x.shape == (buf.k,) + shape
                assert item.x[buf.k // 2, 0, 0, 0] == item.frame_idx  # centre = key
            else:
                assert item.x.shape == shape
    return keys, [t.frame_idx for t in buf.flush()]


@pytest.mark.parametrize("k,stride,n", [(3, 2, 8), (5, 1, 2), (1, 1, 4), (3, 1, 0),
                                        (4, 3, 13), (2, 2, 5)])
def test_clip_buffer_equals_jax(k, stride, n):
    got = _push_all(ClipBuffer("s", k, stride), n)
    want = _push_all(JaxClipBuffer("s", k, stride), n)
    assert got == want
    if (k, stride, n) == (3, 2, 8):
        assert got == ([1, 3, 5], [7])  # windows end at 2, 4, 6; flush keys frame 7
    if (k, stride, n) == (5, 1, 2):
        assert got[0] == [] and got[1][-1] == 1  # a stream shorter than its window


def test_clip_buffer_rejects_bad_window():
    with pytest.raises(ValueError):
        ClipBuffer("s", 0)
    with pytest.raises(ValueError):
        ClipBuffer("s", 3, stride=0)


def _fake_infer(batch):
    b = batch.shape[0]
    return torch.zeros((b, 5)), torch.zeros((b, 5)), torch.zeros((b, 5, 4))


def test_decode_error_propagates_not_truncates():
    """A source that dies mid-stream raises in the consumer, with the
    original exception as its cause, rather than ending the stream early."""
    def good():
        for i in range(6):
            yield i, None, np.zeros((SIZE, SIZE, 3), np.uint8), np.zeros(4, np.float32)

    def bad():
        yield 0, None, np.zeros((SIZE, SIZE, 3), np.uint8), np.zeros(4, np.float32)
        raise ValueError("corrupt frame")

    with pytest.raises(RuntimeError, match="stream 'bad' failed") as info:
        for _ in stream_detect_multi({"good": good(), "bad": bad()}, _fake_infer, 4,
                                     (SIZE, SIZE), flush_ms=50.0, device=CPU):
            pass
    assert isinstance(info.value.__cause__, ValueError)


def test_flush_deadline_anchored_to_first_frame():
    """A source faster than 1000 / flush_ms frames a second still flushes a
    partial batch flush_ms after the batch's first frame (a per-get timeout
    would wait for the full batch: about 1.3 s here against 0.1 s)."""
    def src():
        for i in range(64):
            yield i, None, np.zeros((8, 8, 3), np.uint8), np.zeros(4, np.float32)
            time.sleep(0.04)  # 25 frames a second, faster than the 100 ms window

    t0 = time.perf_counter()
    gen = stream_detect_multi({"s": src()}, _fake_infer, 32, (8, 8), flush_ms=100.0,
                              device=CPU)
    next(gen)
    first_dt = time.perf_counter() - t0
    gen.close()
    assert first_dt < 0.6, f"first result after {first_dt:.2f}s: no flush at the deadline"


def test_idle_drain_releases_results_while_source_stalls():
    """A source that stalls after a partial batch was submitted does not
    hold back the finished detections: the loop drains when the ready queue
    goes idle."""
    def stalling_src():
        yield 0, None, np.zeros((8, 8, 3), np.uint8), np.zeros(4, np.float32)
        time.sleep(30.0)  # far past the test's budget

    t0 = time.perf_counter()
    gen = stream_detect_multi({"s": stalling_src()}, _fake_infer, 32, (8, 8),
                              flush_ms=100.0, max_in_flight=2, device=CPU)
    out = next(gen)
    dt = time.perf_counter() - t0
    gen.close()
    assert out[0] == "s" and out[1] == 0
    assert dt < 2.0, f"first result after {dt:.2f}s: no idle drain"


def test_clips_reach_the_predictor_padded():
    """(B, k, H, W, 3) clips, the last batch padded with zero clips."""
    shapes = []

    def infer(batch):
        shapes.append(tuple(batch.shape))
        return _fake_infer(batch)

    out = list(stream_detect_multi({"s": frames(6)}, infer, 4, (SIZE, SIZE), k=3,
                                   flush_ms=5000.0, device=CPU))
    assert [o[1] for o in out] == [1, 2, 3, 4, 5]
    assert shapes == [(4, 3, SIZE, SIZE, 3), (4, 3, SIZE, SIZE, 3)]
