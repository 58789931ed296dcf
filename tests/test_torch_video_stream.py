"""The port's video surfaces against the JAX package's, on the CPU:
``stream_detect_video``, ``stream_detect_videos`` / ``open_sources`` and the
detect CLI over Motion-JPEG AVI files (mirrors
``tests/integration/test_stream.py``, the video cases of
``tests/integration/test_multistream.py`` and the CLI's video branch).

The videos are written by OpenCV's built-in MJPEG writer.  JAX's
``FrameSource`` opens ``cv2.VideoCapture(path)``, whose default backend
(FFmpeg) decodes MJPEG with its own IDCT and colour conversion; so that
JAX reads the pixels the port reads, the ``jax_reads_mjpeg`` fixture
makes ``cv2.VideoCapture`` take ``cv2.CAP_OPENCV_MJPEG`` for the test's
duration and switches JAX's FFmpeg-linked native source off (it resizes
with a float bilinear that equals neither).  Nothing in ``viddet_tpu``
changes.

Both run a tiny float32 YOLOv3 (or its k = 3 temporal form) on JAX's
initial weights, the JAX tail on its XLA chain and the port's under the
deterministic ranking.  The ``{stem}_det.txt`` files agree frame by frame
and line for line: frame indices and class names exactly, scores within
1e-5 and boxes within 1e-3 input pixels (the golden tolerances) plus the
printed precision (``%.4f`` / ``%.1f``, each side rounding by up to half
of it); lines whose scores lie closer than that may come in either order.  Both
write ``{stem}_det.mp4`` (MPEG-4 Part 2): the port's is the bytes a fresh
``VideoWriter`` writes from the drawn frames, cv2 decodes it to the port's
own decoder's frames, and cv2 opens it with the frame count, size and fps
of JAX's (``tests/torch_video_helpers.py`` ``assert_drawn_video``).
"""

import functools
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import viddet_tpu.cli.detect as jax_detect
import viddet_tpu.models.zoo as jax_zoo
import viddet_tpu.native as jax_native
import viddet_tpu_torch.cli.detect as torch_detect
import viddet_tpu_torch.infer.multistream as torch_multistream
import viddet_tpu_torch.models.zoo as torch_zoo
from tests.test_torch_stream import SIZE, twin_models
from tests.test_torch_video import photo_frames, write_video
from tests.torch_video_helpers import assert_drawn_video, cv2_props
from tests.torch_mp4_helpers import h264_mp4
from viddet_tpu.core.precision import FLOAT32_POLICY as JAX_F32
from viddet_tpu.data.transforms import ValTransform as JaxValTransform
from viddet_tpu.infer.multistream import stream_detect_videos as jax_stream_detect_videos
from viddet_tpu.infer.stream import stream_detect_video as jax_stream_detect_video
from viddet_tpu.models.zoo import get_model as jax_get_model
from viddet_tpu.train.state import save_weights_npz
from viddet_tpu_torch.core.precision import FLOAT32_POLICY
from viddet_tpu_torch.data.transforms import ValTransform, invert_affine_to_boxes
from viddet_tpu_torch.infer import stream as torch_stream
from viddet_tpu_torch.infer.multistream import open_sources, stream_detect_multi
from viddet_tpu_torch.infer.stream import (
    FrameSource, NativeFrameSource, stream_detect, stream_detect_video,
)
from viddet_tpu_torch.native.mp4 import read_index as read_mp4_index
from viddet_tpu_torch.utils.image import draw_detections

CPU = torch.device("cpu")
CLASSES = ["a", "b"]
FRAME_H, FRAME_W = 96, 128
SCALE = min(SIZE / FRAME_H, SIZE / FRAME_W)  # the letterbox's, for the box tolerance


@pytest.fixture
def jax_reads_mjpeg(monkeypatch):
    """JAX's cv2 sources read through OpenCV's MJPEG backend, as the port's
    reader reads; JAX's native (FFmpeg) source is off."""
    original = cv2.VideoCapture
    monkeypatch.setattr(cv2, "VideoCapture",
                        lambda path, *api: original(path, *(api or (cv2.CAP_OPENCV_MJPEG,))))
    monkeypatch.setattr(jax_native, "available", lambda: False)


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    """Two MJPEG AVIs of 11 and 7 frames (128x96, 10 fps)."""
    d = tmp_path_factory.mktemp("videos")
    return [write_video(str(d / name), photo_frames(n, FRAME_H, FRAME_W, seed=i), 10, "opencv")
            for i, (name, n) in enumerate((("a.avi", 11), ("b.avi", 7)))]


def transforms():
    return (ValTransform((SIZE, SIZE), letterbox_resize=True, normalize=False),
            JaxValTransform(size=(SIZE, SIZE), letterbox_resize=True, normalize=False))


def parse_txt(path: str):
    rows = []
    with open(path) as f:
        for line in f:
            idx, name, *values = line.split()
            rows.append((int(idx), name, np.array(values, np.float64)))
    return rows


def assert_txt_equal(got_path: str, want_path: str) -> int:
    """Frame by frame the same lines: the same frame indices in order, and
    within a frame each line matched to one of the other's with the same
    class and values within the tolerances (the tail sorts by score, so two
    scores closer than the tolerance may come in either order)."""
    got, want = parse_txt(got_path), parse_txt(want_path)
    assert [g[0] for g in got] == [w[0] for w in want]
    for frame in sorted({g[0] for g in got}):
        left = [w for w in want if w[0] == frame]
        for g in (g for g in got if g[0] == frame):
            match = next((i for i, w in enumerate(left) if w[1] == g[1]
                          and abs(g[2][0] - w[2][0]) <= 1e-5 + 1e-4
                          and np.abs(g[2][1:] - w[2][1:]).max() <= 1e-3 / SCALE + 0.1), None)
            assert match is not None, (g, left)
            left.pop(match)
    return len(got)


@pytest.mark.parametrize("draw,every", [(True, 2), (False, 1), (False, 3)])
def test_stream_detect_video_equals_jax(draw, every, videos, tmp_path, jax_reads_mjpeg):
    jax_infer, variables, infer = twin_models()
    port_t, jax_t = transforms()
    kw = dict(thresh=0.0, batch_size=4, every=every, draw=draw, save_detections=True)
    stats = stream_detect_video(videos[0], infer, port_t, CLASSES,
                                output_dir=str(tmp_path / "port"), device=CPU, **kw)
    want = jax_stream_detect_video(videos[0], jax_infer, variables, jax_t, CLASSES,
                                   output_dir=str(tmp_path / "jax"), **kw)
    n = len(range(0, 11, every))
    assert stats["frames"] == want["frames"] == n
    assert sorted(os.listdir(tmp_path / "port")) == (["a_det.mp4", "a_det.txt"] if draw
                                                     else ["a_det.txt"])
    lines = assert_txt_equal(str(tmp_path / "port" / "a_det.txt"),
                             str(tmp_path / "jax" / "a_det.txt"))
    assert lines > 0
    if draw:
        index = read_mp4_index(str(tmp_path / "port" / "a_det.mp4"))
        assert (index.frame_count, index.width, index.height) == (n, FRAME_W, FRAME_H)
        assert index.fps == pytest.approx(10 / every)
        expect = []
        for idx, rgb, affine, ids, scores, boxes in stream_detect(
                FrameSource(videos[0], port_t, every=every), infer, 4, (SIZE, SIZE),
                device=CPU):
            expect.append(draw_detections(rgb, invert_affine_to_boxes(boxes, affine), ids,
                                          scores, CLASSES, 0.0))
        assert_drawn_video(str(tmp_path / "port" / "a_det.mp4"), expect, 10 / every,
                           str(tmp_path / "jax" / "a_det.mp4"))


def test_stream_detect_video_end_to_end(videos, tmp_path):
    """Mirrors the JAX test: 11 frames every 2 -> 6, an annotated video at
    the original size, and the detections file."""
    _, _, infer = twin_models()
    out = str(tmp_path / "out")
    stats = stream_detect_video(videos[0], infer, ValTransform((SIZE, SIZE), True),
                                CLASSES, output_dir=out, thresh=0.0, batch_size=4, every=2,
                                draw=True, save_detections=True, device=CPU)
    assert stats["frames"] == 6 and stats["fps"] > 0
    assert os.path.exists(os.path.join(out, "a_det.txt"))
    cap = cv2.VideoCapture(os.path.join(out, "a_det.mp4"), cv2.CAP_FFMPEG)
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 6
    assert int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)) == FRAME_W
    cap.release()


def test_stream_detect_ordering(videos):
    """Frames come back in order with one batch in flight."""
    _, _, infer = twin_models()
    source = FrameSource(videos[0], ValTransform((SIZE, SIZE), letterbox_resize=True))
    indices = [idx for idx, *_ in stream_detect(iter(source), infer, 4, (SIZE, SIZE),
                                                device=CPU)]
    assert indices == list(range(11))


def test_no_draw_takes_the_native_source_without_fallback(videos, tmp_path, monkeypatch):
    _, _, infer = twin_models()
    made = []
    for name in ("FrameSource", "NativeFrameSource"):
        cls = getattr(torch_stream, name)
        monkeypatch.setattr(torch_stream, name,
                            lambda *a, _cls=cls, _name=name, **k: made.append(_name) or
                            _cls(*a, **k))
    run = functools.partial(stream_detect_video, videos[0], infer,
                            ValTransform((SIZE, SIZE), True, normalize=False), CLASSES,
                            thresh=0.0, batch_size=4, save_detections=True, device=CPU)
    assert run(output_dir=str(tmp_path / "a"), draw=False)["frames"] == 11
    assert run(output_dir=str(tmp_path / "b"), draw=True)["frames"] == 11
    assert made == ["NativeFrameSource", "FrameSource"]

    def broken(*a, **k):
        raise ValueError("native source broke")

    monkeypatch.setattr(torch_stream, "VideoStream", broken)
    with pytest.raises(ValueError, match="native source broke"):  # raised, not replaced
        run(output_dir=str(tmp_path / "c"), draw=False)
    assert not os.path.exists(tmp_path / "c")


@pytest.mark.parametrize("k,draw", [(1, False), (1, True), (3, False)])
def test_stream_detect_videos_equals_jax(k, draw, videos, tmp_path, jax_reads_mjpeg):
    jax_infer, variables, infer = twin_models(k)
    port_t, jax_t = transforms()
    kw = dict(thresh=0.0, batch_size=4, k=k, draw=draw, save_detections=True)
    stats = torch_multistream.stream_detect_videos(videos, infer, port_t, CLASSES,
                                                   output_dir=str(tmp_path / "port"),
                                                   device=CPU, **kw)
    want = jax_stream_detect_videos(videos, jax_infer, variables, jax_t, CLASSES,
                                    output_dir=str(tmp_path / "jax"), **kw)
    assert stats["per_stream"] == want["per_stream"]
    assert stats["per_stream"] == ({"a.avi": 11, "b.avi": 7} if k == 1
                                   else {"a.avi": 10, "b.avi": 6})
    for stem in ("a", "b"):
        assert assert_txt_equal(str(tmp_path / "port" / f"{stem}_det.txt"),
                                str(tmp_path / "jax" / f"{stem}_det.txt")) > 0
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(["a_det.txt", "b_det.txt"] + (["a_det.mp4", "b_det.mp4"] if draw
                                                         else []))
    if draw:
        assert read_mp4_index(str(tmp_path / "port" / "b_det.mp4")).frame_count == 7
        for stem in ("a", "b"):
            assert cv2_props(str(tmp_path / "port" / f"{stem}_det.mp4")) == cv2_props(
                str(tmp_path / "jax" / f"{stem}_det.mp4"))


def test_multistream_single_frame_ordering(videos):
    _, _, infer = twin_models()
    sources = open_sources(videos, ValTransform((SIZE, SIZE), letterbox_resize=True),
                           prefer_native=False)
    assert all(isinstance(s, FrameSource) for s in sources.values())
    per_stream = {}
    for name, idx, rgb, affine, ids, scores, boxes in stream_detect_multi(
            {n: iter(s) for n, s in sources.items()}, infer, 4, (SIZE, SIZE), device=CPU):
        per_stream.setdefault(name, []).append(idx)
        assert ids.shape == (8,) and boxes.shape == (8, 4) and rgb.shape == (96, 128, 3)
    assert sorted(per_stream) == ["a.avi", "b.avi"]
    assert per_stream["a.avi"] == list(range(11))
    assert per_stream["b.avi"] == list(range(7))


def test_multistream_temporal_clips(videos):
    k = 3
    _, _, infer = twin_models(k)
    transform = ValTransform((SIZE, SIZE), letterbox_resize=True, normalize=False)
    sources = open_sources(videos, transform, need_rgb=False)
    assert all(isinstance(s, NativeFrameSource) for s in sources.values())
    per_stream = {}
    for name, idx, *_ in stream_detect_multi({n: iter(s) for n, s in sources.items()}, infer,
                                             4, (SIZE, SIZE), k=k, device=CPU):
        per_stream.setdefault(name, []).append(idx)
    # keys: the centres of [0..2], [1..3], ..., then the flush's last frame
    assert per_stream["a.avi"] == list(range(1, 10)) + [10]
    assert per_stream["b.avi"] == list(range(1, 6)) + [6]


def test_duplicate_basename_streams_write_distinct_outputs(videos, tmp_path):
    _, _, infer = twin_models()
    out = str(tmp_path / "out")
    stats = torch_multistream.stream_detect_videos(
        [videos[1], videos[1]], infer, ValTransform((SIZE, SIZE)), ["c0", "c1"],
        output_dir=out, thresh=0.0, batch_size=4, draw=False, save_detections=True,
        device=CPU)
    assert sorted(os.listdir(out)) == ["b_1_det.txt", "b_det.txt"]
    assert stats["frames"] == 14


def test_open_sources_closes_the_opened_ones_when_one_fails(videos, monkeypatch, tmp_path):
    closed = []
    original = FrameSource.close
    monkeypatch.setattr(FrameSource, "close", lambda self: closed.append(1) or original(self))
    with pytest.raises(ValueError, match="FFmpeg"):
        open_sources([videos[0], h264_mp4(str(tmp_path / "c.mp4"))], ValTransform((SIZE, SIZE)))
    assert closed == [1]


# ------------------------------------------------------------- detect CLI


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """JAX's initial weights of the tiny YOLOv3 over VOC, and of its k = 3
    temporal form, as .npz files."""
    d = tmp_path_factory.mktemp("weights")
    module, _ = jax_get_model("yolo3_tiny_darknet_voc", policy=JAX_F32)
    v = module.init(jax.random.key(0), jnp.zeros((1, SIZE, SIZE, 3)), train=False)
    save_weights_npz(str(d / "tiny.npz"), v["params"], v["batch_stats"])
    _, voc = jax_get_model("yolo3_tiny_darknet_voc", policy=JAX_F32)
    module, _ = jax_zoo.temporal_yolo3_custom(list(voc), k=3, aggregation="max",
                                              backbone="tiny", policy=JAX_F32)
    v = module.init(jax.random.key(1), jnp.zeros((1, 3, SIZE, SIZE, 3)), train=False)
    save_weights_npz(str(d / "tiny_k3.npz"), v["params"], v["batch_stats"])
    return {1: str(d / "tiny.npz"), 3: str(d / "tiny_k3.npz")}


def _cli(main, inputs, out, weights, *extra):
    return main(["--network", "yolo3_tiny_darknet", "--dataset", "voc", "--input", inputs,
                 "--output", out, "--data-shape", str(SIZE), "--batch-size", "4",
                 "--thresh", "0.0", "--weights", weights, "--save-detections",
                 "--platform", "cpu", *extra])


@pytest.mark.parametrize("case", ["one", "two", "temporal"])
def test_detect_cli_videos_equal_jax(case, videos, weights, tmp_path, monkeypatch,
                                     jax_reads_mjpeg):
    monkeypatch.setattr(jax_detect, "build_model",
                        functools.partial(jax_detect.build_model, policy=JAX_F32))
    monkeypatch.setattr(torch_detect, "build_model",
                        functools.partial(torch_detect.build_model, policy=FLOAT32_POLICY))
    monkeypatch.setattr(jax_zoo, "temporal_yolo3_custom",
                        functools.partial(jax_zoo.temporal_yolo3_custom, policy=JAX_F32))
    monkeypatch.setattr(torch_zoo, "temporal_yolo3_custom",
                        functools.partial(torch_zoo.temporal_yolo3_custom,
                                          policy=FLOAT32_POLICY))
    monkeypatch.setenv("VIDDET_PAIR_TOPK", "det")
    jax.clear_caches()
    inputs = videos[0] if case == "one" else ",".join(videos)
    k = 3 if case == "temporal" else 1
    extra = ("--no-draw",) + (("--temporal-k", "3") if k == 3 else ())
    done = _cli(torch_detect.main, inputs, str(tmp_path / "port"), weights[k], *extra)
    _cli(jax_detect.main, inputs, str(tmp_path / "jax"), weights[k], *extra)
    stems = ["a"] if case == "one" else ["a", "b"]
    assert done == {"one": 11, "two": 18, "temporal": 16}[case]
    assert sorted(os.listdir(tmp_path / "port")) == [f"{s}_det.txt" for s in stems]
    assert sorted(os.listdir(tmp_path / "jax")) == [f"{s}_det.txt" for s in stems]
    for s in stems:
        assert assert_txt_equal(str(tmp_path / "port" / f"{s}_det.txt"),
                                str(tmp_path / "jax" / f"{s}_det.txt")) > 0


def test_detect_cli_routes_and_flush_defaults(videos, weights, tmp_path, monkeypatch):
    """One file: stream_detect_video, drawn to {stem}_det.mp4.  Several
    files: stream_detect_videos with --flush-ms 200 unless given."""
    seen = []
    original = torch_multistream.stream_detect_videos
    monkeypatch.setattr(torch_multistream, "stream_detect_videos",
                        lambda *a, **k: seen.append(k["flush_ms"]) or original(*a, **k))
    assert _cli(torch_detect.main, videos[1], str(tmp_path / "one"), weights[1]) == 7
    assert sorted(os.listdir(tmp_path / "one")) == ["b_det.mp4", "b_det.txt"]
    assert read_mp4_index(str(tmp_path / "one" / "b_det.mp4")).frame_count == 7
    assert not seen
    _cli(torch_detect.main, ",".join(videos), str(tmp_path / "two"), weights[1], "--no-draw")
    _cli(torch_detect.main, ",".join(videos), str(tmp_path / "two"), weights[1], "--no-draw",
         "--flush-ms", "30")
    assert seen == [200.0, 30.0]
    with pytest.raises(SystemExit, match="video input"):
        _cli(torch_detect.main, str(tmp_path), str(tmp_path / "x"), weights[1],
             "--temporal-k", "3")
