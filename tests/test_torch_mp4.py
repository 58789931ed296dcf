"""The port's MP4 / QuickTime demuxer (``native/mp4.py``) and the video
surfaces over it, against OpenCV and the JAX package on the CPU.

* Demux: each sample's bytes equal OpenCV's raw packets
  (``CAP_PROP_FORMAT`` -1) byte for byte, with no difference to state
  (FFmpeg prepends nothing to ``mp4v`` packets), for ``.mp4`` and ``.mov``
  with ``mp4v`` and with ``jpeg``; ``probe_video`` equals JAX's.  The same
  samples laid out another way (``moov`` first, 64-bit and to-the-end
  ``mdat`` sizes, ``stz2`` and ``co64``, several samples a chunk, a
  version-1 ``mdhd``, an identity edit list, a varying frame duration)
  read the same, and OpenCV reads those files the same (fps included).
* Motion-JPEG in QuickTime: each frame equals ``cv2.imdecode`` of its
  sample exactly, as the AVI frames do; cv2's default (FFmpeg) backend,
  what JAX reads, decodes them off by many grey levels (ROADMAP Queue 3).
* Refusals: an H.264, HEVC, AV1 or VP9 profile 1 (4:4:4) track, an ``mp4v`` track of
  another object type, a non-identity edit list, an ``mdat`` cut before
  its first whole frame and a file cut inside its ``moov`` raise ValueError
  naming what, before any thread starts or anything is written.  An
  ``mdat`` cut later reads to its last whole frame, as JAX's cv2 does.  Other containers (``.flv``,
  ``.ts``) and webcam indices raise as before.
* Surfaces against JAX (tiny float32 YOLOv3 at 64 px, JAX reading through
  cv2's default backend with its native source off): ``stream_detect_video``
  (both sources, every 1 and 3), ``stream_detect_videos`` over an ``.mp4``
  and an ``.avi``, ``detect --input a.mp4`` and ``extract_frames``: the
  saved lines at the golden tolerances, frame ids and classes exact, the
  extracted JPEGs byte for byte.
"""

import functools
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import viddet_tpu.cli.detect as jax_detect
import viddet_tpu.cli.extract_frames as jax_extract
import viddet_tpu.native as jax_native
import viddet_tpu_torch.cli.detect as torch_detect
import viddet_tpu_torch.cli.extract_frames as torch_extract
import viddet_tpu_torch.infer.multistream as torch_multistream
from tests.fixtures.make_mp4_fixture import moving_scene
from tests.test_torch_mpeg4 import write_clip
from tests.test_torch_stream import SIZE, twin_models
from tests.test_torch_video import photo_frames, write_video
from tests.test_torch_video_stream import CLASSES, CPU, _cli, assert_txt_equal, transforms
from tests.torch_mp4_helpers import cv2_views, remux, write_mp4
from tests.torch_video_helpers import cv2_props
from viddet_tpu.core.precision import FLOAT32_POLICY as JAX_F32
from viddet_tpu.models.zoo import get_model as jax_get_model
from viddet_tpu.train.state import save_weights_npz
from viddet_tpu.infer.multistream import stream_detect_videos as jax_stream_detect_videos
from viddet_tpu.infer.stream import stream_detect_video as jax_stream_detect_video
from viddet_tpu.utils.video import iterate_frames as jax_iterate_frames
from viddet_tpu.utils.video import probe_video as jax_probe_video
from viddet_tpu_torch.core.precision import FLOAT32_POLICY
from viddet_tpu_torch.data.transforms import ValTransform
from viddet_tpu_torch.infer.stream import FrameSource, NativeFrameSource, stream_detect_video
from viddet_tpu_torch.native.mp4 import Mp4Reader, read_index
from viddet_tpu_torch.utils.video import (
    check_source, extract_frames, iterate_frames, probe_video,
)

FRAME_H, FRAME_W = 96, 128


def write_mjpeg_mov(path: str, frames) -> str:
    h, w = frames[0].shape[:2]
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 25, (w, h))
    assert writer.isOpened()
    for f in frames:
        writer.write(f)
    writer.release()
    assert read_index(path).codec == "jpeg"  # FFmpeg's mov muxer tags it 'jpeg'
    return path


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """a.mp4 (11 frames) and b.mov (7, mp4v), 128x96; c.mov (5, jpeg); and
    d.avi (7, Motion-JPEG) for the mixed batch."""
    d = tmp_path_factory.mktemp("mp4")
    return {
        "a.mp4": write_clip(str(d / "a.mp4"), moving_scene(11, FRAME_W, FRAME_H, seed=5), 10),
        "b.mov": write_clip(str(d / "b.mov"), moving_scene(7, FRAME_W, FRAME_H, seed=6)),
        "c.mov": write_mjpeg_mov(str(d / "c.mov"), moving_scene(5, FRAME_W, FRAME_H, seed=7)),
        "d.avi": write_video(str(d / "d.avi"), photo_frames(7, FRAME_H, FRAME_W, seed=1), 10,
                             "opencv"),
    }


@pytest.fixture
def jax_reads_like_the_port(monkeypatch):
    """JAX's cv2 sources read an .avi through OpenCV's MJPEG backend (as the
    port reads it: libjpeg) and anything else through the default (FFmpeg)
    backend; JAX's native (FFmpeg-linked) source is off."""
    original = cv2.VideoCapture

    def capture(path, *api):
        if not api and str(path).lower().endswith(".avi"):
            api = (cv2.CAP_OPENCV_MJPEG,)
        return original(path, *api)

    monkeypatch.setattr(cv2, "VideoCapture", capture)
    monkeypatch.setattr(jax_native, "available", lambda: False)


# ------------------------------------------------------------------ demux


@pytest.mark.parametrize("name", ["a.mp4", "b.mov", "c.mov"])
def test_samples_equal_cv2_packets_and_probe_equals_jax(name, files, monkeypatch):
    monkeypatch.setattr(jax_native, "available", lambda: False)
    path = files[name]
    with Mp4Reader(path) as reader:
        samples = [reader.sample(i) for i in range(len(reader))]
    assert samples == cv2_views(path, "packets")
    assert probe_video(path) == jax_probe_video(path)


LAYOUTS = {
    "moov first": dict(moov_first=True),
    "64-bit mdat": dict(large_mdat=True),
    "mdat to the end": dict(moov_first=True, mdat_to_end=True),
    "stz2, co64, 4 a chunk": dict(stz2=True, co64=True, per_chunk=4),
    "mdhd v1, identity edit, stss": dict(mdhd_version=1, edits=[(1100, 0, 1)],
                                         keyframes=[0], per_chunk=3),
    "varying durations": dict(deltas=[512, 1024] * 5 + [512], timescale=12800),
    "quicktime brand": dict(brand=b"qt  ", moov_first=True),
}


@pytest.mark.parametrize("layout", LAYOUTS)
def test_box_layouts_read_the_same(layout, files, tmp_path):
    src = files["a.mp4"]
    path = remux(src, str(tmp_path / "r.mp4"), **LAYOUTS[layout])
    with Mp4Reader(src) as a, Mp4Reader(path) as b:
        assert [a.sample(i) for i in range(len(a))] == [b.sample(i) for i in range(len(b))]
        assert b.index.config == a.index.config
    got = [f for _, f in iterate_frames(path)]
    want = [f[..., ::-1] for f in cv2_views(path, "bgr")]
    assert len(got) == len(want) == 11
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    cap = cv2.VideoCapture(path, cv2.CAP_FFMPEG)
    assert probe_video(path)["fps"] == cap.get(cv2.CAP_PROP_FPS)
    cap.release()
    if layout == "varying durations":
        assert probe_video(path)["fps"] == 12800 * 11 / (512 * 6 + 1024 * 5)


def test_mjpeg_mov_frames_equal_cv2_imdecode(files, monkeypatch, capsys):
    monkeypatch.setattr(jax_native, "available", lambda: False)
    path = files["c.mov"]
    packets = cv2_views(path, "packets")
    got = list(iterate_frames(path))
    assert [i for i, _ in got] == list(range(5))
    for (_, frame), packet in zip(got, packets):
        want = cv2.imdecode(np.frombuffer(packet, np.uint8), cv2.IMREAD_COLOR)[..., ::-1]
        np.testing.assert_array_equal(frame, want)
    gap = max(int(np.abs(f.astype(int) - w.astype(int)).max())
              for (_, f), (_, w) in zip(got, jax_iterate_frames(path)))
    with capsys.disabled():
        print(f"\ncv2 {cv2.__version__}: FFmpeg's decode of the jpeg samples is up to {gap} "
              "grey levels off cv2.imdecode")
    assert gap > 0


def test_check_source_and_the_containers():
    for name in ("a.mp4", "B.MOV", "c.avi", "a.mkv", "B.WEBM"):
        check_source(name)
    for name, missing in (("a.flv", "FFmpeg"), ("a.ts", "FFmpeg"), (0, "capture")):
        with pytest.raises(ValueError, match=missing):
            check_source(name)


# -------------------------------------------------------------- refusals


def refused(path: str, tmp_path, match: str) -> None:
    """Every surface raises ``match`` before it starts a thread or writes."""
    out = tmp_path / "out"
    for fn in (probe_video, lambda p: list(iterate_frames(p)),
               lambda p: FrameSource(p, ValTransform((32, 32))),
               lambda p: NativeFrameSource(p, (32, 32)),
               lambda p: stream_detect_video(p, None, ValTransform((32, 32)), CLASSES,
                                             output_dir=str(out), device=CPU),
               lambda p: extract_frames(p, str(out)),
               lambda p: torch_extract.main(["--input", p, "--output", str(out)])):
        with pytest.raises(ValueError, match=match):
            fn(path)
        assert not out.exists()


@pytest.mark.parametrize("kind,named", [(b"avc1", "H.264"), (b"hvc1", "HEVC"),
                                        (b"av01", "AV1"), (b"vp09", "VP9 profile 1"),
                                        (b"mp4v", "object type is 0x6a")])
def test_other_codecs_raise_naming_them(kind, named, tmp_path):
    # a vp09 track's vpcC: profile 1, 8-bit, 4:4:4 (profile 0 is read)
    config = bytes([1, 10, 0x86, 1, 1, 1, 0, 0]) if kind == b"vp09" else b""
    path = write_mp4(str(tmp_path / "x.mp4"), [b"\0\0\0\x05\x65\x88\x80\x10\x00"] * 3, 64, 48,
                     kind=kind, object_type=0x6A, config=config)
    refused(path, tmp_path, f"{named}.*FFmpeg")


@pytest.mark.parametrize("edits", [[(1000, 1024, 1)], [(500, -1, 1), (1000, 0, 1)],
                                   [(1100, 0, 2)], [(200, 0, 1)]])
def test_edit_lists_other_than_the_identity_raise(edits, files, tmp_path):
    path = remux(files["a.mp4"], str(tmp_path / "e.mp4"), edits=edits)
    refused(path, tmp_path, "edit list")


def test_truncated_files_raise_naming_what_is_missing(files, tmp_path):
    """Cut inside the moov (mdat first), or before the first whole frame
    (moov first): no frame can be read.  A cut mdat with whole frames
    reads (``test_cut_mdat_reads_to_its_last_whole_frame``)."""
    data = open(remux(files["a.mp4"], str(tmp_path / "full.mp4"), moov_first=True), "rb").read()
    index = read_index(str(tmp_path / "full.mp4"))
    cut = tmp_path / "cut.mp4"
    cut.write_bytes(data[: int(index.offsets[0]) + 10])  # inside frame 0
    refused(str(cut), tmp_path, f"frame 0 at offset {int(index.offsets[0])}.*truncated")
    tail = tmp_path / "tail.mp4"  # mdat first, cut inside the moov
    tail.write_bytes(open(files["a.mp4"], "rb").read()[:-200])
    refused(str(tail), tmp_path, "'moov' in the file is truncated")


@pytest.mark.parametrize("where", ["boundary", "inside"])
def test_cut_mdat_reads_to_its_last_whole_frame(where, files, tmp_path, jax_reads_like_the_port):
    """moov first, the mdat cut at frame 8's first byte or inside it:
    ``probe_video`` equals JAX's (OpenCV reports the sample table's 11),
    and the port's frames, through ``iterate_frames`` and both frame
    sources, are JAX's through cv2 up to the last whole frame.  Cut inside
    frame 8, FFmpeg also shows a concealed picture from the sample's head,
    which the port does not (ROADMAP Queue 3): measured, one frame more."""
    data = open(remux(files["a.mp4"], str(tmp_path / "full.mp4"), moov_first=True), "rb").read()
    index = read_index(str(tmp_path / "full.mp4"))
    cut = tmp_path / "cut.mp4"
    cut.write_bytes(data[: int(index.offsets[8]) + (10 if where == "inside" else 0)])
    path = str(cut)
    assert probe_video(path) == jax_probe_video(path)
    assert probe_video(path)["frame_count"] == 11 and len(Mp4Reader(path)) == 8
    got, want = list(iterate_frames(path)), list(jax_iterate_frames(path))
    assert [i for i, _ in got] == list(range(8))
    assert len(want) == 8 + (where == "inside")
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w)
    port_t, _ = transforms()
    native = list(NativeFrameSource(path, (SIZE, SIZE), normalize=False))
    thread = list(FrameSource(path, port_t))
    assert [n[0] for n in native] == [t[0] for t in thread] == list(range(8))
    for n, t in zip(native, thread):
        np.testing.assert_array_equal(n[2], t[2])


# --------------------------------------------------------------- surfaces


@pytest.mark.parametrize("draw,every", [(True, 1), (False, 1), (False, 3), (True, 3)])
def test_stream_detect_video_mp4_equals_jax(draw, every, files, tmp_path,
                                            jax_reads_like_the_port):
    jax_infer, variables, infer = twin_models()
    port_t, jax_t = transforms()
    kw = dict(thresh=0.0, batch_size=4, every=every, draw=draw, save_detections=True)
    path = files["a.mp4"]
    stats = stream_detect_video(path, infer, port_t, CLASSES, output_dir=str(tmp_path / "port"),
                                device=CPU, **kw)
    want = jax_stream_detect_video(path, jax_infer, variables, jax_t, CLASSES,
                                   output_dir=str(tmp_path / "jax"), **kw)
    assert stats["frames"] == want["frames"] == len(range(0, 11, every))
    assert sorted(os.listdir(tmp_path / "port")) == (["a_det.mp4", "a_det.txt"] if draw
                                                     else ["a_det.txt"])
    if draw:  # as JAX's _det.mp4 opens in cv2
        assert cv2_props(str(tmp_path / "port" / "a_det.mp4")) == cv2_props(
            str(tmp_path / "jax" / "a_det.mp4"))
    assert assert_txt_equal(str(tmp_path / "port" / "a_det.txt"),
                            str(tmp_path / "jax" / "a_det.txt")) > 0


def test_native_batches_equal_frame_source_batches(files):
    """What the device sees: the batches of both sources over an .mp4, bit
    for bit."""
    port_t, _ = transforms()
    for every in (1, 3):
        native = NativeFrameSource(files["a.mp4"], (SIZE, SIZE), every=every,
                                   normalize=False)
        thread = FrameSource(files["a.mp4"], port_t, every=every)
        got, want = list(native), list(thread)
        assert len(got) == len(want) == len(range(0, 11, every))
        for g, w in zip(got, want):
            assert g[0] == w[0]
            np.testing.assert_array_equal(g[2], w[2])
            np.testing.assert_array_equal(g[3], w[3])


@pytest.mark.parametrize("draw", [False, True])
def test_stream_detect_videos_mp4_and_avi_equal_jax(draw, files, tmp_path,
                                                    jax_reads_like_the_port):
    jax_infer, variables, infer = twin_models()
    port_t, jax_t = transforms()
    paths = [files["a.mp4"], files["d.avi"]]
    kw = dict(thresh=0.0, batch_size=4, k=1, draw=draw, save_detections=True)
    stats = torch_multistream.stream_detect_videos(paths, infer, port_t, CLASSES,
                                                   output_dir=str(tmp_path / "port"),
                                                   device=CPU, **kw)
    want = jax_stream_detect_videos(paths, jax_infer, variables, jax_t, CLASSES,
                                    output_dir=str(tmp_path / "jax"), **kw)
    assert stats["per_stream"] == want["per_stream"] == {"a.mp4": 11, "d.avi": 7}
    for stem in ("a", "d"):
        assert assert_txt_equal(str(tmp_path / "port" / f"{stem}_det.txt"),
                                str(tmp_path / "jax" / f"{stem}_det.txt")) > 0


@pytest.fixture(scope="module")
def tiny_weights(tmp_path_factory):
    """JAX's initial weights of the tiny YOLOv3 over VOC, as an .npz file."""
    path = str(tmp_path_factory.mktemp("weights") / "tiny.npz")
    module, _ = jax_get_model("yolo3_tiny_darknet_voc", policy=JAX_F32)
    v = jax.jit(lambda: module.init(jax.random.key(0), jnp.zeros((1, SIZE, SIZE, 3)),
                                    train=False))()
    save_weights_npz(path, v["params"], v["batch_stats"])
    return path


def test_detect_cli_mp4_equals_jax(files, tiny_weights, tmp_path, monkeypatch,
                                   jax_reads_like_the_port):
    monkeypatch.setattr(jax_detect, "build_model",
                        functools.partial(jax_detect.build_model, policy=JAX_F32))
    monkeypatch.setattr(torch_detect, "build_model",
                        functools.partial(torch_detect.build_model, policy=FLOAT32_POLICY))
    monkeypatch.setenv("VIDDET_PAIR_TOPK", "det")
    jax.clear_caches()
    done = _cli(torch_detect.main, files["a.mp4"], str(tmp_path / "port"), tiny_weights,
                "--no-draw")
    _cli(jax_detect.main, files["a.mp4"], str(tmp_path / "jax"), tiny_weights, "--no-draw")
    assert done == 11
    assert os.listdir(tmp_path / "port") == ["a_det.txt"]
    assert assert_txt_equal(str(tmp_path / "port" / "a_det.txt"),
                            str(tmp_path / "jax" / "a_det.txt")) > 0


@pytest.mark.parametrize("every", [1, 2])
def test_extract_frames_mp4_equals_jax(every, files, tmp_path, monkeypatch):
    monkeypatch.setattr(jax_native, "available", lambda: False)
    for name, n in (("a.mp4", 11), ("b.mov", 7)):
        port, jax_out = tmp_path / "port" / name, tmp_path / "jax" / name
        for main, out in ((torch_extract.main, port), (jax_extract.main, jax_out)):
            main(["--input", files[name], "--output", str(out), "--every", str(every)])
        names = sorted(os.listdir(port))
        assert names == sorted(os.listdir(jax_out)) and len(names) == len(range(0, n, every))
        for f in names:
            assert (port / f).read_bytes() == (jax_out / f).read_bytes(), (name, f)
