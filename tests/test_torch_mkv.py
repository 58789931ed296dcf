"""The port's Matroska / WebM demuxer (``native/mkv.py``) and the video
surfaces over it, against OpenCV and the JAX package on the CPU.

* Demux: a VP8 WebM laid out every way ``tests.torch_mkv_helpers`` writes
  it (unknown-size segment and clusters, Xiph, EBML and fixed-size lacing,
  ``BlockGroup``s with Opus blocks between the video's, a second video
  track, an audio track first, no SeekHead / Cues / Tags / Void / CRC-32)
  gives the frames it was written with, and each shown frame equals
  OpenCV's read; ``fps`` and ``frame_count`` equal OpenCV's, hidden alt-ref
  frames not counted.  Without ``DefaultDuration`` the rate of evenly
  spaced frames equals FFmpeg's; of jittered ones it does not (ROADMAP
  Queue 3, held here).
* Other codecs in Matroska: the ``.mkv`` OpenCV writes with ``XVID``
  (``V_MPEG4/ISO/ASP``) and ``MJPG`` (``V_MJPEG``), B-VOP streams as
  ``V_MPEG4/ISO/ASP`` and as ``V_MS/VFW/FOURCC`` ``XVID`` with packed
  B-frames: MPEG-4 frames equal OpenCV's, JPEG frames ``cv2.imdecode``'s.
* Refusals: VP9 profile 1 (4:4:4), AV1, H.264, HEVC and Theora tracks, a VfW fourcc the port
  does not read, a ContentEncoding (header stripping, encryption), another
  DocType, a newer DocTypeReadVersion, no video track, a VP8 track that
  starts with an inter frame, a key frame of another size than the track
  or of a changing size, and a file cut inside its Tracks raise ValueError
  naming what, before any thread starts or anything is written.  A
  recording cut inside a block reads to its last whole frame, equal to
  JAX's read through cv2, ``probe_video`` included.
* Surfaces against JAX (tiny float32 YOLOv3 at 64 px; JAX reads through
  cv2's FFmpeg, its native source off): ``probe_video``, ``iterate_frames``
  (bit for bit), ``stream_detect_video`` (both sources), the two sources'
  batches, ``stream_detect_videos`` over a ``.webm`` and an ``.mkv``,
  ``detect --input clip.webm`` and ``extract_frames``.
"""

import functools
import os
import struct

import cv2
import jax
import numpy as np
import pytest

import viddet_tpu.cli.detect as jax_detect
import viddet_tpu.cli.extract_frames as jax_extract
import viddet_tpu.native as jax_native
import viddet_tpu_torch.cli.detect as torch_detect
import viddet_tpu_torch.cli.extract_frames as torch_extract
import viddet_tpu_torch.infer.multistream as torch_multistream
from tests.fixtures.make_mp4_fixture import lavc_stream, moving_scene
from tests.test_torch_mp4 import refused, tiny_weights  # noqa: F401
from tests.test_torch_stream import SIZE, twin_models
from tests.test_torch_video_stream import CLASSES, CPU, _cli, assert_txt_equal, transforms
from tests.torch_mkv_helpers import (encryption, header_stripping, other_codec_mkv, track_entry,
                                     vp8_packets, vp8_webm, vp9_mkv, write_mkv)
from tests.torch_mp4_helpers import cv2_views, pack_bframes
from tests.torch_video_helpers import cv2_props
from viddet_tpu.core.precision import FLOAT32_POLICY as JAX_F32
from viddet_tpu.infer.multistream import stream_detect_videos as jax_stream_detect_videos
from viddet_tpu.infer.stream import stream_detect_video as jax_stream_detect_video
from viddet_tpu.utils.video import iterate_frames as jax_iterate_frames
from viddet_tpu.utils.video import probe_video as jax_probe_video
from viddet_tpu_torch.core.precision import FLOAT32_POLICY
from viddet_tpu_torch.infer.stream import FrameSource, NativeFrameSource, stream_detect_video
from viddet_tpu_torch.native.mkv import MkvReader, read_index, reduce_fraction
from viddet_tpu_torch.utils.video import iterate_frames, probe_video

W, H = 128, 96
VOP = b"\x00\x00\x01\xb6"


@pytest.fixture(scope="module")
def vp8(tmp_path_factory):
    """A 12-frame VP8 stream at 128x96 (two token partitions), and a WebM
    of it."""
    packets, _ = vp8_packets(moving_scene(12, W, H, seed=5), {"b": 300000, "slices": 2})
    path = write_mkv(str(tmp_path_factory.mktemp("mkv") / "clip.webm"), packets, W, H)
    return packets, path


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """OpenCV's XVID and MJPG .mkv files, and a B-VOP stream (libavcodec's
    mpeg4, ``bf`` 1) as V_MPEG4/ISO/ASP and as a VfW XVID track with packed
    B-frames."""
    d = tmp_path_factory.mktemp("mkv_other")
    out = {}
    for fourcc in ("XVID", "MJPG"):
        path = str(d / f"cv2_{fourcc}.mkv")
        writer = cv2.VideoWriter(path, cv2.CAP_FFMPEG, cv2.VideoWriter_fourcc(*fourcc), 25.0,
                                 (W, H))
        assert writer.isOpened()
        for f in moving_scene(9, W, H, seed=3):
            writer.write(f)
        writer.release()
        out[fourcc] = path
    bf = lavc_stream(moving_scene(14, W, H, seed=2), {"bf": 1})
    first = bf.packets[0]
    vop = first.find(VOP)
    times = [p * 40 for p in bf.pts]
    out["asp"] = write_mkv(str(d / "asp.mkv"), [first[vop:]] + bf.packets[1:], W, H,
                           codec="V_MPEG4/ISO/ASP", doc_type="matroska", private=first[:vop],
                           times=times)
    at = first.find(b"\x00\x00\x01\xb3") if b"\x00\x00\x01\xb3" in first else vop
    packets = [first[:at] + b"\x00\x00\x01\xb2DivX503b1393p" + first[at:]] + bf.packets[1:]
    bih = struct.pack("<IiiHH4sIiiII", 40, W, H, 1, 24, b"XVID", W * H * 3, 0, 0, 0, 0)
    out["vfw_packed"] = write_mkv(str(d / "vfw.mkv"), pack_bframes(packets, bf.types, 5), W, H,
                                  codec="V_MS/VFW/FOURCC", doc_type="matroska", private=bih)
    return out


def assert_frames_equal_cv2(path: str, count: int) -> None:
    got = list(iterate_frames(path))
    want = cv2_views(path, "bgr")
    assert [i for i, _ in got] == list(range(count)) and len(want) == count
    for (_, g), w in zip(got, want):
        np.testing.assert_array_equal(g, w[..., ::-1])


# ------------------------------------------------------------------ demux


def pad(frames):
    """VP8 frames padded with zeros to one size (the last partition reads
    zeros past its end anyway), for fixed-size lacing."""
    n = max(map(len, frames))
    return [f + bytes(n - len(f)) for f in frames]


LAYOUTS = {
    "unknown sizes": dict(unknown_sizes=True),
    "xiph lacing": dict(lacing="xiph", per_block=3),
    "ebml lacing": dict(lacing="ebml", per_block=4),
    "fixed lacing": dict(lacing="fixed", per_block=2),
    "block groups and audio": dict(block_groups=True, audio=True),
    "two video tracks": dict(second_video="reversed"),
    "audio track first": dict(first_track=track_entry(5, "A_VORBIS", kind=2,
                                                      private=b"\x02\x1e\x00" + bytes(30))),
    "no extras, one cluster": dict(extras=False, per_cluster=12, doc_type="matroska"),
}


@pytest.mark.parametrize("layout", LAYOUTS)
def test_layouts_read_the_written_frames(layout, vp8, tmp_path):
    packets, _ = vp8
    kw = dict(LAYOUTS[layout])
    frames = pad(packets) if layout == "fixed lacing" else packets
    if kw.get("second_video"):
        kw["second_video"] = packets[::-1]
    path = write_mkv(str(tmp_path / "l.webm"), frames, W, H, **kw)
    with MkvReader(path) as reader:
        assert [reader.sample(i) for i in range(len(frames))] == frames
        assert reader.index.codec == "vp8" and reader.index.frame_count == 12
    assert_frames_equal_cv2(path, 12)
    cap = cv2.VideoCapture(path, cv2.CAP_FFMPEG)
    assert probe_video(path) == {"fps": cap.get(cv2.CAP_PROP_FPS), "width": W, "height": H,
                                 "frame_count": int(cap.get(cv2.CAP_PROP_FRAME_COUNT))}
    cap.release()


def test_hidden_frames_are_not_counted(tmp_path):
    path = vp8_webm(str(tmp_path / "arf.webm"), moving_scene(17, 96, 64, seed=8),
                    {"b": 300000, "auto-alt-ref": 1, "lag-in-frames": 16}, two_pass=True)
    index = read_index(path)
    assert len(index.offsets) > index.frame_count == 17
    cap = cv2.VideoCapture(path, cv2.CAP_FFMPEG)
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == probe_video(path)["frame_count"] == 17
    cap.release()
    assert_frames_equal_cv2(path, 17)


@pytest.mark.parametrize("rate", ["25", "30000/1001", "no DefaultDuration", "jittered"])
def test_fps_equals_ffmpeg_but_for_jittered_timestamps(rate, vp8, tmp_path):
    packets, _ = vp8
    kw = {"25": dict(default_duration=40_000_000),
          "30000/1001": dict(default_duration=33_366_667,
                             times=[i * 1001 // 30 for i in range(12)]),
          "no DefaultDuration": dict(default_duration=None),
          "jittered": dict(default_duration=None, times=[round(i * 1000 / 30) for i in range(12)]),
          }[rate]
    path = write_mkv(str(tmp_path / "r.webm"), packets, W, H, **kw)
    cap = cv2.VideoCapture(path, cv2.CAP_FFMPEG)
    ffmpeg = cap.get(cv2.CAP_PROP_FPS)
    cap.release()
    fps = probe_video(path)["fps"]
    if rate == "jittered":  # millisecond timestamps of 30 fps: FFmpeg guesses 30, the mean is 29.97
        assert (ffmpeg, fps) == (30.0, 30000 / 1001)
    else:
        assert fps == ffmpeg
    assert reduce_fraction(10**9, 33_366_667, 30000) == (30000, 1001)


# ----------------------------------------------------------- other codecs


@pytest.mark.parametrize("name,count", [("XVID", 9), ("asp", 14), ("vfw_packed", 14)])
def test_mpeg4_in_matroska_equals_cv2(name, count, files):
    assert read_index(files[name]).codec == "mpeg4"
    assert_frames_equal_cv2(files[name], count)


def test_mjpeg_in_matroska_equals_cv2_imdecode(files):
    path = files["MJPG"]
    assert read_index(path).codec == "jpeg"
    got = list(iterate_frames(path))
    packets = cv2_views(path, "packets")
    assert len(got) == len(packets) == 9
    for (_, frame), packet in zip(got, packets):
        want = cv2.imdecode(np.frombuffer(packet, np.uint8), cv2.IMREAD_COLOR)[..., ::-1]
        np.testing.assert_array_equal(frame, want)
    gap = max(int(np.abs(f.astype(int) - b[..., ::-1].astype(int)).max())
              for (_, f), b in zip(got, cv2_views(path, "bgr")))
    assert gap > 0  # FFmpeg's JPEG decoder, what JAX reads (ROADMAP Queue 3)


# -------------------------------------------------------------- refusals


REFUSALS = {
    "VP9": (dict(codec="V_VP9"), "VP9 profile 1 .*FFmpeg"),  # 4:4:4; profile 0 is read
    "AV1": (dict(codec="V_AV1"), "AV1.*FFmpeg"),
    "H.264": (dict(codec="V_MPEG4/ISO/AVC"), "H.264.*FFmpeg"),
    "HEVC": (dict(codec="V_MPEGH/ISO/HEVC"), "HEVC.*FFmpeg"),
    "Theora": (dict(codec="V_THEORA"), "Theora.*FFmpeg"),
    "VfW H264": (dict(codec="V_MS/VFW/FOURCC", private=struct.pack("<IiiHH4s", 40, W, H, 1, 24,
                                                                    b"H264") + bytes(20)),
                 "fourcc 'H264'.*FFmpeg"),
    "header stripping": (dict(encoding=header_stripping(b"\x9d")), "ContentEncoding"),
    "encryption": (dict(encoding=encryption()), "ContentEncoding"),
    "DocType": (dict(doc_type="mp4"), "DocType is 'mp4'"),
    "read version": (dict(read_version=5), "reader of version 5"),
    "no video": (dict(kind=2), "no video track"),
    "inter frame first": (dict(start=1), "does not start with a key frame"),
    "track size": (dict(size=(64, 48)), "key frames are 128x96, the track says 64x48"),
}


@pytest.mark.parametrize("case", REFUSALS)
def test_refusals_raise_before_any_frame(case, vp8, tmp_path):
    packets, _ = vp8
    kw, match = REFUSALS[case]
    kw = dict(kw)
    frames = packets[kw.pop("start", 0):]
    w, h = kw.pop("size", (W, H))
    if kw.get("codec") == "V_VP9":
        path = vp9_mkv(str(tmp_path / "in" / "a.mkv"))
    elif kw.get("codec", "V_VP8") != "V_VP8" and "private" not in kw:
        path = other_codec_mkv(str(tmp_path / "in" / "a.mkv"), kw["codec"])
    else:
        path = write_mkv(str(tmp_path / "a.webm"), frames, w, h, **kw)
    refused(path, tmp_path, match)


def test_size_changes_and_cut_files_raise_naming_the_frame(vp8, tmp_path):
    """A key frame of another size, and a file cut inside its Tracks
    element (the frames' cut is read: ``test_cut_files_read_to_...``)."""
    packets, _ = vp8
    small, _ = vp8_packets(moving_scene(2, 64, 48, seed=1), {"b": 100000})
    path = write_mkv(str(tmp_path / "s.webm"), packets[:6] + small, W, H)
    refused(path, tmp_path, "VP8 key frame 6 changes the frame size from 128x96 to 64x48")
    for unknown in (False, True):
        full = open(write_mkv(str(tmp_path / "full.webm"), packets, W, H, unknown_sizes=unknown),
                    "rb").read()
        cut = tmp_path / "cut.webm"  # cut inside the Tracks element
        cut.write_bytes(full[: full.find(b"\x16\x54\xae\x6b") + 12])
        refused(str(cut), tmp_path, "element 0x1654AE6B at offset [0-9]+ is truncated")


@pytest.mark.parametrize("unknown", [False, True])
@pytest.mark.parametrize("where", [-2, 0, 10])
def test_cut_files_read_to_their_last_whole_frame(unknown, where, vp8, tmp_path,
                                                  jax_reads_ffmpeg):
    """A recording cut inside frame 9 (its block header, at its payload's
    first byte, or inside the payload), in a segment and clusters of known
    or of unknown size: ``probe_video`` equals JAX's (OpenCV's count is the
    Duration's 12), and the port's frames, through ``iterate_frames`` and
    both frame sources, equal JAX's ``iterate_frames`` through cv2: the
    nine whole frames, as FFmpeg drops the cut block."""
    packets, _ = vp8
    full = write_mkv(str(tmp_path / "full.webm"), packets, W, H, unknown_sizes=unknown)
    cut = tmp_path / "cut.webm"
    cut.write_bytes(open(full, "rb").read()[: int(read_index(full).offsets[9]) + where])
    path = str(cut)
    assert probe_video(path) == jax_probe_video(path)
    assert probe_video(path)["frame_count"] == 12 and len(MkvReader(path)) == 9
    got, want = list(iterate_frames(path)), list(jax_iterate_frames(path))
    assert [i for i, _ in got] == [i for i, _ in want] == list(range(9))
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w)
    port_t, _ = transforms()
    native = list(NativeFrameSource(path, (SIZE, SIZE), normalize=False))
    thread = list(FrameSource(path, port_t))
    assert [n[0] for n in native] == [t[0] for t in thread] == list(range(9))
    for n, t in zip(native, thread):
        np.testing.assert_array_equal(n[2], t[2])


# --------------------------------------------------------------- surfaces


@pytest.fixture
def jax_reads_ffmpeg(monkeypatch):
    """JAX's sources read through cv2's default (FFmpeg) backend; its own
    FFmpeg-linked native source is off."""
    monkeypatch.setattr(jax_native, "available", lambda: False)


def test_probe_and_frames_equal_jax(vp8, files, jax_reads_ffmpeg):
    _, path = vp8
    for p in (path, files["asp"]):
        assert probe_video(p) == jax_probe_video(p)
    got, want = list(iterate_frames(path, every=2)), list(jax_iterate_frames(path, every=2))
    assert [i for i, _ in got] == [i for i, _ in want] == list(range(0, 12, 2))
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("draw,every", [(False, 1), (True, 3)])
def test_stream_detect_video_webm_equals_jax(draw, every, vp8, tmp_path, jax_reads_ffmpeg):
    _, path = vp8
    jax_infer, variables, infer = twin_models()
    port_t, jax_t = transforms()
    kw = dict(thresh=0.0, batch_size=4, every=every, draw=draw, save_detections=True)
    stats = stream_detect_video(path, infer, port_t, CLASSES, output_dir=str(tmp_path / "port"),
                                device=CPU, **kw)
    want = jax_stream_detect_video(path, jax_infer, variables, jax_t, CLASSES,
                                   output_dir=str(tmp_path / "jax"), **kw)
    assert stats["frames"] == want["frames"] == len(range(0, 12, every))
    assert sorted(os.listdir(tmp_path / "port")) == (["clip_det.mp4", "clip_det.txt"] if draw
                                                     else ["clip_det.txt"])
    if draw:  # as JAX's _det.mp4 opens in cv2
        assert cv2_props(str(tmp_path / "port" / "clip_det.mp4")) == cv2_props(
            str(tmp_path / "jax" / "clip_det.mp4"))
    assert assert_txt_equal(str(tmp_path / "port" / "clip_det.txt"),
                            str(tmp_path / "jax" / "clip_det.txt")) > 0


def test_native_batches_equal_frame_source_batches(vp8, files):
    port_t, _ = transforms()
    for path, every in ((vp8[1], 1), (vp8[1], 3), (files["vfw_packed"], 2)):
        native = list(NativeFrameSource(path, (SIZE, SIZE), every=every, normalize=False))
        thread = list(FrameSource(path, port_t, every=every))
        assert len(native) == len(thread) > 0
        for g, w in zip(native, thread):
            assert g[0] == w[0]
            np.testing.assert_array_equal(g[2], w[2])
            np.testing.assert_array_equal(g[3], w[3])


def test_stream_detect_videos_webm_and_mkv_equal_jax(vp8, files, tmp_path, jax_reads_ffmpeg):
    jax_infer, variables, infer = twin_models()
    port_t, jax_t = transforms()
    paths = [vp8[1], files["asp"]]
    kw = dict(thresh=0.0, batch_size=4, k=1, draw=False, save_detections=True)
    stats = torch_multistream.stream_detect_videos(paths, infer, port_t, CLASSES,
                                                   output_dir=str(tmp_path / "port"),
                                                   device=CPU, **kw)
    want = jax_stream_detect_videos(paths, jax_infer, variables, jax_t, CLASSES,
                                    output_dir=str(tmp_path / "jax"), **kw)
    assert stats["per_stream"] == want["per_stream"] == {"clip.webm": 12, "asp.mkv": 14}
    for stem in ("clip", "asp"):
        assert assert_txt_equal(str(tmp_path / "port" / f"{stem}_det.txt"),
                                str(tmp_path / "jax" / f"{stem}_det.txt")) > 0


def test_detect_cli_webm_equals_jax(vp8, tiny_weights, tmp_path, monkeypatch,  # noqa: F811
                                    jax_reads_ffmpeg):
    monkeypatch.setattr(jax_detect, "build_model",
                        functools.partial(jax_detect.build_model, policy=JAX_F32))
    monkeypatch.setattr(torch_detect, "build_model",
                        functools.partial(torch_detect.build_model, policy=FLOAT32_POLICY))
    monkeypatch.setenv("VIDDET_PAIR_TOPK", "det")
    jax.clear_caches()
    _, path = vp8
    done = _cli(torch_detect.main, path, str(tmp_path / "port"), tiny_weights, "--no-draw")
    _cli(jax_detect.main, path, str(tmp_path / "jax"), tiny_weights, "--no-draw")
    assert done == 12
    assert os.listdir(tmp_path / "port") == ["clip_det.txt"]
    assert assert_txt_equal(str(tmp_path / "port" / "clip_det.txt"),
                            str(tmp_path / "jax" / "clip_det.txt")) > 0


def test_extract_frames_webm_equals_jax(vp8, tmp_path, jax_reads_ffmpeg):
    _, path = vp8
    port, jax_out = tmp_path / "port", tmp_path / "jax"
    for main, out in ((torch_extract.main, port), (jax_extract.main, jax_out)):
        main(["--input", path, "--output", str(out), "--every", "3"])
    names = sorted(os.listdir(port))
    assert names == sorted(os.listdir(jax_out)) and len(names) == 4
    for f in names:
        assert (port / f).read_bytes() == (jax_out / f).read_bytes(), f
