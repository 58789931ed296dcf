"""The port's VP9 decoder (``native/vp9.cpp``, ``native.Vp9Decoder``)
against OpenCV's FFmpeg on the CPU, and VP9 WebM / Matroska / MP4 files on
every surface that reads video against the JAX package.

Every stream is encoded here by the libvpx-vp9 encoder inside the
opencv-python wheel's libavcodec (``tests.torch_mkv_helpers.vp9_packets``),
laid out as a WebM and read back both ways: every shown frame's Y plane
(``CAP_PROP_CONVERT_RGB`` 0) and RGB frame equal OpenCV's bit for bit, and
the decoder reports the features the stream claims to exercise:

* key frames only (intra prediction of every size, 32x32 transforms,
  blocks below 8x8);
* inter frames (switchable filters, the previous frame's vectors, vectors
  off the frame, intra blocks in inter frames);
* two passes with ``auto-alt-ref``: superframes, hidden frames and compound
  prediction;
* tile columns at a width of 640 and tile rows;
* lossless (the Walsh-Hadamard transform);
* ``aq-mode`` 1, 2 and 3 (segmentation with a per-segment quantiser), the
  last in real-time error-resilient mode (segment map prediction);
* ``frame-parallel`` 0 (backward probability adaptation) and 1;
* a loop filter sharpness of 5 (libvpx-vp9 writes 0 whatever its option
  asks, so the test writes 5 into the frames' headers, which the encoder
  does not read back: the stream stays valid);
* a size that is not a multiple of 8 (202x118);
* ``colorspace`` bt709 / smpte240m / bt2020nc and ``color_range`` pc: OpenCV
  converts with the coefficients and range the stream signals, and so
  does the port.  There OpenCV's raw view is no longer the Y plane (swscale
  converts it to GRAY8), so those streams hold the RGB frames alone;
* a ``show_existing_frame`` packet spliced into a stream.

At an odd height OpenCV's swscale leaves its yuv2rgb path for its scaler,
as for VP8 (ROADMAP Queue 3): the Y plane is exact and the RGB frame is
not.  A truncated frame and one whose frame marker is flipped raise
ValueError naming the file and the frame, after the frames before them,
through both readers; an inter frame before any key frame, profile 1 and a
change of frame size raise in the decoder, and a track of another profile
or size before any frame is decoded.
"""

import functools
import os

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
from tests.fixtures.make_mp4_fixture import moving_scene
from tests.test_torch_mp4 import refused, tiny_weights  # noqa: F401
from tests.test_torch_stream import SIZE, twin_models
from tests.test_torch_video_stream import CLASSES, CPU, _cli, assert_txt_equal, transforms
from tests.torch_mkv_helpers import vp9_packets, vp9_webm, write_mkv
from tests.torch_mp4_helpers import cv2_views, write_mp4
from viddet_tpu.core.precision import FLOAT32_POLICY as JAX_F32
from viddet_tpu.infer.multistream import stream_detect_videos as jax_stream_detect_videos
from viddet_tpu.infer.stream import stream_detect_video as jax_stream_detect_video
from viddet_tpu.utils.video import iterate_frames as jax_iterate_frames
from viddet_tpu.utils.video import probe_video as jax_probe_video
from viddet_tpu_torch.core.precision import FLOAT32_POLICY
from viddet_tpu_torch.infer.stream import FrameSource, NativeFrameSource, stream_detect_video
from viddet_tpu_torch.native import Vp9Decoder
from viddet_tpu_torch.native.mkv import MkvReader, vp9_superframe
from viddet_tpu_torch.utils.video import iterate_frames, probe_video

BASE = {"b": 300000}
COMMON = {"key frame", "inter frame"}
# name: (encoder options, frames, width, height, two passes, features the stream must use)
STREAMS = {
    "key frames only": ({"g": 1, "b": 400000}, 4, 96, 64, False,
                        {"key frame", "32x32 transforms", "blocks below 8x8"}),
    "inter frames": (BASE, 10, 160, 96, False,
                     COMMON | {"switchable filters", "previous frame vectors",
                               "vectors off the frame", "intra in inter frames",
                               "high precision vectors", "smooth filter"}),
    "alt-ref two pass": ({**BASE, "auto-alt-ref": 1, "lag-in-frames": 16}, 24, 192, 128, True,
                         COMMON | {"superframe", "hidden frame", "compound prediction"}),
    "tile columns": ({"b": 800000, "tile-columns": 2, "cpu-used": 4}, 4, 640, 96, False,
                     COMMON | {"tile columns"}),
    "tile rows": ({"b": 600000, "tile-columns": 1, "tile-rows": 2, "cpu-used": 4}, 3, 512, 256,
                  False, COMMON | {"tile columns", "tile rows"}),
    "lossless": ({"lossless": 1}, 4, 96, 64, False, COMMON | {"lossless"}),
    "aq-mode 1": ({"b": 200000, "aq-mode": 1}, 8, 128, 80, False,
                  COMMON | {"segmentation", "segment quantiser"}),
    "aq-mode 2": ({"b": 200000, "aq-mode": 2}, 8, 128, 80, False,
                  COMMON | {"segmentation", "segment quantiser"}),
    "aq-mode 3 real-time": ({"b": 200000, "aq-mode": 3, "error-resilient": 1,
                             "deadline": "realtime", "cpu-used": 8}, 10, 128, 80, False,
                            COMMON | {"segmentation", "segment quantiser",
                                      "segment map prediction", "error resilient"}),
    "frame-parallel 0": ({**BASE, "frame-parallel": 0}, 8, 128, 80, False,
                         COMMON | {"probability adaptation"}),
    "frame-parallel 1": ({**BASE, "frame-parallel": 1}, 8, 128, 80, False,
                         COMMON | {"frame parallel"}),
    "sharpness": ({"b": 200000}, 6, 128, 80, False, COMMON | {"sharpness"}),
    "202x118": (BASE, 6, 202, 118, False, COMMON),
    "bt709": ({**BASE, "colorspace": "bt709"}, 4, 128, 80, False, {"colour information"}),
    "smpte240m": ({**BASE, "colorspace": "smpte240m"}, 4, 128, 80, False,
                  {"colour information"}),
    "bt2020 full range": ({**BASE, "colorspace": "bt2020nc", "color_range": "pc"}, 4, 128, 80,
                          False, {"colour information"}),
    "full range": ({**BASE, "color_range": "pc"}, 4, 128, 80, False, {"colour information"}),
}
COLOUR = {"bt709", "smpte240m", "bt2020 full range", "full range"}


class _Bits:
    def __init__(self, data: bytes):
        self.data, self.pos = bytearray(data), 0

    def read(self, n: int = 1) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | (self.data[self.pos >> 3] >> (7 - (self.pos & 7))) & 1
            self.pos += 1
        return v

    def write(self, n: int, v: int) -> None:
        for i in reversed(range(n)):
            byte, bit = self.pos >> 3, 7 - (self.pos & 7)
            self.data[byte] = (self.data[byte] & ~(1 << bit)) | (((v >> i) & 1) << bit)
            self.pos += 1


def with_sharpness(frame: bytes, sharpness: int) -> bytes:
    """A profile 0 frame with its loop filter sharpness field set (3 bits
    whose place the header's earlier fields fix)."""
    b = _Bits(frame)
    b.read(4)
    if b.read():  # show_existing_frame
        return frame
    key, show, error_res = b.read() == 0, b.read(), b.read()
    intra_only = 0
    if key:
        b.read(24 + 4 + 32)
    else:
        intra_only = b.read() if not show else 0
        b.read(0 if error_res else 2)
        if intra_only:
            b.read(24 + 8 + 32)
        else:
            b.read(8 + 12)
            if not any(b.read() for _ in range(3)):
                b.read(32)
    if b.read():  # render size
        b.read(32)
    if not key and not intra_only:
        b.read()  # allow_high_precision_mv
        if not b.read():  # not switchable: the filter's literal
            b.read(2)
    b.read(0 if error_res else 2)
    b.read(2 + 6)  # frame context, filter level
    b.write(3, sharpness)
    return bytes(b.data)


def sharpened(packet: bytes, sharpness: int = 5) -> bytes:
    frames = vp9_superframe(packet, 0, len(packet))
    if frames == [(0, len(packet))]:
        return with_sharpness(packet, sharpness)
    out = bytearray(packet)
    for at, n in frames:
        out[at:at + n] = with_sharpness(packet[at:at + n], sharpness)
    return bytes(out)


def decode_all(path: str):
    """Each shown frame's (RGB, Y) through ``Vp9Decoder`` over the file's
    samples, and the decoder's features."""
    decoder = Vp9Decoder(path)
    out = []
    with MkvReader(path) as reader:
        for i in range(len(reader.index.offsets)):
            rgb = decoder.decode(reader.sample(i))
            if rgb is not None:
                out.append((rgb, decoder.planes()[0]))
    return out, decoder.features


def cv2_frames(path: str, y_plane: bool = True):
    bgr = cv2_views(path, "bgr")
    h, w = bgr[0].shape[:2]
    ys = [y.reshape(-1)[: h * w].reshape(h, w) for y in cv2_views(path, "y")] if y_plane else [
        None] * len(bgr)
    return [(b[..., ::-1], y) for b, y in zip(bgr, ys)]


@pytest.mark.parametrize("name", STREAMS)
def test_frames_equal_cv2_bit_for_bit(name, tmp_path):
    options, n, w, h, two_pass, features = STREAMS[name]
    frames = moving_scene(n, w, h, seed=len(name))
    path = str(tmp_path / "v.webm")
    if name == "sharpness":
        packets, pts = vp9_packets(frames, options)
        write_mkv(path, [sharpened(p) for p in packets], w, h, codec="V_VP9",
                  times=[p * 40 for p in pts])
    else:
        vp9_webm(path, frames, options, two_pass)
    got, used = decode_all(path)
    want = cv2_frames(path, y_plane=name not in COLOUR)
    assert len(got) == len(want) == n
    for k, ((rgb, y), (want_rgb, want_y)) in enumerate(zip(got, want)):
        if want_y is not None:
            np.testing.assert_array_equal(y, want_y, err_msg=f"{name} frame {k} Y")
        np.testing.assert_array_equal(rgb, want_rgb, err_msg=f"{name} frame {k} RGB")
    assert features <= used, features - used
    if name == "key frames only":
        assert "inter frame" not in used
    assert [i for i, _ in iterate_frames(path)] == list(range(n))
    assert probe_video(path)["frame_count"] == n


def test_odd_height_y_exact_rgb_is_swscale_scaler_gap(tmp_path):
    """99x67: the Y planes equal OpenCV's; its RGB frames come from swscale's
    bicubic scaler, not the yuv2rgb path the port reproduces (ROADMAP
    Queue 3), so the RGB frames differ where chroma changes."""
    path = vp9_webm(str(tmp_path / "odd.webm"), moving_scene(5, 99, 67, seed=4), BASE)
    got, _ = decode_all(path)
    want = cv2_frames(path)
    assert len(got) == len(want) == 5
    gap = 0
    for (rgb, y), (want_rgb, want_y) in zip(got, want):
        np.testing.assert_array_equal(y, want_y)
        assert rgb.shape == want_rgb.shape == (67, 99, 3)
        gap = max(gap, int(np.abs(rgb.astype(int) - want_rgb).max()))
    assert gap > 0


@pytest.fixture(scope="module")
def stream():
    """A 12-frame VP9 stream at 128x80."""
    packets, _ = vp9_packets(moving_scene(12, 128, 80, seed=9), BASE)
    return packets


@pytest.mark.parametrize("slot", [0, 3])
def test_show_existing_frame_equals_cv2(slot, stream, tmp_path):
    """A one-byte show_existing_frame packet (0x88 | slot) spliced after
    frame 5 shows that slot's frame again, as FFmpeg shows it."""
    packets = list(stream[:6]) + [bytes([0x88 | slot])] + list(stream[6:])
    path = write_mkv(str(tmp_path / "e.webm"), packets, 128, 80, codec="V_VP9")
    got, used = decode_all(path)
    want = cv2_frames(path)
    assert len(got) == len(want) == 13
    for (rgb, y), (want_rgb, want_y) in zip(got, want):
        np.testing.assert_array_equal(y, want_y)
        np.testing.assert_array_equal(rgb, want_rgb)
    assert "show existing frame" in used
    assert probe_video(path)["frame_count"] == 13


@pytest.mark.parametrize("damage", ["truncated", "frame marker"])
def test_damaged_frame_raises_after_the_frames_before_it(damage, stream, tmp_path):
    packets = list(stream)
    if damage == "truncated":
        packets[5] = packets[5][: len(packets[5]) // 2]
        match = "tile 0,0's data runs past its end"
    else:
        packets[5] = bytes([packets[5][0] ^ 0x80]) + packets[5][1:]
        match = "a bad frame marker"
    path = write_mkv(str(tmp_path / "d.webm"), packets, 128, 80, codec="V_VP9")
    frames = []
    with pytest.raises(ValueError, match=f"{path} frame 5: VP9 decode: {match}"):
        for i, _ in iterate_frames(path):
            frames.append(i)
    assert frames == [0, 1, 2, 3, 4]
    got = []
    with pytest.raises(ValueError, match=f"{path}: frame 5: {match}"):
        for i, _, _, _ in NativeFrameSource(path, (32, 32)):
            got.append(i)
    assert got == [0, 1, 2, 3, 4]


def test_frames_the_decoder_refuses(stream):
    with pytest.raises(ValueError, match="s: VP9 decode: an inter frame before the first key"):
        Vp9Decoder("s").decode(stream[1])
    small, _ = vp9_packets(moving_scene(1, 64, 48, seed=1), BASE)
    decoder = Vp9Decoder("s")
    decoder.decode(stream[0])
    with pytest.raises(ValueError, match="frame size changes from 128x80 to 64x48.*FFmpeg"):
        decoder.decode(small[0])
    profile1, _ = vp9_packets(moving_scene(1, 64, 48, seed=2), {"profile": 1, "b": 200000},
                              pix_fmt="yuv444p")
    with pytest.raises(ValueError, match="VP9 profile 1 .*FFmpeg"):
        Vp9Decoder("s").decode(profile1[0])
    with pytest.raises(ValueError, match="an empty frame"):
        Vp9Decoder("s").decode(b"")


@pytest.mark.parametrize("case", ["size change", "track size", "inter frame first"])
def test_track_refusals_raise_before_any_frame(case, stream, tmp_path):
    small, _ = vp9_packets(moving_scene(2, 64, 48, seed=1), BASE)
    packets, size, match = list(stream), (128, 80), ""
    if case == "size change":
        packets = packets[:6] + small
        match = "VP9 frame 6 changes the frame size from 128x80 to 64x48.*FFmpeg"
    elif case == "track size":
        size, match = (64, 48), "VP9 frames are 128x80, the track says 64x48"
    else:
        packets, match = packets[1:], "does not start with a key frame"
    path = write_mkv(str(tmp_path / "r.webm"), packets, *size, codec="V_VP9")
    refused(path, tmp_path, match)


# ------------------------------------------------------------- every surface


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """One 12-frame VP9 stream (two passes: hidden frames in superframes) as
    a WebM, a Matroska file and an MP4 (``vp09`` with its ``vpcC``)."""
    root = tmp_path_factory.mktemp("vp9")
    packets, pts = vp9_packets(moving_scene(12, 128, 96, seed=5),
                               {**BASE, "auto-alt-ref": 1, "lag-in-frames": 8}, two_pass=True)
    times = [p * 40 for p in pts]
    return {"clip.webm": write_mkv(str(root / "clip.webm"), packets, 128, 96, codec="V_VP9",
                                   times=times),
            "clip.mkv": write_mkv(str(root / "clip.mkv"), packets, 128, 96, codec="V_VP9",
                                  doc_type="matroska", times=times),
            "clip.mp4": write_mp4(str(root / "clip.mp4"), packets, 128, 96, kind=b"vp09")}


@pytest.fixture
def jax_reads_ffmpeg(monkeypatch):
    """JAX's sources read through cv2's default (FFmpeg) backend; its own
    FFmpeg-linked native source is off."""
    monkeypatch.setattr(jax_native, "available", lambda: False)


@pytest.mark.parametrize("name", ["clip.webm", "clip.mkv", "clip.mp4"])
def test_probe_and_frames_equal_jax(name, files, jax_reads_ffmpeg):
    path = files[name]
    assert probe_video(path) == jax_probe_video(path)
    got, want = list(iterate_frames(path, every=2)), list(jax_iterate_frames(path, every=2))
    assert [i for i, _ in got] == [i for i, _ in want] == list(range(0, 12, 2))
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", ["clip.webm", "clip.mp4"])
def test_native_batches_equal_frame_source_batches(name, files):
    port_t, _ = transforms()
    for every in (1, 3):
        native = list(NativeFrameSource(files[name], (SIZE, SIZE), every=every, normalize=False))
        thread = list(FrameSource(files[name], port_t, every=every))
        assert len(native) == len(thread) == len(range(0, 12, every))
        for g, w in zip(native, thread):
            assert g[0] == w[0]
            np.testing.assert_array_equal(g[2], w[2])
            np.testing.assert_array_equal(g[3], w[3])


@pytest.mark.parametrize("name", ["clip.webm", "clip.mp4"])
def test_stream_detect_video_equals_jax(name, files, tmp_path, jax_reads_ffmpeg):
    jax_infer, variables, infer = twin_models()
    port_t, jax_t = transforms()
    kw = dict(thresh=0.0, batch_size=4, every=2, draw=False, save_detections=True)
    path = files[name]
    stats = stream_detect_video(path, infer, port_t, CLASSES, output_dir=str(tmp_path / "port"),
                                device=CPU, **kw)
    want = jax_stream_detect_video(path, jax_infer, variables, jax_t, CLASSES,
                                   output_dir=str(tmp_path / "jax"), **kw)
    assert stats["frames"] == want["frames"] == 6
    assert assert_txt_equal(str(tmp_path / "port" / "clip_det.txt"),
                            str(tmp_path / "jax" / "clip_det.txt")) > 0


def test_stream_detect_videos_webm_and_mp4_equal_jax(files, tmp_path, jax_reads_ffmpeg):
    jax_infer, variables, infer = twin_models()
    port_t, jax_t = transforms()
    paths = [files["clip.webm"], files["clip.mp4"]]
    kw = dict(thresh=0.0, batch_size=4, k=1, draw=False, save_detections=True)
    stats = torch_multistream.stream_detect_videos(paths, infer, port_t, CLASSES,
                                                   output_dir=str(tmp_path / "port"),
                                                   device=CPU, **kw)
    want = jax_stream_detect_videos(paths, jax_infer, variables, jax_t, CLASSES,
                                    output_dir=str(tmp_path / "jax"), **kw)
    assert stats["per_stream"] == want["per_stream"]
    assert sum(stats["per_stream"].values()) == 24


def test_extract_frames_equals_jax(files, tmp_path, jax_reads_ffmpeg):
    port, jax_out = tmp_path / "port", tmp_path / "jax"
    for main, out in ((torch_extract.main, port), (jax_extract.main, jax_out)):
        main(["--input", files["clip.webm"], "--output", str(out), "--every", "3"])
    names = sorted(os.listdir(port))
    assert names == sorted(os.listdir(jax_out)) and len(names) == 4
    for f in names:
        assert (port / f).read_bytes() == (jax_out / f).read_bytes(), f


def test_detect_cli_mp4_equals_jax(files, tiny_weights, tmp_path, monkeypatch,  # noqa: F811
                                   jax_reads_ffmpeg):
    monkeypatch.setattr(jax_detect, "build_model",
                        functools.partial(jax_detect.build_model, policy=JAX_F32))
    monkeypatch.setattr(torch_detect, "build_model",
                        functools.partial(torch_detect.build_model, policy=FLOAT32_POLICY))
    monkeypatch.setenv("VIDDET_PAIR_TOPK", "det")
    jax.clear_caches()
    path = files["clip.mp4"]
    done = _cli(torch_detect.main, path, str(tmp_path / "port"), tiny_weights, "--no-draw")
    _cli(jax_detect.main, path, str(tmp_path / "jax"), tiny_weights, "--no-draw")
    assert done == 12
    assert os.listdir(tmp_path / "port") == ["clip_det.txt"]
    assert assert_txt_equal(str(tmp_path / "port" / "clip_det.txt"),
                            str(tmp_path / "jax" / "clip_det.txt")) > 0
