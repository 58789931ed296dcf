"""Quarter-sample MPEG-4 Part 2, the XviD IDCT and the encoder workarounds
libavcodec keys on user data and the fourcc, in the port's decoder
(``native/codec.cpp``, ``native.Mpeg4Decoder``) under every container
that carries MPEG-4, against FFmpeg as the opencv-python wheel bundles it,
on the CPU.

The streams come from the wheel's own libavcodec at test time
(``tests.fixtures.make_mp4_fixture.lavc_stream``): ``+qpel`` with ``bf``
0, 1 and 2, ``+mv4`` and MPEG quantisation, at 160x112 (whole
macroblocks) and 200x136 (partial ones, vectors past the edge).
``LavcStream.with_user_data`` replaces libavcodec's own user data (its
``Lavc`` version) with another encoder's.

* Quarter-sample streams: every frame's Y plane and RGB equal OpenCV's
  (``cv2.VideoCapture``, FFmpeg) bit for bit, in display order, with the
  frame count and fps, in AVI, MP4 and Matroska (``V_MPEG4/ISO/ASP`` and
  a VfW ``XVID`` track), user data in the stream or in the configuration.
* User data and fourcc: no user data under ``XVID`` (an early XviD),
  ``XviD0001`` / ``0010`` / ``0030`` / ``0050``, ``DivX501b1393``,
  ``DivX503b1393``, ``DivX503b2000`` and ``DivX400b1000``, in a
  half-sample and two quarter-sample streams, and libavcodec's early
  builds (``ffmpeg``, ``FFmpeg ... build: 4652``: its old quarter-sample
  luma): bit for bit OpenCV's, each with the IDCT and workarounds the
  decoder reports.  ``Lavc`` user data turns every workaround off.
* ``FF_BUG_DC_CLIP`` (XviD builds to 32, libavcodec's to 4712): a
  hand-written I-VOP whose DC predictor passes 2047 decodes as OpenCV's
  with the predictor clipped or not, as the user data says.
* Surfaces: ``NativeFrameSource`` equals ``FrameSource`` + ``ValTransform``
  on a quarter-sample XviD AVI, and ``stream_detect_video`` over it equals
  the JAX package's (which reads it through OpenCV).
"""

import os
import struct

import cv2
import numpy as np
import pytest

from tests.fixtures.make_mp4_fixture import lavc_stream, moving_scene, write_lavc_mp4
from tests.test_torch_avi_mpeg4 import jax_reads_ffmpeg  # noqa: F401  (a fixture)
from tests.test_torch_stream import twin_models
from tests.test_torch_video_stream import CLASSES, CPU, assert_txt_equal, transforms
from tests.torch_mkv_helpers import write_mkv
from tests.torch_mp4_helpers import BitWriter, cv2_views, vol_config, write_avi
from viddet_tpu.infer.stream import stream_detect_video as jax_stream_detect_video
from viddet_tpu_torch.data.transforms import ValTransform
from viddet_tpu_torch.infer.stream import FrameSource, NativeFrameSource, stream_detect_video
from viddet_tpu_torch.native import Mpeg4Decoder
from viddet_tpu_torch.utils.video import iterate_frames, open_video, probe_video

VOP = b"\x00\x00\x01\xb6"
STREAMS = {  # name: (width, height, libavcodec options)
    "half_200": (200, 136, {"bf": 2, "flags": "+mv4"}),
    "q_bf0_160": (160, 112, {"bf": 0, "flags": "+qpel"}),
    "q_bf1_mpeg_200": (200, 136, {"bf": 1, "flags": "+qpel", "mpeg_quant": 1}),
    "q_bf2_160": (160, 112, {"bf": 2, "flags": "+qpel+mv4"}),
    "q_bf2_200": (200, 136, {"bf": 2, "flags": "+qpel+mv4"}),
}


@pytest.fixture(scope="module")
def streams():
    return {name: lavc_stream(moving_scene(24, w, h, seed=2), options)
            for name, (w, h, options) in STREAMS.items()}


def write(path: str, stream, container: str, fourcc: bytes = b"XVID") -> str:
    """``stream`` in an AVI (``fourcc``), an MP4 (ctts and the shifted edit
    list), a ``V_MPEG4/ISO/ASP`` Matroska track or a VfW one (``fourcc``)."""
    if container == "avi":
        return write_avi(path, stream.packets, stream.width, stream.height, fourcc=fourcc)
    if container == "mp4":
        return write_lavc_mp4(path, stream)
    first = stream.packets[0]
    vop = first.find(VOP)
    times = [p * 40 for p in stream.pts]  # ms; the Duration is the last shown frame's end
    kw = dict(doc_type="matroska", times=times, duration=max(times) + 40)
    if container == "mkv":
        return write_mkv(path, [first[vop:]] + stream.packets[1:], stream.width, stream.height,
                         codec="V_MPEG4/ISO/ASP", private=first[:vop], **kw)
    bih = struct.pack("<IiiHH4sIiiII", 40, stream.width, stream.height, 1, 24, fourcc,
                      stream.width * stream.height * 3, 0, 0, 0, 0)
    return write_mkv(path, stream.packets, stream.width, stream.height,
                     codec="V_MS/VFW/FOURCC", private=bih, **kw)


def assert_equals_ffmpeg(path: str, count: int = 24) -> dict:
    """The port's Y planes (``Mpeg4Decoder`` on the reader's samples) and
    RGB frames (``iterate_frames``) of ``path``, its frame count and fps,
    equal OpenCV's (FFmpeg) bit for bit; returns what the decoder read of
    the stream."""
    with open_video(path) as reader:
        index = reader.index
        decoder = Mpeg4Decoder(index.config, path, index.fourcc)
        ys = []
        for i in range(len(index.offsets)):
            if decoder.decode(reader.sample(i), rgb=False):
                ys.append(decoder.planes()[0])
        if decoder.flush(rgb=False):
            ys.append(decoder.planes()[0])
    info = decoder.stream_info
    decoder.close()
    rgb = [f for _, f in iterate_frames(path)]
    want_y, want = cv2_views(path, "y"), cv2_views(path, "bgr")
    cap = cv2.VideoCapture(path, cv2.CAP_FFMPEG)
    probe = probe_video(path)
    assert len(ys) == len(rgb) == len(want_y) == len(want) == count
    assert probe["frame_count"] == cap.get(cv2.CAP_PROP_FRAME_COUNT) == count
    assert probe["fps"] == cap.get(cv2.CAP_PROP_FPS) == 25
    cap.release()
    for i, (y, f, wy, w) in enumerate(zip(ys, rgb, want_y, want)):
        np.testing.assert_array_equal(y, wy.reshape(y.shape), err_msg=f"{path} Y {i}")
        np.testing.assert_array_equal(f, w[..., ::-1], err_msg=f"{path} RGB {i}")
    return info


@pytest.mark.parametrize("name,container,user_data", [
    ("q_bf0_160", "avi", None), ("q_bf0_160", "mkv", None),
    ("q_bf1_mpeg_200", "avi", None), ("q_bf1_mpeg_200", "mp4", None),
    ("q_bf2_160", "mp4", None), ("q_bf2_160", "vfw", b""),
    ("q_bf2_200", "avi", None), ("q_bf2_200", "mkv", b"XviD0001"),
    ("q_bf2_200", "mp4", b"DivX503b1393"),
])
def test_quarter_sample_equals_ffmpeg(name, container, user_data, streams, tmp_path):
    """``user_data`` None keeps libavcodec's own; in MP4 and Matroska's
    ``V_MPEG4/ISO/ASP`` the replacement lies in the decoder configuration;
    the VfW track without user data is an early XviD by its fourcc."""
    stream = streams[name]
    if user_data is not None:
        stream = stream.with_user_data(user_data)
    ext = {"vfw": "mkv"}.get(container, container)
    info = assert_equals_ffmpeg(write(str(tmp_path / f"q.{ext}"), stream, container))
    assert info["quarter_sample"]
    if user_data is None:
        assert info["lavc_build"] is not None and not info["workarounds"]
    if container == "vfw":
        assert info["xvid_build"] == 0 and info["idct"] == "xvid"


# user data (None: none at all) and fourcc -> the IDCT and the workarounds
# the decoder reports after the stream (half-sample, quarter-sample)
ENCODERS = {
    "none_XVID": (None, b"XVID", "xvid", ["edge", "dc_clip", "qpel_chroma"]),
    "XviD0001": (b"XviD0001", b"XVID", "xvid", ["edge", "dc_clip", "qpel_chroma"]),
    "XviD0010": (b"XviD0010", b"XVID", "xvid", ["edge", "dc_clip"]),
    "XviD0030": (b"XviD0030", b"XVID", "xvid", ["dc_clip"]),
    "XviD0050": (b"XviD0050", b"XVID", "xvid", []),
    "DivX501b1393": (b"DivX501b1393", b"DIVX", "simple", ["qpel_chroma"]),
    "DivX503b1393": (b"DivX503b1393", b"DIVX", "simple", ["qpel_chroma", "qpel_chroma2"]),
    "DivX503b2000": (b"DivX503b2000", b"DIVX", "simple", []),
    "DivX400b1000": (b"DivX400b1000", b"DIVX", "simple", ["edge"]),
}


@pytest.mark.parametrize("encoder", list(ENCODERS))
@pytest.mark.parametrize("name", ["half_200", "q_bf2_160", "q_bf2_200"])
def test_user_data_and_fourcc_equal_ffmpeg(name, encoder, streams, tmp_path):
    user_data, fourcc, idct, workarounds = ENCODERS[encoder]
    stream = streams[name].with_user_data(user_data or b"")
    info = assert_equals_ffmpeg(write(str(tmp_path / "e.avi"), stream, "avi", fourcc))
    assert info["idct"] == idct and info["workarounds"] == workarounds, info
    assert info["quarter_sample"] == name.startswith("q_")


@pytest.mark.parametrize("user_data,fourcc,lavc_build", [
    (b"ffmpeg", b"FMP4", 4600),
    (b"FFmpeg v0.4.9 / libavcodec build: 4652", b"FMP4", 4652),
    (b"FFmpegv0.4.9b4660", b"DX50", 4660),
    (b"", b"xvid", None),  # the fourcc is read in upper case
])
def test_early_libavcodec_and_fourcc_case_equal_ffmpeg(user_data, fourcc, lavc_build, streams,
                                                       tmp_path):
    """libavcodec's own early builds: before 4653 its old quarter-sample
    luma forms (FF_BUG_STD_QPEL), before 4670 the picture's own edge;
    a lower-case ``xvid`` fourcc is XviD's."""
    stream = streams["q_bf2_200"].with_user_data(user_data)
    info = assert_equals_ffmpeg(write(str(tmp_path / "l.avi"), stream, "avi", fourcc))
    assert info["lavc_build"] == lavc_build
    if lavc_build is None:
        assert info["xvid_build"] == 0
    else:
        assert ("std_qpel" in info["workarounds"]) == (lavc_build < 4653)
        assert "edge" in info["workarounds"]


def test_lavc_user_data_turns_every_workaround_off(streams, tmp_path):
    """``Lavc`` user data under an ``XVID`` or ``DIVX`` fourcc: no XviD
    IDCT and no workaround, so the frames are those of the same stream
    under ``FMP4`` with no user data at all, and OpenCV's; the ``XVID``
    fourcc alone gives other frames."""
    stream = streams["q_bf2_200"]
    lavc = stream.with_user_data(b"Lavc62.28.100")
    plain = [f for _, f in iterate_frames(write(str(tmp_path / "p.avi"),
                                                stream.with_user_data(), "avi", b"FMP4"))]
    for fourcc in (b"XVID", b"DIVX"):
        path = write(str(tmp_path / f"lavc_{fourcc.decode()}.avi"), lavc, "avi", fourcc)
        info = assert_equals_ffmpeg(path)
        assert info["lavc_build"] == (62 << 16) + (28 << 8) + 100
        assert info["xvid_build"] is None and info["divx_version"] is None
        assert info["idct"] == "simple" and info["workarounds"] == []
        for a, (_, b) in zip(plain, iterate_frames(path)):
            np.testing.assert_array_equal(a, b)
    xvid = [f for _, f in iterate_frames(write(str(tmp_path / "x.avi"), stream.with_user_data(),
                                               "avi", b"XVID"))]
    assert any(not np.array_equal(a, b) for a, b in zip(plain, xvid))


# 14496-2 Tables B-13 / B-14: dct_dc_size_luminance / _chrominance (code, length)
DC_LUM = [(3, 3), (3, 2), (2, 2), (2, 3), (1, 3), (1, 4), (1, 5), (1, 6), (1, 7), (1, 8), (1, 9)]
DC_CHROM = [(3, 2), (2, 2), (1, 2), (1, 3), (1, 4), (1, 5), (1, 6), (1, 7), (1, 8), (1, 9)]


def dc_only_ivop(diffs, qscale: int, increment: int) -> bytes:
    """An I-VOP (25 ticks a second) whose macroblocks carry only their six
    DC differences ``diffs`` (intra DC VLC at every quantiser, no AC)."""
    b = BitWriter().put(0, 2).put(0, 1).put(1, 1).put(increment, 5).put(1, 1).put(1, 1)
    b.put(0, 3).put(qscale, 5)  # intra_dc_vlc_thr 0, vop_quant
    for mb in diffs:
        b.put(1, 1).put(0, 1).put(3, 4)  # mcbpc: intra, cbpc 0; no AC prediction; cbpy 0
        for n, d in enumerate(mb):
            size = abs(d).bit_length()
            b.put(*(DC_LUM if n < 4 else DC_CHROM)[size])
            if size:
                b.put(d if d > 0 else d + (1 << size) - 1, size)
    return VOP + b.stuffed()


@pytest.mark.parametrize("user_data,clipped", [
    (b"XviD0032", False), (b"XviD0033", True),
    (b"FFmpeg v0.4.9 / libavcodec build: 4712", False),
    (b"FFmpeg v0.4.9 / libavcodec build: 4713", True), (b"Lavc62.28.100", True),
])
def test_dc_predictor_clip_follows_the_encoder(user_data, clipped, tmp_path):
    """The first block's DC is 258 (2064 at scale 8), past the 2047 that
    libavcodec clips its stored predictor to unless FF_BUG_DC_CLIP: the
    blocks predicted from it differ by 2 levels (158 or 156)."""
    w, h = 64, 32
    diffs = [[130, 0, 0, 0, 0, 0]] + [[-100 if i % 2 == 0 else 100, 0, 0, 0, 0, 0]
                                      for i in range(7)]
    config = vol_config(w, h) + b"\x00\x00\x01\xb2" + user_data
    path = write_avi(str(tmp_path / "dc.avi"), [config + dc_only_ivop(diffs, 4, 0),
                                                 dc_only_ivop(diffs, 4, 1)], w, h,
                     fourcc=b"FMP4")
    decoder = Mpeg4Decoder(config, path, "FMP4")
    want = cv2_views(path, "y")
    assert len(want) == 2
    for sample, y in zip((config + dc_only_ivop(diffs, 4, 0), dc_only_ivop(diffs, 4, 1)), want):
        assert decoder.decode(sample, rgb=False)
        ours = decoder.planes()[0]
        np.testing.assert_array_equal(ours, y.reshape(ours.shape))
        assert ours[0, 16] == (156 if clipped else 158)
    assert ("dc_clip" in decoder.stream_info["workarounds"]) != clipped


@pytest.fixture(scope="module")
def qpel_xvid(streams, tmp_path_factory):
    """A quarter-sample XviD AVI (``XviD0001``: the XviD IDCT, its edge and
    quarter-sample chroma) at 200x136."""
    path = str(tmp_path_factory.mktemp("qpel_xvid") / "qpel.avi")
    return write(path, streams["q_bf2_200"].with_user_data(b"XviD0001"), "avi")


def test_native_source_equals_frame_source(qpel_xvid):
    for every in (1, 3):
        thread = FrameSource(qpel_xvid, ValTransform((48, 64), letterbox_resize=True),
                             every=every)
        native = NativeFrameSource(qpel_xvid, (48, 64), every=every, letterbox_resize=True,
                                   queue_size=4)
        got, want = list(native), list(thread)
        assert [g[0] for g in got] == [w[0] for w in want] == list(range(0, 24, every))
        for (_, _, x, affine), (_, _, wx, waffine) in zip(got, want):
            np.testing.assert_array_equal(x, wx)
            np.testing.assert_array_equal(affine, waffine)


def test_stream_detect_video_equals_jax(qpel_xvid, tmp_path, jax_reads_ffmpeg):  # noqa: F811
    jax_infer, variables, infer = twin_models()
    port_t, jax_t = transforms()
    kw = dict(thresh=0.0, batch_size=4, every=2, draw=False, save_detections=True)
    stats = stream_detect_video(qpel_xvid, infer, port_t, CLASSES,
                                output_dir=str(tmp_path / "port"), device=CPU, **kw)
    want = jax_stream_detect_video(qpel_xvid, jax_infer, variables, jax_t, CLASSES,
                                   output_dir=str(tmp_path / "jax"), **kw)
    assert stats["frames"] == want["frames"] == 12
    stem = os.path.splitext(os.path.basename(qpel_xvid))[0]
    assert assert_txt_equal(str(tmp_path / "port" / f"{stem}_det.txt"),
                            str(tmp_path / "jax" / f"{stem}_det.txt")) > 0
