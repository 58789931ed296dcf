"""MPEG-4 Part 2 in AVI (``native/avi.py`` with the port's MPEG-4 decoder)
and the video surfaces over B-VOP streams, against OpenCV and the JAX
package on the CPU.

* OpenCV's own ``XVID``, ``FMP4`` and ``DIVX`` AVIs (``cv2.VideoWriter``
  through FFmpeg; no extradata, the VOL at the head of the first chunk),
  and B-VOP AVIs of the wheel's libavcodec (``bf`` 1 and 2, the
  configuration in the ``strf`` extradata or in the first chunk): every
  frame's Y plane and RGB equal OpenCV's (FFmpeg) bit for bit, with its
  frame count and fps.
* Packed B-frames (a P-VOP and a B-VOP in one chunk, then a non-coded
  placeholder) with DivX's ``DivX503b1393p`` user data: OpenCV's FFmpeg
  unpacks them, and the port's frames equal OpenCV's read of the same
  file.  Without that user data this FFmpeg build does not unpack them
  (it reads 13 of 24 frames); the port unpacks every such chunk as
  ``mpeg4_unpack_bframes`` does and equals OpenCV's read of the unpacked
  file (ROADMAP Queue 3).
* XviD's user data (``XviD0050``), or an ``XVID`` fourcc with no user
  data, makes FFmpeg switch to its XviD IDCT, and the port with it: every
  frame equals OpenCV's bit for bit (the other encoders' user data and
  quarter-sample streams: test_torch_mpeg4_xvid.py).
* ``NativeFrameSource`` equals ``FrameSource`` + ``ValTransform`` bit for
  bit at ``every`` 1, 2 and 3; an AVI of another codec and a stream that
  does not start with an I-VOP raise ValueError naming them before any
  frame is decoded.
* Surfaces against JAX (tiny float32 YOLOv3 at 64 px; JAX reads through
  cv2's FFmpeg backend, unpatched, its native source off):
  ``stream_detect_video`` drawn and not over a B-VOP AVI and MP4,
  ``stream_detect_videos`` over both in one batch, ``detect --input``
  over the AVI and ``extract_frames`` over both equal JAX's at the golden
  tolerances (the extracted JPEGs byte for byte); ``visualise --images
  --video`` over the extracted frames writes each one back.
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
import viddet_tpu_torch.cli.visualise as torch_visualise
import viddet_tpu_torch.infer.multistream as torch_multistream
from tests.fixtures.make_mp4_fixture import (
    lavc_stream, moving_scene, write_lavc_avi, write_lavc_mp4,
)
from tests.test_torch_mp4 import tiny_weights  # noqa: F401  (a fixture)
from tests.test_torch_stream import twin_models
from tests.test_torch_video_stream import CLASSES, CPU, _cli, assert_txt_equal, transforms
from tests.torch_mp4_helpers import cv2_views, write_avi
from tests.torch_video_helpers import assert_drawn_video
from viddet_tpu.core.precision import FLOAT32_POLICY as JAX_F32
from viddet_tpu.infer.multistream import stream_detect_videos as jax_stream_detect_videos
from viddet_tpu.infer.stream import stream_detect_video as jax_stream_detect_video
from viddet_tpu_torch.core.precision import FLOAT32_POLICY
from viddet_tpu_torch.data.transforms import ValTransform
from viddet_tpu_torch.infer.stream import FrameSource, NativeFrameSource, stream_detect_video
from viddet_tpu_torch.native import Mpeg4Decoder, decode_jpeg, encode_jpeg
from viddet_tpu_torch.native.avi import AviReader, read_index
from viddet_tpu_torch.utils.video import iterate_frames, probe_video

W, H = 160, 112


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("avi_mpeg4")
    out = {}
    for fourcc in ("XVID", "FMP4", "DIVX"):
        path = str(d / f"cv2_{fourcc}.avi")
        writer = cv2.VideoWriter(path, cv2.CAP_FFMPEG, cv2.VideoWriter_fourcc(*fourcc), 25.0,
                                 (W, H))
        assert writer.isOpened()
        for f in moving_scene(12, W, H, seed=3):
            writer.write(f)
        writer.release()
        out[fourcc] = path
    bf1 = lavc_stream(moving_scene(24, W, H, seed=2), {"bf": 1})
    bf2 = lavc_stream(moving_scene(20, W, H, seed=5), {"bf": 2, "flags": "+mv4"})
    out["bf1"] = write_lavc_avi(str(d / "bf1.avi"), bf1)
    out["bf2"] = write_lavc_avi(str(d / "bf2.avi"), bf2, b"DX50")
    first = bf2.packets[0]
    vop = first.find(b"\x00\x00\x01\xb6")  # the headers move to the strf extradata
    out["extradata"] = write_avi(str(d / "extradata.avi"), [first[vop:]] + bf2.packets[1:], W,
                                 H, fourcc=b"FMP4", extradata=first[:vop])
    out["packed_divx"] = write_lavc_avi(str(d / "packed_divx.avi"), bf1, packed=True,
                                        user_data=b"DivX503b1393p")
    out["packed"] = write_lavc_avi(str(d / "packed.avi"), bf1, b"DIVX", packed=True)
    out["xvid_user_data"] = write_lavc_avi(str(d / "xvid_ud.avi"), bf1, user_data=b"XviD0050")
    first = bf1.packets[0]  # without libavcodec's own user data (the Lavc version)
    start = first.find(b"\x00\x00\x01\xb2")
    plain = first[:start] + first[first.find(b"\x00\x00\x01", start + 4):]
    out["xvid_fourcc_alone"] = write_avi(str(d / "xvid_alone.avi"), [plain] + bf1.packets[1:],
                                         W, H, fourcc=b"XVID")
    out["bf2.mp4"] = write_lavc_mp4(str(d / "clip.mp4"), bf2)
    return out


def assert_frames_equal(path: str, want_path: str) -> None:
    """The port's Y planes and RGB frames of ``path``, with its frame count
    and fps, equal OpenCV's (FFmpeg) of ``want_path``."""
    reader = AviReader(path)
    decoder = Mpeg4Decoder(reader.index.config, path, reader.index.fourcc)
    ys = []
    for i in range(len(reader)):
        if decoder.decode(reader.sample(i), rgb=False):
            ys.append(decoder.planes()[0])
    if decoder.flush(rgb=False):
        ys.append(decoder.planes()[0])
    rgb = [f for _, f in iterate_frames(path)]
    want_y, want = cv2_views(want_path, "y"), cv2_views(want_path, "bgr")
    cap = cv2.VideoCapture(want_path, cv2.CAP_FFMPEG)
    probe = probe_video(path)
    assert len(ys) == len(rgb) == len(want_y) == len(want) == probe["frame_count"] == \
        cap.get(cv2.CAP_PROP_FRAME_COUNT)
    assert probe["fps"] == cap.get(cv2.CAP_PROP_FPS) == 25
    cap.release()
    for i, (y, f, wy, w) in enumerate(zip(ys, rgb, want_y, want)):
        np.testing.assert_array_equal(y, wy.reshape(y.shape), err_msg=f"{path} Y {i}")
        np.testing.assert_array_equal(f, w[..., ::-1], err_msg=f"{path} RGB {i}")


@pytest.mark.parametrize("name", ["XVID", "FMP4", "DIVX", "bf1", "bf2", "extradata",
                                  "packed_divx"])
def test_frames_equal_ffmpeg(name, files):
    index = read_index(files[name])
    assert index.codec == "mpeg4" and (index.width, index.height) == (W, H)
    assert_frames_equal(files[name], files[name])


def test_packed_b_frames_unpack_where_ffmpeg_reads_them_packed(files):
    """Without DivX's user data this FFmpeg build decodes each packed chunk's
    first VOP only and shows nothing for the placeholders; the port unpacks
    the chunks and equals OpenCV's read of the unpacked file."""
    assert len(cv2_views(files["packed"], "bgr")) == 13
    assert read_index(files["packed"]).frame_count == read_index(files["bf1"]).frame_count == 24
    assert_frames_equal(files["packed"], files["bf1"])


@pytest.mark.parametrize("case", ["xvid_user_data", "xvid_fourcc_alone"])
def test_xvid_streams_take_the_xvid_idct(case, files):
    """FFmpeg decodes a stream whose user data names XviD, or an ``XVID``
    stream with no user data at all, with its XviD IDCT, and so does the
    port: every frame equals OpenCV's bit for bit, and differs from the
    same stream read as libavcodec's own (its simple IDCT)."""
    assert_frames_equal(files[case], files[case])
    ours = [f for _, f in iterate_frames(files[case])]
    lavc = [f for _, f in iterate_frames(files["bf1"])]
    assert len(ours) == len(lavc) == 24
    assert any(not np.array_equal(a, b) for a, b in zip(ours, lavc))


@pytest.mark.parametrize("name", ["XVID", "bf2"])
def test_native_source_equals_frame_source(name, files):
    path = files[name]
    n = read_index(path).frame_count
    for every in (1, 2, 3):
        thread = FrameSource(path, ValTransform((48, 64), letterbox_resize=True), every=every)
        native = NativeFrameSource(path, (48, 64), every=every, letterbox_resize=True,
                                   queue_size=4)
        got, want = list(native), list(thread)
        assert [g[0] for g in got] == [w[0] for w in want] == list(range(0, n, every))
        for (_, _, x, affine), (_, _, wx, waffine) in zip(got, want):
            np.testing.assert_array_equal(x, wx)
            np.testing.assert_array_equal(affine, waffine)


def test_refused_streams_raise_before_any_frame(files, tmp_path):
    stream = lavc_stream(moving_scene(6, 96, 64, seed=1), {"bf": 1})
    cases = [
        (write_avi(str(tmp_path / "p.avi"), [stream.packets[0][:stream.packets[0].find(
            b"\x00\x00\x01\xb6")] + stream.packets[1]] + stream.packets[2:], 96, 64),
         "frame 0 .*P-VOP.*does not start with an I-VOP"),
    ]
    for path, named in cases:
        for fn in (probe_video, lambda p: next(iterate_frames(p)),
                   lambda p: NativeFrameSource(p, (32, 32)),
                   lambda p: FrameSource(p, ValTransform((32, 32)))):
            with pytest.raises(ValueError, match=named):
                fn(path)


# --------------------------------------------------------------- surfaces


@pytest.fixture
def jax_reads_ffmpeg(monkeypatch):
    """JAX reads through cv2's default (FFmpeg) backend, unpatched; its
    native (FFmpeg-linked) source is off."""
    monkeypatch.setattr(jax_native, "available", lambda: False)


@pytest.mark.parametrize("name,draw", [("bf2", False), ("bf2", True), ("bf2.mp4", False)])
def test_stream_detect_video_equals_jax(name, draw, files, tmp_path, jax_reads_ffmpeg):
    jax_infer, variables, infer = twin_models()
    port_t, jax_t = transforms()
    kw = dict(thresh=0.0, batch_size=4, every=2, draw=draw, save_detections=True)
    path = files[name]
    stem = os.path.splitext(os.path.basename(path))[0]
    stats = stream_detect_video(path, infer, port_t, CLASSES, output_dir=str(tmp_path / "port"),
                                device=CPU, **kw)
    want = jax_stream_detect_video(path, jax_infer, variables, jax_t, CLASSES,
                                   output_dir=str(tmp_path / "jax"), **kw)
    assert stats["frames"] == want["frames"] == 10
    assert assert_txt_equal(str(tmp_path / "port" / f"{stem}_det.txt"),
                            str(tmp_path / "jax" / f"{stem}_det.txt")) > 0


def test_stream_detect_videos_equals_jax(files, tmp_path, jax_reads_ffmpeg):
    jax_infer, variables, infer = twin_models()
    port_t, jax_t = transforms()
    paths = [files["bf2"], files["bf2.mp4"]]
    kw = dict(thresh=0.0, batch_size=4, k=1, draw=False, save_detections=True)
    stats = torch_multistream.stream_detect_videos(paths, infer, port_t, CLASSES,
                                                   output_dir=str(tmp_path / "port"),
                                                   device=CPU, **kw)
    want = jax_stream_detect_videos(paths, jax_infer, variables, jax_t, CLASSES,
                                    output_dir=str(tmp_path / "jax"), **kw)
    assert stats["per_stream"] == want["per_stream"] == {"bf2.avi": 20, "clip.mp4": 20}
    for stem in ("bf2", "clip"):
        assert assert_txt_equal(str(tmp_path / "port" / f"{stem}_det.txt"),
                                str(tmp_path / "jax" / f"{stem}_det.txt")) > 0


def test_detect_cli_equals_jax(files, tiny_weights, tmp_path, monkeypatch,  # noqa: F811
                               jax_reads_ffmpeg):
    monkeypatch.setattr(jax_detect, "build_model",
                        functools.partial(jax_detect.build_model, policy=JAX_F32))
    monkeypatch.setattr(torch_detect, "build_model",
                        functools.partial(torch_detect.build_model, policy=FLOAT32_POLICY))
    monkeypatch.setenv("VIDDET_PAIR_TOPK", "det")
    jax.clear_caches()
    done = _cli(torch_detect.main, files["bf2"], str(tmp_path / "port"), tiny_weights,
                "--no-draw")
    _cli(jax_detect.main, files["bf2"], str(tmp_path / "jax"), tiny_weights, "--no-draw")
    assert done == 20
    assert assert_txt_equal(str(tmp_path / "port" / "bf2_det.txt"),
                            str(tmp_path / "jax" / "bf2_det.txt")) > 0


@pytest.mark.parametrize("name", ["bf2", "bf2.mp4"])
def test_extract_frames_equals_jax(name, files, tmp_path, jax_reads_ffmpeg):
    port, jax_out = tmp_path / "port", tmp_path / "jax"
    for main, out in ((torch_extract.main, port), (jax_extract.main, jax_out)):
        main(["--input", files[name], "--output", str(out), "--every", "3"])
    names = sorted(os.listdir(port))
    assert names == sorted(os.listdir(jax_out)) and len(names) == 7
    for f in names:
        assert (port / f).read_bytes() == (jax_out / f).read_bytes(), (name, f)


def test_visualise_writes_back_extracted_frames(files, tmp_path):
    """``extract_frames`` over the B-VOP AVI, then ``visualise --images
    --video`` over its frames: the video holds each frame, in order, as the
    MPEG-4 Part 2 a fresh ``VideoWriter`` writes from the images read back
    (the frames at q 95), which cv2 decodes as the port does."""
    frames = tmp_path / "frames"
    assert torch_extract.main(["--input", files["bf2"], "--output", str(frames)]) == 20
    out = tmp_path / "vis"
    assert torch_visualise.main(["--images", str(frames), "--output", str(out), "--video",
                                 "v.avi", "--fps", "25"]) == 20
    decoded = [f for _, f in iterate_frames(files["bf2"])]
    images = []
    with AviReader(str(out / "v.avi")) as video:
        assert len(video) == 20 and video.index.codec == "mpeg4"
        for i in range(20):
            jpeg = decode_jpeg((frames / f"{i:08d}.jpg").read_bytes())
            np.testing.assert_array_equal(jpeg, decode_jpeg(encode_jpeg(decoded[i], 95)))
            images.append(jpeg)
    assert_drawn_video(str(out / "v.avi"), images, 25)
