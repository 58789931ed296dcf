"""The port's Motion-JPEG AVI reader and writer (``native/avi.py``), its video
helpers (``utils/video.py``) and its two frame sources (``infer/stream.py``)
on the CPU.

* Files written by OpenCV's built-in MJPEG writer, by FFmpeg through cv2
  and by the port read back frame for frame equal, bit for bit, to
  ``cv2.VideoCapture(path, cv2.CAP_OPENCV_MJPEG)`` and to ``cv2.imdecode``
  of each frame's bytes (not to cv2's default FFmpeg backend, whose own
  IDCT and colour conversion differ by many grey levels:
  ``test_default_cv2_backend_is_not_the_reference``).
* The port's files, OpenDML ``AVIX`` segments included (the segment limit
  lowered to a few KB), open in both cv2 backends with the frame count,
  size and fps (relative 1e-3) they were written with.
* A truncated file reads to its last whole frame; an ``.avi`` of another
  codec (HuffYUV), a CABAC H.264 ``.mp4`` and ``.mkv``, a ``.webm`` of VP9
  profile 1 and a webcam index raise ValueError naming what is missing (MPEG-4 Part 2 AVIs read:
  ``tests/test_torch_avi_mpeg4.py``).  ``VideoWriter`` writes MPEG-4 Part 2
  into ``.avi`` and ``.mp4`` at OpenCV's rate, refuses ``.mkv`` and
  ``.webm`` (``tests/test_torch_video_out.py``).
* ``NativeFrameSource`` (C++ thread) equals ``FrameSource`` +
  ``ValTransform`` bit for bit, letterboxed and plain, uint8 and
  normalized, every 1 and 3; ``close()`` ends a blocked consumer; a corrupt
  frame raises in the consumer after the frames before it.
"""

import os
import struct
import time

import cv2
import numpy as np
import pytest

from tests.torch_mkv_helpers import h264_cabac_mkv, vp9_mkv
from tests.torch_mp4_helpers import h264_mp4
from viddet_tpu_torch.data.transforms import ValTransform
from viddet_tpu_torch.infer.stream import FrameSource, NativeFrameSource
from viddet_tpu_torch.native import decode_jpeg, encode_jpeg, frame_transform
from viddet_tpu_torch.native.avi import AviReader, AviWriter, read_index
from viddet_tpu_torch.utils.video import (
    VideoWriter, extract_frames, iterate_frames, probe_video,
)

WRITERS = ("opencv", "ffmpeg", "port")


def photo_frames(n: int, h: int = 48, w: int = 64, seed: int = 0):
    """Seeded RGB frames that compress like photographs (blurred noise),
    a moving bright square in each."""
    rng = np.random.default_rng(seed)
    out = []
    for t in range(n):
        f = cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3)).astype(np.uint8), (5, 5), 0)
        x = (3 * t) % max(w - 12, 1)
        f[h // 4 : h // 4 + 12, x : x + 12] = (250, 40, 40)
        out.append(f)
    return out


def write_video(path: str, frames, fps=10, writer: str = "opencv", **kw) -> str:
    """RGB frames -> an MJPEG AVI by ``writer``: OpenCV's built-in MJPEG
    writer, FFmpeg through cv2, or the port's ``AviWriter``."""
    h, w = frames[0].shape[:2]
    if writer == "port":
        with AviWriter(path, w, h, fps, **kw) as vw:
            for f in frames:
                vw.write(f)
        return path
    api = cv2.CAP_OPENCV_MJPEG if writer == "opencv" else cv2.CAP_FFMPEG
    vw = cv2.VideoWriter(path, api, cv2.VideoWriter_fourcc(*"MJPG"), float(fps), (w, h))
    assert vw.isOpened()
    for f in frames:
        vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    vw.release()
    return path


def cv2_frames(path: str, api=cv2.CAP_OPENCV_MJPEG):
    """RGB frames as cv2.VideoCapture(path, api) reads them, and the capture's
    (frame count, width, height, fps)."""
    cap = cv2.VideoCapture(path, api)
    assert cap.isOpened()
    props = (cap.get(cv2.CAP_PROP_FRAME_COUNT), cap.get(cv2.CAP_PROP_FRAME_WIDTH),
             cap.get(cv2.CAP_PROP_FRAME_HEIGHT), cap.get(cv2.CAP_PROP_FPS))
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(f, cv2.COLOR_BGR2RGB))
    cap.release()
    return frames, props


@pytest.mark.parametrize("writer", WRITERS)
@pytest.mark.parametrize("size", [(48, 64), (120, 160)])
def test_reader_frames_equal_cv2_mjpeg_and_imdecode(writer, size, tmp_path):
    frames = photo_frames(12, *size, seed=size[0])
    path = write_video(str(tmp_path / "v.avi"), frames, 25, writer)
    want, (count, w, h, fps) = cv2_frames(path)
    got = [f for _, f in iterate_frames(path)]
    assert len(got) == len(want) == count == 12
    info = probe_video(path)
    assert (info["frame_count"], info["width"], info["height"]) == (12, size[1], size[0])
    assert info["fps"] == pytest.approx(fps, rel=1e-3) and info["fps"] == pytest.approx(25)
    with AviReader(path) as video:
        for i, (g, w_) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(g, w_, err_msg=f"frame {i}")
            raw = cv2.imdecode(np.frombuffer(video.sample(i), np.uint8), cv2.IMREAD_COLOR)
            np.testing.assert_array_equal(g, raw[..., ::-1], err_msg=f"frame {i}")
    bgr = [f for _, f in iterate_frames(path, every=5, rgb=False)]
    assert len(bgr) == 3
    np.testing.assert_array_equal(bgr[1], want[5][..., ::-1])


@pytest.mark.parametrize("segment_bytes", [None, 6000])
@pytest.mark.parametrize("fps", [25, 30000 / 1001, 12.5])
def test_port_files_open_in_both_cv2_backends(segment_bytes, fps, tmp_path):
    frames = photo_frames(23, 60, 80, seed=3)
    kw = {} if segment_bytes is None else {"segment_bytes": segment_bytes}
    path = write_video(str(tmp_path / "p.avi"), frames, fps, "port", **kw)
    riffs = _riff_kinds(path)
    assert riffs[0] == b"AVI " and (len(riffs) > 3 if segment_bytes else len(riffs) == 1)
    assert all(k == b"AVIX" for k in riffs[1:])
    want = [decode_jpeg(encode_jpeg(f, 95)) for f in frames]
    for api in (cv2.CAP_OPENCV_MJPEG, cv2.CAP_FFMPEG):
        read, (count, w, h, got_fps) = cv2_frames(path, api)
        assert (count, w, h) == (23, 80, 60) and len(read) == 23, api
        assert got_fps == pytest.approx(fps, rel=1e-3), api
        if api == cv2.CAP_OPENCV_MJPEG:
            for g, w_ in zip(read, want):
                np.testing.assert_array_equal(g, w_)
    index = read_index(path)
    assert index.frame_count == 23 and not index.truncated
    assert index.fps == pytest.approx(fps, rel=1e-9)
    for (_, g), w_ in zip(iterate_frames(path), want):
        np.testing.assert_array_equal(g, w_)


def _riff_kinds(path):
    data = open(path, "rb").read()
    kinds, pos = [], 0
    while pos + 12 <= len(data):
        cid, size, kind = struct.unpack_from("<4sI4s", data, pos)
        assert cid == b"RIFF"
        kinds.append(kind)
        pos += 8 + size + (size & 1)
    return kinds


def test_opendml_indexes_point_at_the_frames(tmp_path):
    """The super index lists every segment's ix00, and each ix00 entry is a
    frame's data offset and size."""
    frames = photo_frames(17, seed=5)
    path = write_video(str(tmp_path / "o.avi"), frames, 10, "port", segment_bytes=5000)
    data = open(path, "rb").read()
    index = read_index(path)
    at = data.index(b"indx")
    _, _, _, _, entries, chunk_id = struct.unpack_from("<IHBBI4s", data, at + 4)
    assert chunk_id == b"00dc" and entries == len(_riff_kinds(path))
    listed = []
    for e in range(entries):
        ix, size, duration = struct.unpack_from("<QII", data, at + 32 + 16 * e)
        assert data[ix : ix + 4] == b"ix00"
        n = struct.unpack_from("<I", data, ix + 12)[0]
        base = struct.unpack_from("<Q", data, ix + 20)[0]
        assert n == duration and size == 32 + 8 * n
        pairs = struct.unpack_from(f"<{2 * n}I", data, ix + 32)
        listed += [(base + o, s) for o, s in zip(pairs[0::2], pairs[1::2])]
    assert listed == list(zip(index.offsets.tolist(), index.sizes.tolist()))


@pytest.mark.parametrize("writer", ["opencv", "port"])
def test_truncated_file_reads_to_its_last_whole_frame(writer, tmp_path):
    frames = photo_frames(10, seed=7)
    path = write_video(str(tmp_path / "t.avi"), frames, 10, writer)
    index = read_index(path)
    cut = int(index.offsets[7]) + int(index.sizes[7]) // 2  # inside frame 7's data
    short = str(tmp_path / "short.avi")
    with open(path, "rb") as src, open(short, "wb") as dst:
        dst.write(src.read(cut))
    got = read_index(short)
    assert got.frame_count == 7 and got.truncated
    for (_, g), (_, w) in zip(iterate_frames(short), iterate_frames(path)):
        np.testing.assert_array_equal(g, w)


def test_unclosed_port_file_reads_every_written_frame(tmp_path):
    """A writer that never reached close() (a crash) left every size 0."""
    frames = photo_frames(6, seed=9)
    path = str(tmp_path / "crash.avi")
    w = AviWriter(path, 64, 48, 10)
    for f in frames:
        w.write(f)
    w._f.flush()
    index = read_index(path)
    assert index.frame_count == 6 and index.fps == 10
    for (_, g), f in zip(iterate_frames(path), frames):
        np.testing.assert_array_equal(g, decode_jpeg(encode_jpeg(f, 95)))
    w.close()


def test_non_jpeg_avi_raises_naming_the_fourcc_and_ffmpeg(tmp_path):
    """An AVI whose video is none of Motion-JPEG, MPEG-4 Part 2 and H.264
    (here the port's own file with its fourcc set to HFYU, HuffYUV) raises
    naming the fourcc; cv2's XVID files read
    (``tests/test_torch_avi_mpeg4.py``), H.264 ones too
    (``tests/test_torch_h264.py``)."""
    path = write_video(str(tmp_path / "x.avi"), photo_frames(3), 10.0, "port")
    data = open(path, "rb").read().replace(b"MJPG", b"HFYU")
    open(path, "wb").write(data)
    for fn in (probe_video, lambda p: FrameSource(p, ValTransform((32, 32))),
               lambda p: NativeFrameSource(p, (32, 32))):
        with pytest.raises(ValueError,
                           match="'HFYU', not Motion-JPEG, MPEG-4 Part 2 or H.264.*FFmpeg"):
            fn(path)
    bad = tmp_path / "bad.avi"
    bad.write_bytes(b"RIFF\0\0\0\0WAVEfmt ")
    with pytest.raises(ValueError, match="not an AVI"):
        probe_video(str(bad))


@pytest.mark.parametrize("source", ["clip.mp4", "CLIP.MKV", "a.webm", 0])
def test_other_sources_raise_naming_what_is_missing(source, tmp_path):
    missing = "capture" if isinstance(source, int) else "FFmpeg"
    path = source
    if source == "clip.mp4":  # the port reads MP4 and H.264, but not CABAC
        path, missing = h264_mp4(str(tmp_path / "in" / source)), "H.264.*CABAC.*FFmpeg"
    if source == "CLIP.MKV":  # nor in Matroska
        path = h264_cabac_mkv(str(tmp_path / "in" / source))
        missing = "H.264.*CABAC.*FFmpeg"
    if source == "a.webm":  # it reads WebM, but not a VP9 profile 1 (4:4:4) track
        path, missing = vp9_mkv(str(tmp_path / "in" / source)), "VP9.*FFmpeg"
    for fn in (probe_video, lambda p: list(iterate_frames(p)),
               lambda p: FrameSource(p, ValTransform((32, 32))),
               lambda p: NativeFrameSource(p, (32, 32))):
        with pytest.raises(ValueError, match=missing):
            fn(path)
    if not isinstance(source, int) and source != "clip.mp4":  # .mp4 is written (MPEG-4)
        with pytest.raises(ValueError, match="FFmpeg"):
            VideoWriter(str(tmp_path / "out" / source), 10, (64, 48))
        assert not os.path.exists(tmp_path / "out")
    elif source == "clip.mp4":
        with VideoWriter(str(tmp_path / "out" / source), 10, (64, 48)) as writer:
            writer.write(np.zeros((48, 64, 3), np.uint8))
        assert probe_video(str(tmp_path / "out" / source))["frame_count"] == 1


def test_video_writer_writes_avi_at_the_given_rate(tmp_path):
    """An .avi from ``VideoWriter`` holds MPEG-4 Part 2 (as JAX's ``mp4v``
    writer's) at the rate OpenCV stores for 25 / 3 fps, 8333 / 1000, which
    cv2 reads back as from JAX's file; the port's AviWriter keeps
    Motion-JPEG and the exact 25 / 3 for fixtures."""
    frames = photo_frames(5)
    with VideoWriter(str(tmp_path / "sub" / "w.avi"), 25 / 3, (64, 48)) as vw:
        for f in frames:
            vw.write(f)
    index = read_index(str(tmp_path / "sub" / "w.avi"))
    assert (index.rate, index.scale, index.frame_count, index.codec) == (8333, 1000, 5, "mpeg4")
    jax = cv2.VideoWriter(str(tmp_path / "jax.avi"), cv2.VideoWriter_fourcc(*"mp4v"), 25 / 3,
                          (64, 48))
    for f in frames:
        jax.write(f[..., ::-1].copy())
    jax.release()
    caps = [cv2.VideoCapture(str(p), cv2.CAP_FFMPEG)
            for p in (tmp_path / "sub" / "w.avi", tmp_path / "jax.avi")]
    assert [(c.get(cv2.CAP_PROP_FPS), c.get(cv2.CAP_PROP_FRAME_COUNT)) for c in caps] == [
        (8.333, 5.0)] * 2
    write_video(str(tmp_path / "m.avi"), frames, 25 / 3, "port")
    m = read_index(str(tmp_path / "m.avi"))
    assert (m.rate, m.scale, m.frame_count, m.codec) == (25, 3, 5, "jpeg")
    with pytest.raises(ValueError, match="frame of"):
        AviWriter(str(tmp_path / "z.avi"), 64, 48, 10).write(np.zeros((10, 10, 3), np.uint8))


def test_frame_transform_equals_val_transform():
    """C++ ValTransform over random sizes, up and down, both layouts."""
    rng = np.random.default_rng(0)
    for _ in range(120):
        ih, iw = (int(v) for v in rng.integers(2, 160, 2))
        h, w = (int(v) for v in rng.integers(2, 120, 2))
        img = rng.integers(0, 256, (ih, iw, 3), dtype=np.uint8)
        for letterbox in (True, False):
            if letterbox and min(round(ih * min(h / ih, w / iw)),
                                 round(iw * min(h / ih, w / iw))) < 1:
                continue
            for normalize in (True, False):
                want, _, affine = ValTransform((h, w), letterbox, normalize)(img)
                got, got_affine = frame_transform(img, (h, w), letterbox, normalize)
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want, err_msg=str((ih, iw, h, w, letterbox)))
                np.testing.assert_array_equal(got_affine, affine)


@pytest.mark.parametrize("every", [1, 3])
@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("letterbox", [True, False])
def test_native_source_equals_thread_source(letterbox, normalize, every, tmp_path):
    path = write_video(str(tmp_path / "s.avi"), photo_frames(14, 90, 120, seed=11), 10, "opencv")
    transform = ValTransform((64, 80), letterbox_resize=letterbox, normalize=normalize)
    thread = list(FrameSource(path, transform, every=every))
    native_src = NativeFrameSource(path, (64, 80), every=every, letterbox_resize=letterbox,
                                   normalize=normalize, queue_size=3)
    assert (native_src.fps, native_src.width, native_src.height) == (10.0, 120, 90)
    native = list(native_src)
    assert [t[0] for t in native] == [t[0] for t in thread] == list(range(0, 14, every))
    for (_, rgb, x, affine), (_, none, y, b) in zip(thread, native):
        assert none is None and x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(affine, b)


@pytest.mark.parametrize("kind", ["thread", "native"])
def test_close_wakes_a_blocked_consumer(kind, tmp_path):
    path = write_video(str(tmp_path / "long.avi"), [np.zeros((48, 64, 3), np.uint8)] * 200, 10,
                       "port")
    src = (FrameSource(path, ValTransform((64, 64)), queue_size=4) if kind == "thread"
           else NativeFrameSource(path, (64, 64), queue_size=4))
    it = iter(src)
    next(it)
    src.close()
    t0 = time.perf_counter()
    rest = sum(1 for _ in it)  # ends promptly, without hanging on the ring
    assert time.perf_counter() - t0 < 5.0 and rest < 199


@pytest.mark.parametrize("kind", ["thread", "native"])
def test_corrupt_frame_raises_after_the_frames_before_it(kind, tmp_path):
    path = str(tmp_path / "c.avi")
    with AviWriter(path, 64, 48, 10) as w:
        for i, f in enumerate(photo_frames(6)):
            w.write_jpeg(encode_jpeg(f, 95) if i != 4 else b"\xff\xd8\xff\xe0 not a jpeg")
    src = (FrameSource(path, ValTransform((32, 32))) if kind == "thread"
           else NativeFrameSource(path, (32, 32)))
    seen = []
    with pytest.raises(ValueError, match="frame 4"):
        for idx, *_ in src:
            seen.append(idx)
    assert seen == [0, 1, 2, 3]


def test_extract_frames_writes_the_jpeg_bytes_of_the_decoded_frames(tmp_path):
    path = write_video(str(tmp_path / "e.avi"), photo_frames(7, seed=13), 10, "ffmpeg")
    assert extract_frames(path, str(tmp_path / "jpg"), every=3, quality=90) == 3
    assert sorted(os.listdir(tmp_path / "jpg")) == ["00000000.jpg", "00000003.jpg",
                                                    "00000006.jpg"]
    for idx, frame in iterate_frames(path, every=3):
        data = (tmp_path / "jpg" / f"{idx:08d}.jpg").read_bytes()
        assert data == encode_jpeg(frame, 90)
        assert data == cv2.imencode(".jpg", frame[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, 90])[1]\
            .tobytes()
    assert extract_frames(path, str(tmp_path / "png"), ext="png") == 7
    for idx, frame in iterate_frames(path):
        png = cv2.imread(str(tmp_path / "png" / f"{idx:08d}.png"))[..., ::-1]
        np.testing.assert_array_equal(png, frame)


@pytest.mark.parametrize("writer", ["opencv", "ffmpeg"])
def test_default_cv2_backend_is_not_the_reference(writer, tmp_path, capsys):
    """Why the tests hold the reader to ``CAP_OPENCV_MJPEG``: cv2's default
    backend (FFmpeg) decodes MJPEG with its own IDCT, chroma upsampling and
    colour conversion, off ``cv2.imdecode`` of the same bytes by several
    grey levels (printed under ``-s``), while the MJPEG backend equals it."""
    rng = np.random.default_rng(0)
    frames = [cv2.GaussianBlur(rng.integers(0, 256, (48, 64, 3)).astype(np.uint8), (5, 5), 0)
              for _ in range(5)]
    path = write_video(str(tmp_path / "g.avi"), frames, 10, writer)
    raw = [cv2.imdecode(np.frombuffer(j, np.uint8), cv2.IMREAD_COLOR)[..., ::-1]
           for j in AviReader(path)]
    mjpeg, _ = cv2_frames(path)
    default, _ = cv2_frames(path, cv2.CAP_ANY)
    assert all(np.array_equal(a, b) for a, b in zip(mjpeg, raw))
    gap = max(int(np.abs(a.astype(int) - b).max()) for a, b in zip(default, raw))
    with capsys.disabled():
        print(f"\ncv2 {cv2.__version__}, {writer}-written: the default backend is up to "
              f"{gap} grey levels off cv2.imdecode")
    assert len(default) == 5 and gap > 0
