"""The port's MPEG-4 Part 2 encoder (``native/mpeg4enc.cpp``,
``native.Mpeg4Encoder``) and its MP4 muxer (``native/mp4.py``
``Mp4Writer``), against OpenCV (FFmpeg's decoder, and its ``mp4v`` writer,
what the JAX package writes with) on the CPU.

* Bit for bit: cv2's frames of the port's ``.mp4`` equal the port's own
  decode (``Mp4Reader`` + ``Mpeg4Decoder``), and cv2's Y planes and the
  port decoder's three planes equal the encoder's reconstruction, at
  640x480 over 30 frames (a second I-VOP), 64x48, 100x76 (not whole
  macroblocks), and at odd sizes, which ``VideoWriter`` truncates to even
  as OpenCV's writer does (cv2 opens both at the same size).
* Index and timing: ``stss`` lists every 12th frame; cv2's fps and frame
  count on the port's file equal those on JAX's writer's file of the same
  frames at 25, 30000/1001 and 12.5 fps (OpenCV stores 29.97, not
  30000/1001, and the port stores what it stores).
* Quality and size on drawn frames against cv2's ``mp4v`` writer.
* The headers carry no user data, the layout is FFmpeg's (``ftyp``,
  placeholder, ``mdat``, ``moov``; ``qt  `` for ``.mov``; ``co64`` past
  4 GiB), encoders in two threads give the bytes of one, and bad sizes,
  rates and frames raise naming what.
"""

import threading

import numpy as np
import pytest

from tests.fixtures.make_mp4_fixture import moving_scene
from tests.torch_mp4_helpers import cv2_views
from tests.torch_video_helpers import cv2_props, cv2_write, drawn_frames, psnr
from viddet_tpu_torch.native import Mpeg4Decoder, Mpeg4Encoder
from viddet_tpu_torch.native.mp4 import Mp4Reader, Mp4Writer, read_index
from viddet_tpu_torch.utils.video import VideoWriter, iterate_frames, writer_rate


def rgb_scene(n: int, w: int, h: int, seed: int = 0) -> list:
    return [np.ascontiguousarray(f[..., ::-1]) for f in moving_scene(n, w, h, seed)]


def encode_mp4(path: str, frames, fps=(25, 1)):
    """The frames through one encoder into an MP4; returns each frame's
    reconstruction (Y, U, V)."""
    h, w = frames[0].shape[:2]
    encoder = Mpeg4Encoder(w, h, *fps, name=path)
    planes = []
    with Mp4Writer(path, w, h, fps, encoder.config) as mp4:
        for f in frames:
            mp4.write_sample(*encoder.encode(f))
            planes.append(encoder.planes())
    encoder.close()
    return planes


@pytest.mark.parametrize("w,h,n", [(640, 480, 30), (64, 48, 14), (100, 76, 14)])
def test_cv2_the_port_decoder_and_the_reconstruction_agree(w, h, n, tmp_path):
    path = str(tmp_path / "a.mp4")
    planes = encode_mp4(path, rgb_scene(n, w, h, seed=w))
    got = [f for _, f in iterate_frames(path)]
    want, ys = cv2_views(path, "bgr"), cv2_views(path, "y")
    assert len(got) == len(want) == len(ys) == n
    for g, c, y, p in zip(got, want, ys, planes):
        np.testing.assert_array_equal(g, c[..., ::-1])
        np.testing.assert_array_equal(y[:h], p[0])
    with Mp4Reader(path) as reader:
        decoder = Mpeg4Decoder(reader.index.config)
        for i, p in enumerate(planes):
            assert decoder.decode(reader.sample(i)) is not None  # low_delay: shown at once
            for d, e in zip(decoder.planes(), p):
                np.testing.assert_array_equal(d, e)


@pytest.mark.parametrize("w,h", [(63, 47), (65, 48), (64, 49)])
def test_odd_sizes_are_truncated_as_opencv_truncates_them(w, h, tmp_path):
    """OpenCV's writer drops the last column / row of an odd size (and
    refuses 1x1); the port's files open at cv2's size, and cv2's frames,
    the port's and the reconstruction agree bit for bit."""
    frames = drawn_frames(14, w, h, seed=1)
    path = str(tmp_path / "odd.mp4")
    planes = []
    with VideoWriter(path, 25, (w, h)) as writer:
        for f in frames:
            writer.write(f)
            planes.append(writer.planes())
    jax = cv2_write(str(tmp_path / "jax.mp4"), frames, 25)
    assert cv2_props(path) == cv2_props(jax) == (14, w & ~1, h & ~1, 25.0)
    got = [f for _, f in iterate_frames(path)]
    for g, c, y, p in zip(got, cv2_views(path, "bgr"), cv2_views(path, "y"), planes):
        np.testing.assert_array_equal(g, c[..., ::-1])
        np.testing.assert_array_equal(y[: h & ~1], p[0])
    with pytest.raises(ValueError, match="1x1"):
        VideoWriter(str(tmp_path / "one.mp4"), 25, (1, 1))


@pytest.mark.parametrize("fps", [25, 30000 / 1001, 12.5])
def test_key_frames_and_rates_equal_opencv(fps, tmp_path):
    frames = rgb_scene(30, 64, 48, seed=2)
    path = str(tmp_path / "a.mp4")
    with VideoWriter(path, fps, (64, 48)) as writer:
        for f in frames:
            writer.write(f)
    index = read_index(path)
    assert index.keyframes.tolist() == [0, 12, 24]
    jax = cv2_write(str(tmp_path / "jax.mp4"), frames, fps)
    assert cv2_props(path) == cv2_props(jax)
    assert writer_rate(fps) == {25: (25, 1), 12.5: (25, 2)}.get(fps, (2997, 100))


def test_quality_and_size_against_opencv(tmp_path):
    """24 drawn frames at 320x240: each frame's PSNR (cv2's decode against
    the drawn frame) is at least cv2's ``mp4v`` writer's for that frame
    less 1 dB, and the file is at most twice cv2's bytes.  Measured on the CPU
    (libavcodec 62.28): the port's PSNR is at worst 0.03 dB below cv2's on
    a frame and 0.1 dB above on the mean (28.28 against 28.18 dB); its file
    is 1.32 times cv2's (334,105 against 252,891 bytes; at 640x480 over 30
    frames 1.52 times, and the PSNR never below cv2's)."""
    frames = drawn_frames(24, 320, 240, seed=3)
    jax = cv2_write(str(tmp_path / "jax.mp4"), frames, 25)
    path = str(tmp_path / "port.mp4")
    with VideoWriter(path, 25, (320, 240)) as writer:
        for f in frames:
            writer.write(f)
    theirs = [psnr(c[..., ::-1], f) for c, f in zip(cv2_views(jax, "bgr"), frames)]
    ours = [psnr(c[..., ::-1], f) for c, f in zip(cv2_views(path, "bgr"), frames)]
    assert len(ours) == len(theirs) == 24
    assert min(o - t for o, t in zip(ours, theirs)) >= -1.0
    size, cv2_size = (tmp_path / "port.mp4").stat().st_size, (tmp_path / "jax.mp4").stat().st_size
    assert size <= 2 * cv2_size


def test_headers_carry_no_user_data_and_open_the_decoder():
    """VOS, VO and VOL only: no user data (0x1B2) that FFmpeg keys a
    workaround on (``XviD``, ``DivX``, ``Lavc``); the port's decoder reads
    the VOL's size."""
    encoder = Mpeg4Encoder(100, 76, 2997, 100)
    config = encoder.config
    codes = [config[i + 3] for i in range(len(config) - 3) if config[i : i + 3] == b"\0\0\1"]
    assert codes == [0xB0, 0xB5, 0x00, 0x20]
    assert not any(s in config for s in (b"XviD", b"DivX", b"Lavc"))
    decoder = Mpeg4Decoder(config)
    assert (decoder.width, decoder.height) == (100, 76)
    vop, key = encoder.encode(np.zeros((76, 100, 3), np.uint8))
    assert key and vop[:4] == b"\0\0\1\xb6" and not any(s in vop for s in (b"XviD", b"DivX"))


def test_mp4_layout_is_ffmpegs(tmp_path):
    frames = rgb_scene(3, 64, 48)
    for name, brand, holder in (("a.mp4", b"isom", b"free"), ("a.mov", b"qt  ", b"wide")):
        path = str(tmp_path / name)
        with VideoWriter(path, 25, (64, 48)) as writer:
            for f in frames:
                writer.write(f)
        data = open(path, "rb").read()
        kinds, pos = [], 0
        while pos < len(data):
            size = int.from_bytes(data[pos : pos + 4], "big")
            kinds.append(data[pos + 4 : pos + 8])
            pos += size
        assert kinds == [b"ftyp", holder, b"mdat", b"moov"] and data[8:12] == brand
        for box in (b"mvhd", b"tkhd", b"mdhd", b"hdlr", b"vmhd", b"dref", b"stsd", b"esds",
                    b"stts", b"stss", b"stsc", b"stsz", b"stco"):
            assert box in data, box
    encoder = Mpeg4Encoder(64, 48, 25, 1)
    writer = Mp4Writer(str(tmp_path / "far.mp4"), 64, 48, (25, 1), encoder.config)
    writer.write_sample(*encoder.encode(frames[0]))
    writer.chunks[0][0] = 5 << 30  # a chunk past 4 GiB takes co64
    moov = writer._moov()
    writer.close()
    assert b"co64" in moov and b"stco" not in moov
    assert (5 << 30).to_bytes(8, "big") in moov


def test_two_threads_encode_as_one(tmp_path):
    """ctypes lets go of the GIL for an encode: two encoders in two threads
    give the bytes of one."""
    frames = rgb_scene(6, 160, 120, seed=4)
    encoder = Mpeg4Encoder(160, 120, 25, 1)
    want = [encoder.encode(f) for f in frames]
    results = [[], []]

    def run(out):
        e = Mpeg4Encoder(160, 120, 25, 1)
        out.extend(e.encode(f) for f in frames)

    threads = [threading.Thread(target=run, args=(r,)) for r in results]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert results[0] == results[1] == want


def test_bad_sizes_rates_and_frames_raise(tmp_path):
    with pytest.raises(ValueError, match="must be even"):
        Mpeg4Encoder(63, 48, 25, 1)
    with pytest.raises(ValueError, match="65535"):
        Mpeg4Encoder(64, 48, 70000, 1)
    with pytest.raises(ValueError, match="65535"):
        writer_rate(70000.5)
    with pytest.raises(ValueError, match="positive"):
        writer_rate(0)
    encoder = Mpeg4Encoder(64, 48, 25, 1, name="clip.mp4")
    encoder.encode(np.zeros((48, 64, 3), np.uint8))
    with pytest.raises(ValueError, match="clip.mp4 frame 1"):
        encoder.encode(np.zeros((48, 62, 3), np.uint8))
    with VideoWriter(str(tmp_path / "w.mp4"), 25, (64, 48)) as writer:
        with pytest.raises(ValueError, match="frame of 10x10 in a 64x48 video"):
            writer.write(np.zeros((10, 10, 3), np.uint8))


def test_drawn_frames_of_the_card_phases_meet_the_psnr_floor(tmp_path):
    """``chip_smoke.py`` holds each frame of every drawn ``_det.mp4`` to
    ``DRAWN_PSNR_DB`` (20 dB) against its drawn frame, a floor that a wrong
    colour conversion or a broken decode falls far below.  Here the same
    kinds of frame at 640x480 (``photo_like`` images and the three
    committed fixtures' frames), each with 32 labelled COCO boxes drawn on
    it (the card's runs draw about 8), meet it.  The PSNR falls as boxes
    and labels are added; measured on the CPU on ``photo_like`` frames: 27.4 dB at
    worst with 8 boxes, 25.3 with 16 and 23.0 with 32."""
    import chip_smoke
    from tests.fixtures.make_mp4_fixture import CHIP_BVOP_VIDEO, CHIP_VIDEO, CHIP_WEBM_VIDEO
    from viddet_tpu_torch.data.names import COCO_CLASSES
    from viddet_tpu_torch.utils.image import draw_detections

    rng = np.random.default_rng(0)
    sets = {"photo_like": [chip_smoke.photo_like(np.random.default_rng((1, j)))
                           for j in range(6)]}
    for path in (CHIP_VIDEO, CHIP_BVOP_VIDEO, CHIP_WEBM_VIDEO):
        sets[path] = [f for _, f in iterate_frames(path)][:6]
    for name, frames in sets.items():
        vis = []
        for f in frames:
            x0, y0 = rng.uniform(0, 600, 32), rng.uniform(0, 440, 32)
            boxes = np.stack([x0, y0, x0 + rng.uniform(4, 300, 32), y0 + rng.uniform(4, 300, 32)],
                             1)
            vis.append(draw_detections(f, boxes, rng.integers(0, 80, 32), rng.uniform(0.3, 1, 32),
                                       COCO_CLASSES, 0.0))
        path = str(tmp_path / "drawn.mp4")
        with VideoWriter(path, 25, (640, 480)) as writer:
            for v in vis:
                writer.write(v)
        worst = min(psnr(g, v) for (_, g), v in zip(iterate_frames(path), vis))
        assert worst >= chip_smoke.DRAWN_PSNR_DB, (name, worst)
