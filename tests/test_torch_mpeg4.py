"""The port's MPEG-4 Part 2 decoder (``native/codec.cpp``, ``native.Mpeg4Decoder``)
against FFmpeg's as the opencv-python wheel bundles it, on the CPU.

* Files written here by ``cv2.VideoWriter`` (``mp4v``, FFmpeg's mpeg4
  encoder, what the JAX package's ``VideoWriter`` writes) from seeded
  numpy content: 640x480 over three GOPs, 200x136 (partial macroblocks)
  panning so that vectors point outside the frame, noise (large
  coefficients and all three escapes) in a ``.mov``, and static frames.
  Every frame's Y plane equals ``cv2.VideoCapture(...,
  [CAP_PROP_CONVERT_RGB, 0])``'s bit for bit, and the RGB frames equal the
  JAX package's ``iterate_frames`` (cv2's FFmpeg backend) bit for bit.
* Two committed files that ``cv2.VideoWriter`` cannot make
  (``tests/fixtures/make_mp4_fixture.py``): four vectors a macroblock, AC
  prediction, a quantiser changing per macroblock and video packets; and
  samples of 0 under libavcodec's x86 no-rounding averages.  The same
  holds.
* A non-coded VOP repeats the picture before it; this FFmpeg build
  returns no frame for it (ROADMAP Queue 3).  S-VOPs, a stream that does
  not start with an I-VOP and each VOL feature the decoder does not have
  raise ValueError naming it; a corrupt sample raises naming the file and
  the frame, after the frames before it.  (B-VOPs and MPEG quantisation
  are decoded: ``tests/test_torch_mpeg4_bvop.py``.)
"""

import os

import cv2
import numpy as np
import pytest

from tests.fixtures.make_mp4_fixture import DARK, FEATURES, moving_scene
from tests.torch_mp4_helpers import BitWriter, cv2_views, vol_config, write_mp4
from viddet_tpu.utils.video import iterate_frames as jax_iterate_frames
from viddet_tpu_torch.data.transforms import ValTransform
from viddet_tpu_torch.infer.stream import FrameSource, NativeFrameSource
from viddet_tpu_torch.native import Mpeg4Decoder
from viddet_tpu_torch.native.mp4 import Mp4Reader, read_index
from viddet_tpu_torch.utils.video import iterate_frames


def noise(n, w, h, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(n)]


def pan(n, w, h, seed):
    """A textured scene larger than the frame, panned so that the frame
    moves across the texture's edge and back."""
    rng = np.random.default_rng(seed)
    big = cv2.GaussianBlur(rng.integers(0, 256, (h + 96, w + 96, 3), dtype=np.uint8), (0, 0), 2)
    out = []
    for i in range(n):
        x, y = int(48 + 40 * np.sin(i / 3)), int(48 + 30 * np.cos(i / 4))
        out.append(big[y:y + h, x:x + w].copy())
    return out


# name -> (file name, frames)
CLIPS = {
    "vga": ("vga.mp4", lambda: moving_scene(26, 640, 480, seed=0)),
    "edge": ("edge.mp4", lambda: pan(14, 200, 136, seed=1)),
    "noise": ("noise.mov", lambda: noise(6, 176, 144, seed=2)),
    "static": ("static.mp4", lambda: [moving_scene(1, 96, 64, seed=4)[0]] * 14),
}


def write_clip(path: str, frames, fps: float = 25) -> str:
    h, w = frames[0].shape[:2]
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    assert writer.isOpened()
    for f in frames:
        writer.write(f)
    writer.release()
    return path


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    d = tmp_path_factory.mktemp("mpeg4")
    paths = {name: write_clip(str(d / file), make()) for name, (file, make) in CLIPS.items()}
    paths.update(features=FEATURES, dark=DARK)
    return paths


def port_planes(path: str):
    """(Y plane, RGB frame) of every frame, through ``Mpeg4Decoder``."""
    reader = Mp4Reader(path)
    decoder = Mpeg4Decoder(reader.index.config, path)
    out = []
    for i in range(len(reader)):
        rgb = decoder.decode(reader.sample(i))
        out.append((decoder.planes()[0], rgb))
    reader.close()
    return out


@pytest.mark.parametrize("name", [*CLIPS, "features", "dark"])
def test_y_planes_and_rgb_equal_ffmpeg(name, clips):
    path = clips[name]
    ours = port_planes(path)
    ys, bgr = cv2_views(path, "y"), cv2_views(path, "bgr")
    assert len(ours) == len(ys) == len(bgr) == read_index(path).frame_count
    for i, ((y, rgb), want_y, want) in enumerate(zip(ours, ys, bgr)):
        np.testing.assert_array_equal(y, want_y.reshape(y.shape), err_msg=f"{name} Y {i}")
        np.testing.assert_array_equal(rgb, want[..., ::-1], err_msg=f"{name} RGB {i}")


@pytest.mark.parametrize("name", ["vga", "edge"])
def test_iterate_frames_equals_jax(name, clips, monkeypatch):
    import viddet_tpu.native as jax_native

    monkeypatch.setattr(jax_native, "available", lambda: False)
    path = clips[name]
    for every in (1, 3):
        for rgb in (True, False):
            got = list(iterate_frames(path, every=every, rgb=rgb))
            want = list(jax_iterate_frames(path, every=every, rgb=rgb))
            assert [i for i, _ in got] == [i for i, _ in want]
            for (i, g), (_, w) in zip(got, want):
                np.testing.assert_array_equal(g, w, err_msg=f"{name} every {every} frame {i}")


@pytest.mark.parametrize("normalize,letterbox", [(False, True), (True, True), (False, False)])
def test_native_source_equals_frame_source(normalize, letterbox, clips):
    path = clips["edge"]
    for every in (1, 3):
        thread = FrameSource(path, ValTransform((48, 64), letterbox, normalize=normalize),
                             every=every)
        native = NativeFrameSource(path, (48, 64), every=every, letterbox_resize=letterbox,
                                   normalize=normalize, queue_size=4)
        got = list(native)
        want = list(thread)
        assert [g[0] for g in got] == [w[0] for w in want] == list(range(0, 14, every))
        for (_, _, x, affine), (_, _, wx, waffine) in zip(got, want):
            np.testing.assert_array_equal(x, wx)
            np.testing.assert_array_equal(affine, waffine)


def nvop(time_bits: int) -> bytes:
    """A non-coded P-VOP: the header up to vop_coded = 0."""
    bits = BitWriter().put(1, 2).put(0, 1).put(1, 1).put(0, time_bits).put(1, 1).put(0, 1)
    return b"\x00\x00\x01\xb6" + bits.stuffed()


def test_non_coded_vop_repeats_the_picture_before_it(clips, tmp_path):
    """The port keeps one frame a sample (the picture before, repeated, as
    14496-2 displays a non-coded VOP); this FFmpeg build returns no frame
    for it, so OpenCV reads one frame fewer for each.  The coded frames
    agree."""
    reader = Mp4Reader(clips["edge"])
    samples = [reader.sample(i) for i in range(len(reader))]
    samples[5] = samples[6] = nvop(5)  # 25 ticks a second: 5 bits of vop_time_increment
    path = write_mp4(str(tmp_path / "n.mp4"), samples, reader.index.width, reader.index.height,
                     config=reader.index.config)
    ours = [f for _, f in iterate_frames(path)]
    ffmpeg = [f[..., ::-1] for f in cv2_views(path, "bgr")]
    assert len(ours) == 14 and len(ffmpeg) == 12
    np.testing.assert_array_equal(ours[5], ours[4])
    np.testing.assert_array_equal(ours[6], ours[4])
    for got, want in zip(ours[:5] + ours[7:], ffmpeg):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("flags,named", [
    (dict(interlaced=1), "interlaced"),
    (dict(sprite=2), "global motion compensation"),
    (dict(newpred=1), "NEWPRED"),
    (dict(reduced_resolution=1), "reduced-resolution"),
    (dict(not_8_bit=1), "not_8_bit"),
    (dict(scalability=1), "scalability"),
    (dict(data_partitioned=1), "data partitioning"),
    (dict(data_partitioned=1, reversible_vlc=1), "reversible VLC"),
    (dict(shape=2), "non-rectangular shape"),
])
def test_refused_vol_features_raise_naming_them(flags, named, clips, tmp_path):
    config = vol_config(176, 144, **flags)
    with pytest.raises(ValueError, match=named):
        Mpeg4Decoder(config)
    reader = Mp4Reader(clips["noise"])
    path = write_mp4(str(tmp_path / "f.mp4"), [reader.sample(0)], 176, 144, config=config)
    for fn in (lambda p: list(iterate_frames(p)), lambda p: NativeFrameSource(p, (32, 32)),
               lambda p: FrameSource(p, ValTransform((32, 32)))):
        with pytest.raises(ValueError, match=named):
            fn(path)
    assert Mpeg4Decoder(vol_config(176, 144)).width == 176  # the same header, plain


@pytest.mark.parametrize("kind,named", [(2, "B-VOP"), (3, "S-VOP")])
def test_b_and_s_vops_raise_naming_the_frame(kind, named, clips, tmp_path):
    """An S-VOP raises naming its frame, from the index and from the
    decoder alone.  B-VOPs are decoded; a stream that starts with one
    raises naming frame 0, and the decoder alone drops a B-VOP before two
    reference pictures, as libavcodec does."""
    reader = Mp4Reader(clips["edge"])
    samples = [reader.sample(i) for i in range(len(reader))]
    frame = 3 if kind == 3 else 0
    sample = samples[frame]
    at = sample.find(b"\x00\x00\x01\xb6") + 4
    samples[frame] = sample[:at] + bytes([(sample[at] & 0x3F) | kind << 6]) + sample[at + 1:]
    path = write_mp4(str(tmp_path / "b.mp4"), samples, 200, 136, config=reader.index.config)
    want = (f"frame 3 at offset .*{named}" if kind == 3
            else f"frame 0 at offset .*{named}.*does not start with an I-VOP")
    with pytest.raises(ValueError, match=want):
        list(iterate_frames(path))
    decoder = Mpeg4Decoder(reader.index.config)
    if kind == 2:
        assert decoder.decode(samples[0]) is None and decoder.flush() is None
        return
    with pytest.raises(ValueError, match=named):  # the decoder alone refuses it too
        for s in samples:
            decoder.decode(s)


@pytest.mark.parametrize("kind", ["thread", "native"])
def test_corrupt_sample_raises_naming_the_frame(kind, clips, tmp_path):
    reader = Mp4Reader(clips["edge"])
    samples = [reader.sample(i) for i in range(len(reader))]
    head = samples[7].find(b"\x00\x00\x01\xb6") + 8
    samples[7] = samples[7][:head] + b"\x00\x00\x00\x00\x00\x00\x01" * 8  # no valid code
    path = write_mp4(str(tmp_path / "c.mp4"), samples, 200, 136, config=reader.index.config)
    src = (FrameSource(path, ValTransform((32, 32))) if kind == "thread"
           else NativeFrameSource(path, (32, 32), every=2))
    seen = []
    with pytest.raises(ValueError, match=f"{os.path.basename(path)}.*frame 7"):
        for idx, *_ in src:
            seen.append(idx)
    assert seen == ([0, 1, 2, 3, 4, 5, 6] if kind == "thread" else [0, 2, 4, 6])
