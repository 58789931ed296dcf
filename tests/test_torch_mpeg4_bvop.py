"""B-VOPs and MPEG quantisation in the port's MPEG-4 Part 2 decoder
(``native/codec.cpp``, ``native.Mpeg4Decoder``) and in MP4 / MOV
(``native/mp4.py``), against FFmpeg as the opencv-python wheel bundles it,
on the CPU.

The streams come from the wheel's own libavcodec at test time
(``tests.fixtures.make_mp4_fixture.lavc_stream``: ``bf`` B-VOPs between
references, ``+mv4``, ``mpeg_quant`` with the default or custom matrices,
video packets) and are laid out as FFmpeg's MP4 muxer lays out B-frames:
``ctts`` and the edit list that shifts the movie by the first composition
offset (or ``ctts`` version 1 without one).

* Every frame's Y plane and RGB equal OpenCV's (``cv2.VideoCapture``,
  FFmpeg) bit for bit, in display order, and the frame count and fps
  equal ``CAP_PROP_FRAME_COUNT`` / ``CAP_PROP_FPS``: one and two B-VOPs,
  three, direct mode over four-vector co-located macroblocks with video
  packets, 200x136 with vectors past the edge, a cut (intra and skipped
  co-located macroblocks), noise in a ``.mov`` (all three escapes in B
  texture), MPEG quantisation with the default and with custom matrices.
* A quantiser matrix ended early by a 0 repeats its last value.
* The decoder holds each reference picture until the next one (or
  ``flush``) and shows a B-VOP's at once; ``NativeFrameSource`` equals
  ``FrameSource`` + ``ValTransform`` bit for bit at ``every`` 1, 2 and 3.
* A non-coded B-VOP repeats the picture shown before it, and a
  non-coded P-VOP is the newest reference again, where this FFmpeg build
  shows nothing (ROADMAP Queue 3).
* Interlaced streams, and edit lists other than the identity or the
  first-offset shift, raise ValueError naming them before any frame is
  decoded (quarter-sample streams are decoded: test_torch_mpeg4_xvid.py).
* A stream that is invalid (``mpeg4_damaged.mp4``) raises at the
  macroblock where FFmpeg's decoder finds the same fault and conceals.
"""

import cv2
import numpy as np
import pytest

from tests.fixtures.make_mp4_fixture import DAMAGED, lavc_stream, moving_scene, write_lavc_mp4
from tests.torch_mp4_helpers import BitWriter, cv2_views, vol_config, write_mp4
from viddet_tpu_torch.data.transforms import ValTransform
from viddet_tpu_torch.infer.stream import FrameSource, NativeFrameSource
from viddet_tpu_torch.native import Mpeg4Decoder
from viddet_tpu_torch.native.mp4 import Mp4Reader, read_index
from viddet_tpu_torch.utils.video import iterate_frames, probe_video

ZIGZAG = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34,
          27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37,
          44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]
# custom matrices (raster order): the intra one constant along its last 24
# zigzag positions, so a header may end it early with a 0
INTRA = [0] * 64
for _i, _z in enumerate(ZIGZAG):
    INTRA[_z] = 8 if _i == 0 else min(10 + 2 * _i, 90)
INTER = [12 + (i * 7) % 40 for i in range(64)]


def noise(n, w, h, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(n)]


def pan(n, w, h, seed, speed):
    """A blurred texture panned by up to ``19 * speed`` pixels a frame, so
    vectors grow past f_code 1 and point outside the frame."""
    rng = np.random.default_rng(seed)
    big = cv2.GaussianBlur(rng.integers(0, 256, (h + 40 * speed, w + 40 * speed, 3),
                                        dtype=np.uint8), (0, 0), 2)
    out = []
    for i in range(n):
        x = int(20 * speed + 19 * speed * np.sin(i / 2))
        y = int(20 * speed + 19 * speed * np.cos(i / 3))
        out.append(big[y:y + h, x:x + w].copy())
    return out


# name -> (file name, frames, encoder options, custom matrices, ctts version)
CLIPS = {
    "bf1": ("bf1.mp4", lambda: moving_scene(20, 160, 112, seed=1), {"bf": 1}, None, 0),
    "bf2": ("bf2.mp4", lambda: moving_scene(26, 160, 112, seed=2), {"bf": 2}, None, 0),
    "bf2_ctts1": ("bf2v1.mp4", lambda: moving_scene(12, 160, 112, seed=3), {"bf": 2}, None, 1),
    "bf3": ("bf3.mp4", lambda: moving_scene(18, 160, 112, seed=4), {"bf": 3}, None, 0),
    "mv4": ("mv4.mp4", lambda: pan(20, 160, 112, seed=9, speed=4),
            {"bf": 2, "flags": "+mv4", "ps": 300}, None, 0),
    "edge": ("edge.mp4", lambda: pan(16, 200, 136, seed=1, speed=2),
             {"bf": 2, "b": 300000}, None, 0),
    "noise": ("noise.mov", lambda: noise(8, 96, 64, seed=2),
              {"bf": 2, "qmin": 1, "qmax": 3, "b": 20000000}, None, 0),
    "mpeg_quant": ("mq.mp4", lambda: moving_scene(20, 160, 112, seed=7),
                   {"bf": 2, "mpeg_quant": 1, "ps": 200}, None, 0),
    "mpeg_quant_custom": ("mqc.mp4", lambda: moving_scene(20, 200, 136, seed=11),
                          {"bf": 2, "mpeg_quant": 1, "flags": "+mv4"}, (INTRA, INTER), 0),
}


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    d = tmp_path_factory.mktemp("bvop")
    out = {}
    for name, (file, make, options, matrices, version) in CLIPS.items():
        stream = lavc_stream(make(), options, matrices)
        assert "B" in stream.types, name
        out[name] = write_lavc_mp4(str(d / file), stream, shift=not version,
                                   ctts_version=version)
    return out


def port_frames(path: str):
    """(Y plane, RGB frame) of every picture ``Mpeg4Decoder`` shows, in
    display order."""
    reader = Mp4Reader(path)
    decoder = Mpeg4Decoder(reader.index.config, path)
    out = []
    for i in range(len(reader)):
        rgb = decoder.decode(reader.sample(i))
        if rgb is not None:
            out.append((decoder.planes()[0], rgb))
    rgb = decoder.flush()
    if rgb is not None:
        out.append((decoder.planes()[0], rgb))
    reader.close()
    return out


@pytest.mark.parametrize("name", list(CLIPS))
def test_y_planes_rgb_count_and_fps_equal_ffmpeg(name, clips):
    path = clips[name]
    ours = port_frames(path)
    ys, bgr = cv2_views(path, "y"), cv2_views(path, "bgr")
    cap = cv2.VideoCapture(path, cv2.CAP_FFMPEG)
    probe = probe_video(path)
    assert len(ours) == len(ys) == len(bgr) == probe["frame_count"] == \
        cap.get(cv2.CAP_PROP_FRAME_COUNT)
    assert probe["fps"] == cap.get(cv2.CAP_PROP_FPS)
    cap.release()
    for i, ((y, rgb), want_y, want) in enumerate(zip(ours, ys, bgr)):
        np.testing.assert_array_equal(y, want_y.reshape(y.shape), err_msg=f"{name} Y {i}")
        np.testing.assert_array_equal(rgb, want[..., ::-1], err_msg=f"{name} RGB {i}")
    assert [i for i, _ in iterate_frames(path)] == list(range(len(ours)))


def test_matrix_ended_by_zero_repeats_its_last_value(clips):
    """The same I-VOP under a VOL that lists the custom intra matrix whole,
    and one that ends it with a 0 after its 40th value: both equal
    FFmpeg's first frame."""
    path = clips["mpeg_quant_custom"]
    reader = Mp4Reader(path)
    first = reader.sample(0)
    zigzag_intra = [INTRA[z] for z in ZIGZAG]
    zigzag_inter = [INTER[z] for z in ZIGZAG]
    assert len(set(zigzag_intra[40:])) == 1
    want = cv2_views(path, "y")[0].reshape(136, 200)
    for intra in (zigzag_intra, zigzag_intra[:41] + [0]):
        config = vol_config(200, 136, quant_type=1, matrices=(intra, zigzag_inter))
        decoder = Mpeg4Decoder(config)
        assert decoder.decode(first) is not None  # low_delay: shown at once
        np.testing.assert_array_equal(decoder.planes()[0], want)
        decoder.close()


def test_decoder_shows_pictures_in_display_order(clips):
    """A reference picture is held until the next reference arrives (or
    ``flush``); a B-VOP's picture is shown at once."""
    path = clips["bf2"]
    reader = Mp4Reader(path)
    types = "".join("IPBS"[s[s.find(b"\x00\x00\x01\xb6") + 4] >> 6]
                    for s in (reader.sample(i) for i in range(len(reader))))
    decoder = Mpeg4Decoder(reader.index.config)
    shown = [decoder.decode(reader.sample(i), rgb=False) is not None
             for i in range(len(reader))]
    assert shown == [t == "B" or i > 0 for i, t in enumerate(types)]
    assert decoder.flush(rgb=False) is True and decoder.flush() is None
    assert sum(shown) + 1 == len(reader)


@pytest.mark.parametrize("normalize,letterbox", [(False, True), (True, False)])
def test_native_source_equals_frame_source(normalize, letterbox, clips):
    path = clips["edge"]
    for every in (1, 2, 3):
        thread = FrameSource(path, ValTransform((48, 64), letterbox, normalize=normalize),
                             every=every)
        native = NativeFrameSource(path, (48, 64), every=every, letterbox_resize=letterbox,
                                   normalize=normalize, queue_size=4)
        got, want = list(native), list(thread)
        assert [g[0] for g in got] == [w[0] for w in want] == list(range(0, 16, every))
        for (_, _, x, affine), (_, _, wx, waffine) in zip(got, want):
            np.testing.assert_array_equal(x, wx)
            np.testing.assert_array_equal(affine, waffine)


def not_coded(sample: bytes, time_bits: int) -> bytes:
    """``sample``'s VOP with its type and time, not coded (vop_coded 0)."""
    at = sample.find(b"\x00\x00\x01\xb6") + 4
    bits = "".join(f"{b:08b}" for b in sample[at:at + 4])
    modulo = bits.index("0", 2) - 2  # the 1s of modulo_time_base
    head = bits[:2 + modulo + 1 + 1 + time_bits + 1]
    out = BitWriter()
    for bit in head:
        out.put(int(bit), 1)
    return b"\x00\x00\x01\xb6" + out.put(0, 1).stuffed()


def test_non_coded_b_vop_repeats_the_picture_before_it(clips, tmp_path):
    """The port shows the picture shown before a non-coded B-VOP; this
    FFmpeg build shows nothing for it, so OpenCV reads one frame fewer.
    The other frames agree."""
    reader = Mp4Reader(clips["bf2"])
    samples = [reader.sample(i) for i in range(len(reader))]
    b = next(i for i, s in enumerate(samples)
             if i > 4 and s[s.find(b"\x00\x00\x01\xb6") + 4] >> 6 == 2)
    samples[b] = not_coded(samples[b], 5)  # 25 ticks a second: 5 bits of vop_time_increment
    path = write_mp4(str(tmp_path / "n.mp4"), samples, 160, 112, config=reader.index.config)
    ours = [f for _, f in iterate_frames(path)]
    ffmpeg = [f[..., ::-1] for f in cv2_views(path, "bgr")]
    assert len(ours) == len(samples) and len(ffmpeg) == len(samples) - 1
    repeated = next(k for k in range(1, len(ours)) if np.array_equal(ours[k], ours[k - 1]))
    for got, want in zip(ours[:repeated] + ours[repeated + 1:], ffmpeg):
        np.testing.assert_array_equal(got, want)


def test_non_coded_p_vop_in_a_b_vop_stream_is_the_reference_again(clips, tmp_path):
    """A non-coded P-VOP is the newest reference again (14496-2): the port
    shows that picture twice, once as it is held and once again, and the
    B-VOPs after it predict from it.  This FFmpeg build shows nothing for
    it and keeps its references, so OpenCV reads one frame fewer; the
    frames before the held reference agree (ROADMAP Queue 3)."""
    reader = Mp4Reader(clips["bf2"])
    samples = [reader.sample(i) for i in range(len(reader))]
    types = "".join("IPBS"[s[s.find(b"\x00\x00\x01\xb6") + 4] >> 6] for s in samples)
    p = types.index("P", 3)  # the second P-VOP
    samples[p] = not_coded(samples[p], 5)
    path = write_mp4(str(tmp_path / "p.mp4"), samples, 160, 112, config=reader.index.config)
    ours = [f for _, f in iterate_frames(path)]
    ffmpeg = [f[..., ::-1] for f in cv2_views(path, "bgr")]
    assert len(ours) == len(samples) and len(ffmpeg) == len(samples) - 1
    shown_before = types[:p].count("B") + 1  # the frames shown before the held reference
    for got, want in zip(ours[:shown_before], ffmpeg):
        np.testing.assert_array_equal(got, want)
    held = ours[shown_before]
    assert np.array_equal(ours[shown_before + 3], held)  # shown again after its two B-VOPs


@pytest.mark.parametrize("flags,named", [("+ildct", "interlaced")])
def test_refused_streams_raise_before_any_frame(flags, named, tmp_path):
    stream = lavc_stream(moving_scene(6, 96, 64, seed=1), {"bf": 1, "flags": flags})
    path = write_lavc_mp4(str(tmp_path / "r.mp4"), stream)
    for fn in (probe_video, lambda p: next(iterate_frames(p)),
               lambda p: NativeFrameSource(p, (32, 32)),
               lambda p: FrameSource(p, ValTransform((32, 32)))):
        with pytest.raises(ValueError, match=named):
            fn(path)


@pytest.mark.parametrize("edits", [[(2000, 0, 1)], [(2000, 1024, 1)],
                                   [(40, -1, 1), (2000, 512, 1)], [(2000, 512, 2)]])
def test_edit_lists_other_than_the_first_offset_shift_raise(edits, clips, tmp_path):
    """With every composition offset 512 ticks (the first 512), only an
    edit list of one entry at media time 512 and rate 1 is read."""
    index = read_index(clips["bf2"])
    data = open(clips["bf2"], "rb").read()
    samples = [data[o:o + s] for o, s in zip(index.offsets.tolist(), index.sizes.tolist())]
    ctts = [512] * len(samples)
    write_mp4(str(tmp_path / "ok.mp4"), samples, 160, 112, config=index.config, ctts=ctts,
              edits=[(2000, 512, 1)])
    assert probe_video(str(tmp_path / "ok.mp4"))["frame_count"] == len(samples)
    path = write_mp4(str(tmp_path / "e.mp4"), samples, 160, 112, config=index.config,
                     ctts=ctts, edits=edits)
    with pytest.raises(ValueError, match=r"edit list.*first composition offset \(512\)"):
        probe_video(path)


def test_a_damaged_stream_raises_where_ffmpeg_conceals():
    """``tests/fixtures/mpeg4_damaged.mp4`` (libavcodec's own encoder:
    ``+mv4``, adaptive quantisation, two B-VOPs; ROADMAP Queue 3, item B).
    Its tenth sample, a B-VOP, holds at macroblock (2, 6) an ``mb_type``
    code of four 0 bits, which 14496-2's B-VOP ``mb_type`` codes (1, 01,
    001, 0001) do not include: the stream is invalid there.  libavcodec's decoder says so at the same
    macroblock ("illegal MB_type", "Error at MB: 86", counting 14 a row)
    and conceals, so cv2 gives all 26 frames; the port gives the 8 frames
    before it, equal to cv2's, then raises naming the file, the frame and
    the macroblock, through both frame sources."""
    want = cv2_views(DAMAGED, "bgr")
    assert len(want) == 26
    got = []
    with pytest.raises(ValueError, match=r"mpeg4_damaged.mp4 frame 9: .*B-VOP macroblock "
                                         r"\(2, 6\): bad mb_type code"):
        for _, frame in iterate_frames(DAMAGED):
            got.append(frame)
    assert len(got) == 8
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w[..., ::-1])
    for source in (FrameSource(DAMAGED, ValTransform((32, 32))), NativeFrameSource(DAMAGED,
                                                                                    (32, 32))):
        seen = []
        with pytest.raises(ValueError, match="frame 9: .*bad mb_type code"):
            for item in source:
                seen.append(item[0])
        assert seen == list(range(8))
