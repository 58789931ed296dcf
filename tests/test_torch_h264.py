"""The port's H.264 decoder (``native/h264.cpp``, ``native.H264Decoder``)
against OpenCV's FFmpeg on the CPU, and H.264 MP4 / Matroska / AVI files on
every surface that reads video against the JAX package.

The wheel's libavcodec decodes H.264 and has no H.264 encoder, so every
stream here is written by the tests' own writer (``tests/torch_h264_writer``:
seeded random syntax, or its plain encoder over ``moving_scene``), laid out
in a container and read back both ways: every picture's Y plane
(``CAP_PROP_CONVERT_RGB`` 0) and RGB frame equal OpenCV's bit for bit, and
the decoder reports the features the stream claims to exercise (``STREAMS``):
intra 4x4 / 16x16 / chroma modes and I_PCM, P partitions and sub-partitions
with skip runs, vectors off the picture, 4 and 16 references with list
modification, long-term references and MMCO 1-6, non-reference pictures,
POC types 0, 1 and 2, frame_num wrap and gaps, several slices with
disable_deblocking_filter_idc 0, 1 and 2 and offsets, constrained intra, QP
and chroma-offset extremes, cropping (the bottom; an odd top and a left of
64), the VUI colour descriptions OpenCV converts with swscale's plain table
(held by RGB alone: there OpenCV's raw view is not the Y plane), a
profile-100 CAVLC stream, and AUD, SEI, filler and other NAL units with
several and re-sent parameter sets.  Then 20 seeded random-syntax streams,
every refusal (before any frame where the parameter sets or the headers show
it), a damaged slice (raised naming the file and frame after the frames
before it), the containers (MP4 ``avc1`` at NAL length sizes 1, 2 and 4,
``avc3`` in band, Matroska, AVI ``H264``; their probes equal JAX's) and the
surfaces against the JAX package, and the card's fixture against its
digests.
"""

import functools
import hashlib
import json
import os

import jax
import numpy as np
import pytest

import viddet_tpu.cli.detect as jax_detect
import viddet_tpu.cli.extract_frames as jax_extract
import viddet_tpu.native as jax_native
import viddet_tpu_torch.cli.detect as torch_detect
import viddet_tpu_torch.cli.extract_frames as torch_extract
import viddet_tpu_torch.infer.multistream as torch_multistream
from tests import torch_h264_writer as W
from tests.fixtures.make_h264_fixture import DIGESTS, VIDEO, plain_stream
from tests.fixtures.make_mp4_fixture import moving_scene
from tests.test_torch_mp4 import refused, tiny_weights  # noqa: F401
from tests.test_torch_stream import SIZE, twin_models
from tests.test_torch_video_stream import CLASSES, CPU, _cli, assert_txt_equal, transforms
from tests.torch_mkv_helpers import vp9_webm, write_mkv
from tests.torch_mp4_helpers import cv2_views, write_avi, write_mp4
from viddet_tpu.core.precision import FLOAT32_POLICY as JAX_F32
from viddet_tpu.infer.multistream import stream_detect_videos as jax_stream_detect_videos
from viddet_tpu.infer.stream import stream_detect_video as jax_stream_detect_video
from viddet_tpu.utils.video import iterate_frames as jax_iterate_frames
from viddet_tpu.utils.video import probe_video as jax_probe_video
from viddet_tpu_torch.core.precision import FLOAT32_POLICY
from viddet_tpu_torch.infer.stream import FrameSource, NativeFrameSource, stream_detect_video
from viddet_tpu_torch.native import H264Decoder
from viddet_tpu_torch.utils.video import iterate_frames, open_video, probe_video

# ----------------------------------------------------------------- streams


def stream(w, h, seed, n, sps=None, pps=None, first="IDR", kinds=None, **kw):
    """An IDR and ``n`` - 1 more random pictures (``kinds``: each one's
    kind, P by default); the parameter sets lead the first."""
    writer = W.Writer(w, h, seed=seed, sps=sps, pps=pps)
    units = [writer.parameter_sets() + writer.random_picture(first, **kw)[0]]
    for i in range(1, n):
        units.append(writer.random_picture((kinds or {}).get(i, "P"), **kw)[0])
    return units


def refs_stream(w, h, seed, n, nref, log2_frame_num=4, poc_type=2, nonref_every=0, gap_at=0,
                **kw):
    sps = W.Sps(max_num_ref_frames=nref, log2_max_frame_num=log2_frame_num, poc_type=poc_type,
                gaps=int(bool(gap_at)), log2_max_poc_lsb=5, delta_pic_order_always_zero=0,
                offset_for_ref_frame=(2, 4), offset_for_non_ref_pic=1)
    writer = W.Writer(w, h, seed=seed, sps=sps, pps=W.Pps(num_ref_idx_default=nref))
    units = [writer.parameter_sets() + writer.random_picture("IDR")[0]]
    for i in range(1, n):
        ref_idc = 0 if nonref_every and i % nonref_every == 0 else 1
        units.append(writer.random_picture("P", ref_idc=ref_idc, gap=2 if i == gap_at else 0,
                                           modify=bool(writer.rng.random() < 0.5), **kw)[0])
    return units


def mmco_stream(w, h, seed, n, poc_type):
    sps = W.Sps(max_num_ref_frames=4, log2_max_frame_num=5, poc_type=poc_type,
                log2_max_poc_lsb=6)
    writer = W.Writer(w, h, seed=seed, sps=sps, pps=W.Pps(num_ref_idx_default=4))
    units = [writer.parameter_sets() + writer.random_picture("IDR", long_term=True)[0]]
    plan = [(4,), (3,), (1,), (6,), (2,), (3, 1), (), (5,), (4, 6), (3,), (2, 1), None, (1, 6)]
    for i in range(1, n):
        ops = plan[i % len(plan)]
        mmco = None if ops is None else writer.mmco(*ops)
        units.append(writer.random_picture("P", modify=bool(writer.rng.random() < 0.5),
                                           mmco=mmco)[0])
    return units


def nal_stream(w, h, seed):
    """AUD, SEI, filler, an SVC prefix and an MVC slice extension unit, end
    of stream; two SPS and two PPS ids, the sets sent again mid stream."""
    sps0 = W.Sps(id=0, max_num_ref_frames=2, timing=(1, 50), restriction=0)
    sps3 = W.Sps(id=3, max_num_ref_frames=2, poc_type=0, log2_max_poc_lsb=5)
    writer = W.Writer(w, h, seed=seed, sps=sps0)
    sps3.mb_w, sps3.mb_h = writer.mb_w, writer.mb_h
    a, b = W.Pps(id=0, sps_id=0, init_qp=30), W.Pps(id=5, sps_id=0, cb_offset=-4, init_qp=20)
    writer.sps.append(sps3)
    writer.pps = [a, b, W.Pps(id=2, sps_id=3)]
    p = lambda pps: writer.random_picture("P", pps=pps)[0]  # noqa: E731
    return [[W.aud()] + writer.parameter_sets() + [W.sei()] + writer.random_picture(
        "IDR", pps=a)[0],
        [W.aud(), W.filler()] + p(b),
        [W.nal_unit(0, 14, b"\x80\x00\x00\x80")] + p(a) + [W.nal_unit(0, 20, b"\x80\x01\x80")],
        [sps0.nal(), a.nal()] + p(a),
        p(b) + [W.nal_unit(0, 11, b"")]]


BASE = {"IDR picture", "P slices"}
COLOUR = {"bt709", "smpte240m", "bt2020nc", "fcc", "full range bt709"}
# name: (access units, width, height, the features the stream must use)
STREAMS = {
    "intra": (lambda: stream(64, 48, 1, 4, first="IDR", kinds={1: "I", 2: "I", 3: "IDR"},
                             mb_kinds=(W.I4, W.I16), pcm=0.1), 64, 48,
              {"IDR picture", "non-IDR I picture", "intra 4x4", "intra 16x16", "I_PCM"}),
    "P partitions": (lambda: stream(64, 48, 4, 6), 64, 48,
                     BASE | {"P 16x16", "P 16x8", "P 8x16", "P_8x8", "P_8x8ref0",
                             "8x4 sub-partitions", "4x8 sub-partitions", "4x4 sub-partitions",
                             "skipped macroblocks", "intra in P slices",
                             "quarter-sample vectors"}),
    "vectors off the frame": (lambda: stream(48, 32, 3, 5, off_frame=0.6), 48, 32,
                              BASE | {"vectors off the frame"}),
    "4 references": (lambda: refs_stream(48, 32, 4, 10, 4), 48, 32,
                     BASE | {"several references", "reference list modification"}),
    "16 references": (lambda: refs_stream(32, 32, 5, 22, 16, log2_frame_num=5), 32, 32,
                      BASE | {"several references", "reference list modification"}),
    "long-term and MMCO 1-6": (lambda: mmco_stream(48, 32, 6, 14, 0), 48, 32,
                               BASE | {"long-term references", "MMCO 1", "MMCO 2", "MMCO 3",
                                       "MMCO 4", "MMCO 5", "MMCO 6"}),
    "non-reference pictures": (lambda: refs_stream(48, 32, 7, 9, 3, poc_type=0,
                                                   nonref_every=3), 48, 32,
                               BASE | {"non-reference pictures", "POC type 0"}),
    "POC type 0": (lambda: refs_stream(48, 32, 8, 24, 2, poc_type=0), 48, 32,
                   BASE | {"POC type 0", "frame_num wrap"}),
    "POC type 1": (lambda: refs_stream(48, 32, 9, 9, 2, poc_type=1, nonref_every=4), 48, 32,
                   BASE | {"POC type 1", "non-reference pictures"}),
    "POC type 2 and MMCO 5": (lambda: mmco_stream(48, 32, 10, 10, 2), 48, 32,
                              BASE | {"POC type 2", "MMCO 5"}),
    "frame_num wrap": (lambda: refs_stream(32, 16, 11, 40, 2), 32, 16,
                       BASE | {"frame_num wrap"}),
    "frame_num gap": (lambda: refs_stream(48, 32, 12, 8, 3, gap_at=4), 48, 32,
                      BASE | {"frame_num gap"}),
    "slices, deblocking idc 0 and 1": (lambda: stream(64, 48, 13, 4, slices=4, deblock="off"),
                                       64, 48, BASE | {"several slices", "deblocking off"}),
    "slices, deblocking idc 0 and 2": (lambda: stream(64, 48, 14, 4, slices=4,
                                                      deblock="slices"), 64, 48,
                                       BASE | {"several slices", "deblocking within slices"}),
    "slices, deblocking offsets": (lambda: stream(64, 48, 15, 4, slices=3, deblock="offsets"),
                                   64, 48, BASE | {"several slices", "deblocking offsets"}),
    "constrained intra": (lambda: stream(64, 48, 16, 5, pps=W.Pps(constrained_intra=1),
                                         slices=2), 64, 48,
                          BASE | {"constrained intra", "intra in P slices"}),
    "QP 45-51, chroma offset -12": (lambda: stream(48, 32, 17, 4, pps=W.Pps(cb_offset=-12),
                                                   qp_range=(45, 51)), 48, 32,
                                    BASE | {"QP deltas", "chroma QP offset"}),
    "QP 0-6, chroma offset 12": (lambda: stream(48, 32, 18, 4, pps=W.Pps(cb_offset=12),
                                                qp_range=(0, 6)), 48, 32,
                                 BASE | {"QP deltas", "chroma QP offset", "level escapes"}),
    "crop to 64x36": (lambda: stream(64, 48, 19, 3, sps=W.Sps(crop=(0, 0, 0, 6))), 64, 36,
                      BASE | {"cropping"}),
    "odd top crop, left crop 64": (lambda: stream(128, 48, 20, 3, sps=W.Sps(
        crop=(32, 1, 3, 1))), 62, 40, BASE | {"cropping"}),
    "bt709": (lambda: stream(64, 48, 21, 3, sps=W.Sps(colour=(1, 1, 1))), 64, 48,
              {"colour description"}),
    "smpte240m": (lambda: stream(64, 48, 22, 3, sps=W.Sps(colour=(7, 7, 7))), 64, 48,
                  {"colour description"}),
    "bt2020nc": (lambda: stream(64, 48, 23, 3, sps=W.Sps(colour=(2, 2, 9))), 64, 48,
                 {"colour description"}),
    "fcc": (lambda: stream(64, 48, 24, 3, sps=W.Sps(colour=(4, 4, 4))), 64, 48,
            {"colour description"}),
    "full range": (lambda: stream(64, 48, 25, 3, sps=W.Sps(full_range=1)), 64, 48,
                   {"full range"}),
    "full range bt709": (lambda: stream(64, 48, 26, 3, sps=W.Sps(full_range=1,
                                                                  colour=(1, 1, 1))), 64, 48,
                         {"full range", "colour description"}),
    "profile 100 CAVLC": (lambda: stream(64, 48, 27, 4, sps=W.Sps(profile=100), pps=W.Pps(
        cb_offset=3, cr_offset=-5), qp_range=(0, 3)), 64, 48,
                          BASE | {"High profile", "second chroma QP offset",
                                  "level prefix 16"}),
    "NAL units and parameter sets": (lambda: nal_stream(48, 32, 28), 48, 32,
                                     BASE | {"access unit delimiters", "SEI", "filler data",
                                             "other NAL units", "parameter set ids",
                                             "timing info", "bitstream restriction"}),
}


def avi(path, units, w, h):
    return write_avi(path, [W.annexb(u) for u in units], w, h, fourcc=b"H264")


def decode_all(path):
    """Each picture's (RGB, Y) through ``H264Decoder`` over the file's
    samples, in the order shown (the waiting pictures flushed at the end),
    and the decoder's features."""
    with open_video(path) as video:
        index = video.index
        decoder = H264Decoder(index.config, path, index.reorder)
        out = []
        for i in range(len(index.offsets) + 1):
            rgb = decoder.decode(video.sample(i)) if i < len(index.offsets) else decoder.flush()
            while rgb is not None:
                out.append((rgb, decoder.planes()[0]))
                rgb = decoder.flush() if i == len(index.offsets) else None
    features = decoder.features
    decoder.close()
    return out, features


def cv2_frames(path, y_plane=True):
    bgr = cv2_views(path, "bgr")
    h, w = bgr[0].shape[:2]
    ys = [y.reshape(-1)[: h * w].reshape(h, w) for y in cv2_views(path, "y")] if y_plane else [
        None] * len(bgr)
    return [(b[..., ::-1], y) for b, y in zip(bgr, ys)]


def assert_equal_cv2(path, name, features=frozenset(), y_plane=True, count=None):
    got, used = decode_all(path)
    want = cv2_frames(path, y_plane)
    assert len(got) == len(want) == (count if count is not None else len(want)), name
    for k, ((rgb, y), (want_rgb, want_y)) in enumerate(zip(got, want)):
        if want_y is not None:
            np.testing.assert_array_equal(y, want_y, err_msg=f"{name} frame {k} Y")
        np.testing.assert_array_equal(rgb, want_rgb, err_msg=f"{name} frame {k} RGB")
    assert features <= used, features - used
    return used


@pytest.mark.parametrize("name", STREAMS)
def test_frames_equal_cv2_bit_for_bit(name, tmp_path):
    build, w, h, features = STREAMS[name]
    units = build()
    path = avi(str(tmp_path / "v.avi"), units, 16 * ((w + 15) // 16), 16 * ((h + 15) // 16))
    assert_equal_cv2(path, name, features, y_plane=name not in COLOUR, count=len(units))
    assert [i for i, _ in iterate_frames(path)] == list(range(len(units)))
    info = probe_video(path)
    assert (info["width"], info["height"], info["frame_count"]) == (w, h, len(units))


@pytest.mark.parametrize("seed", range(20))
def test_random_syntax_streams_equal_cv2(seed, tmp_path):
    """Seeded streams mixing the sequence's options (POC type, references,
    slices, deblocking, constrained intra, offsets, QP ranges) at random."""
    rng = np.random.default_rng(1000 + seed)
    nref = int(rng.integers(1, 5))
    sps = W.Sps(max_num_ref_frames=nref, poc_type=int(rng.integers(0, 3)),
                log2_max_frame_num=int(rng.integers(4, 7)), log2_max_poc_lsb=5)
    pps = W.Pps(num_ref_idx_default=nref, constrained_intra=int(rng.integers(0, 2)),
                cb_offset=int(rng.integers(-12, 13)), init_qp=int(rng.integers(10, 45)))
    w, h = [(48, 32), (64, 48), (32, 64)][seed % 3]
    writer = W.Writer(w, h, seed=seed, sps=sps, pps=pps)
    lo = int(rng.integers(0, 40))
    kw = dict(slices=int(rng.integers(1, 4)), deblock=[None, "off", "slices", "offsets"][seed % 4],
              qp_range=(lo, lo + int(rng.integers(0, 12))), pcm=0.05, off_frame=0.2)
    units = [writer.parameter_sets() + writer.random_picture("IDR", **kw)[0]]
    for i in range(1, 7):
        kind = "I" if rng.random() < 0.15 else "P"
        units.append(writer.random_picture(kind, modify=bool(rng.random() < 0.4),
                                           ref_idc=int(rng.random() > 0.2), **kw)[0])
    path = avi(str(tmp_path / "r.avi"), units, w, h)
    assert_equal_cv2(path, f"seed {seed}", count=7)


def test_plain_encoding_equals_cv2(tmp_path):
    frames = [np.ascontiguousarray(f[..., ::-1]) for f in moving_scene(8, 96, 64, seed=2)]
    _, units = plain_stream(frames, 96, 64, gop=4, qp=26)
    path = avi(str(tmp_path / "p.avi"), units, 96, 64)
    used = assert_equal_cv2(path, "plain", count=8)
    assert {"intra 4x4", "intra 16x16", "skipped macroblocks", "P 16x16"} <= used


# ---------------------------------------------------------------- refusals


def _mp4_with_sets(path, sps, pps, n=2):
    units = stream(48, 32, 1, n)
    samples = [W.length_prefixed([u for u in unit if u[0] & 31 not in (7, 8)]) for unit in units]
    return write_mp4(path, samples, 48, 32, kind=b"avc1",
                     config=W.avcc([s.nal() for s in sps], [p.nal() for p in pps]))


def _slice_of_type(slice_type):
    b = W.Bits().ue(0).ue(slice_type).ue(0).u(4, 1)
    return W.nal_unit(1, 1, b.u(8, 0).trailing().bytes())


def _in_band(path, units):
    return avi(path, units, 48, 32)


PARAMETER_REFUSALS = {
    "FMO": (W.Sps(), W.Pps(slice_groups=2), "slice groups \\(FMO"),
    # decoded since B slices and weighted prediction are: the case now holds
    # its pictures to cv2's
    "weighted prediction": (W.Sps(profile=77), W.Pps(weighted_pred=1), None),
    "redundant pictures": (W.Sps(), W.Pps(redundant=1), "redundant pictures"),
    "4:4:4": (W.Sps(profile=244, chroma_format=3), W.Pps(), "chroma format 4:4:4"),
    "4:2:2": (W.Sps(profile=122, chroma_format=2), W.Pps(), "chroma format 4:2:2"),
    "monochrome": (W.Sps(profile=100, chroma_format=0), W.Pps(), "4:0:0"),
    "10-bit": (W.Sps(profile=110, bit_depth=10), W.Pps(), "bit depth of 10"),
    "transform bypass": (W.Sps(profile=244, bypass=1), W.Pps(), "transform bypass"),
    "interlace": (W.Sps(frame_mbs_only=0), W.Pps(), "interlaced H.264"),
    "left crop 2": (W.Sps(crop=(1, 0, 0, 0)), W.Pps(), "left crop of 2"),
    "bt2020 primaries": (W.Sps(colour=(9, 14, 9)), W.Pps(), "colour description"),
    "PQ transfer": (W.Sps(colour=(1, 16, 1)), W.Pps(), "colour description"),
    "YCgCo": (W.Sps(colour=(2, 2, 8)), W.Pps(), "colour description"),
}


@pytest.mark.parametrize("case", PARAMETER_REFUSALS)
def test_parameter_set_refusals_raise_before_any_frame(case, tmp_path):
    """In an avcC, a tool the decoder does not decode raises on every
    surface before a frame is decoded or anything written, naming it and
    FFmpeg; a tool it now decodes (weighted prediction) gives cv2's
    pictures."""
    sps, pps, match = PARAMETER_REFUSALS[case]
    sps = W.Sps(**{**sps.__dict__, "mb_w": 3, "mb_h": 2})
    os.makedirs(tmp_path / "in")
    if match is None:
        writer = W.Writer(48, 32, seed=1, sps=sps, pps=pps)
        units = [writer.parameter_sets() + writer.random_picture("IDR")[0]] + [
            writer.random_picture("P")[0] for _ in range(3)]
        path = write_mp4(str(tmp_path / "in" / "w.mp4"), [W.length_prefixed(_vcl(u))
                                                          for u in units], 48, 32,
                         kind=b"avc1", config=W.avcc([sps.nal()], [pps.nal()]))
        assert_equal_cv2(path, case, {"explicit weights"}, count=4)
        return
    path = _mp4_with_sets(str(tmp_path / "in" / "r.mp4"), [sps], [pps])
    refused(path, tmp_path, f"{match}.*FFmpeg")


def in_band_refusal(case):
    """The units and the refusal's message; for what is decoded now (B
    slices, pictures out of decoding order) the message is None."""
    base = stream(48, 32, 3, 4)
    if case == "B slice":
        writer = W.Writer(48, 32, seed=3, sps=W.Sps(profile=77, poc_type=0, max_num_ref_frames=2))
        units = [writer.parameter_sets() + writer.random_picture("IDR")[0],
                 writer.random_picture("P", poc={"lsb": 4})[0],
                 writer.random_picture("B", poc={"lsb": 2}, ref_idc=0)[0]]
        return units, None
    if case == "SP slice":
        return base[:2] + [[_slice_of_type(3)]], "frame 2: H.264: H.264 SP slices.*FFmpeg"
    if case == "SI slice":
        return base[:1] + [[_slice_of_type(4)]], "frame 1: H.264: H.264 SI slices.*FFmpeg"
    if case == "size change":
        other = W.Writer(32, 32, seed=2)
        return base[:2] + [other.parameter_sets() + other.random_picture("IDR")[0]], (
            "frame 2: H.264: .*change of H.264 picture size from 3x2 to 2x2.*FFmpeg")
    if case == "no IDR first":
        return [base[0][:2] + base[1]] + base[2:], "frame 0: .*does not start with an IDR"
    if case == "pictures out of order":
        writer = W.Writer(48, 32, seed=4, sps=W.Sps(poc_type=0, max_num_ref_frames=2))
        units = [writer.parameter_sets() + writer.random_picture("IDR")[0],
                 writer.random_picture("P", poc={"lsb": 4})[0],
                 writer.random_picture("P", poc={"lsb": 2})[0]]
        return units, None
    units = [base[0], [u for u in base[1] if u[0] & 31 in (1, 5)] + [W.nal_unit(0, 2, b"\x80")]]
    return units, "frame 1: H.264: H.264 data partitioning.*FFmpeg"


@pytest.mark.parametrize("case", ["B slice", "SP slice", "SI slice", "size change",
                                  "no IDR first", "pictures out of order",
                                  "data partitioning"])
def test_in_band_refusals_raise_before_any_frame(case, tmp_path):
    """In band (an AVI's Annex B samples), a refused slice or a change of
    size raises before any frame, naming the file and the frame; B slices
    and pictures out of decoding order (decoded now) give cv2's pictures in
    cv2's order."""
    units, match = in_band_refusal(case)
    os.makedirs(tmp_path / "in")
    path = _in_band(str(tmp_path / "in" / "r.avi"), units)
    if match is None:
        used = assert_equal_cv2(path, case, count=len(units))
        assert "reordered output" in used
        return
    refused(path, tmp_path, match)


def test_mp4_composition_offsets_raise_naming_b_frames(tmp_path):
    """Composition offsets ('ctts') and the shifted edit list of B-frames:
    decoded now, the pictures cv2's, in display order (FFmpeg's reorder
    depth from the offsets)."""
    writer = W.Writer(48, 32, seed=1, sps=W.Sps(profile=77, poc_type=0, max_num_ref_frames=2))
    units = [writer.parameter_sets() + writer.random_picture("IDR")[0],
             writer.random_picture("P", poc={"lsb": 4})[0],
             writer.random_picture("B", poc={"lsb": 2}, ref_idc=0)[0]]
    sps, pps = [s.nal() for s in writer.sps], [p.nal() for p in writer.pps]
    samples = [W.length_prefixed([u for u in unit if u[0] & 31 not in (7, 8)]) for unit in units]
    os.makedirs(tmp_path / "in")
    path = write_mp4(str(tmp_path / "in" / "c.mp4"), samples, 48, 32, kind=b"avc1",
                     config=W.avcc(sps, pps), ctts=[512, 1024, 0], edits=[(120, 512, 1)])
    used = assert_equal_cv2(path, "ctts", {"B slices", "reordered output"}, count=3)
    assert "pictures not shown" not in used
    assert probe_video(path) == jax_probe_video(path)


@pytest.mark.parametrize("damage", ["truncated", "flipped"])
def test_damaged_slice_raises_after_the_frames_before_it(damage, tmp_path):
    """FFmpeg conceals a damaged slice; the port raises naming the file and
    the frame, after the frames before it, through both readers."""
    units = stream(64, 48, 5, 6)
    slices = [u for u in units[3] if u[0] & 31 == 1]
    if damage == "truncated":
        units[3] = [slices[0][: len(slices[0]) // 3]]
    else:
        units[3] = [slices[0][:6] + bytes(c ^ 0xFF for c in slices[0][6:])]
    path = avi(str(tmp_path / "d.avi"), units, 64, 48)
    frames = []
    with pytest.raises(ValueError, match=f"{path} frame 3: H.264 decode: "):
        for i, _ in iterate_frames(path):
            frames.append(i)
    assert frames == [0, 1, 2]
    got = []
    with pytest.raises(ValueError, match=f"{path}: frame 3: "):
        for i, _, _, _ in NativeFrameSource(path, (32, 32)):
            got.append(i)
    assert got == [0, 1, 2]


# -------------------------------------------------------------- containers


@pytest.fixture(scope="module")
def clip():
    """A 12-frame plain-encoded H.264 stream at 128x96: its access units and
    parameter sets."""
    frames = [np.ascontiguousarray(f[..., ::-1]) for f in moving_scene(12, 128, 96, seed=5)]
    writer, units = plain_stream(frames, 128, 96, gop=6, qp=27)
    return units, [s.nal() for s in writer.sps], [p.nal() for p in writer.pps]


def _vcl(unit):
    return [u for u in unit if u[0] & 31 not in (7, 8)]


def layouts(root, units, sps, pps):
    cfg = W.avcc(sps, pps)
    return {
        "clip.mp4": write_mp4(f"{root}/clip.mp4", [W.length_prefixed(_vcl(u)) for u in units],
                              128, 96, kind=b"avc1", config=cfg),
        "len2.mp4": write_mp4(f"{root}/len2.mp4", [W.length_prefixed(_vcl(u), 2) for u in units],
                              128, 96, kind=b"avc1", config=W.avcc(sps, pps, 2)),
        "avc3.mp4": write_mp4(f"{root}/avc3.mp4", [W.length_prefixed(u) for u in units], 128, 96,
                              kind=b"avc3", config=W.avcc([], [])),
        "clip.mkv": write_mkv(f"{root}/clip.mkv", [W.length_prefixed(_vcl(u)) for u in units],
                              128, 96, codec="V_MPEG4/ISO/AVC", private=cfg, doc_type="matroska"),
        "clip.avi": avi(f"{root}/clip.avi", units, 128, 96),
    }


@pytest.fixture(scope="module")
def files(clip, tmp_path_factory):
    return layouts(str(tmp_path_factory.mktemp("h264")), *clip)


@pytest.fixture
def jax_reads_ffmpeg(monkeypatch):
    """JAX's sources read through cv2's default (FFmpeg) backend; its own
    FFmpeg-linked native source is off."""
    monkeypatch.setattr(jax_native, "available", lambda: False)


@pytest.mark.parametrize("name", ["clip.mp4", "len2.mp4", "avc3.mp4", "clip.mkv", "clip.avi"])
def test_containers_probe_and_frames_equal_jax(name, files, jax_reads_ffmpeg):
    path = files[name]
    assert probe_video(path) == jax_probe_video(path)
    got, want = list(iterate_frames(path, every=2)), list(jax_iterate_frames(path, every=2))
    assert [i for i, _ in got] == [i for i, _ in want] == list(range(0, 12, 2))
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_one_byte_nal_lengths_equal_cv2(tmp_path):
    """avcC's lengthSizeMinusOne 0: NAL units under 256 bytes."""
    writer = W.Writer(16, 16, seed=3, sps=W.Sps(max_num_ref_frames=1))
    units = [writer.random_picture("IDR", coeff_density=0.1)[0]] + [
        writer.random_picture("P", coeff_density=0.1, mb_kinds=(W.SKIP, W.INTER),
                              sub_partitions=False)[0] for _ in range(3)]
    sps, pps = [s.nal() for s in writer.sps], [p.nal() for p in writer.pps]
    path = write_mp4(str(tmp_path / "l1.mp4"), [W.length_prefixed(u, 1) for u in units], 16, 16,
                     kind=b"avc1", config=W.avcc(sps, pps, 1))
    used = assert_equal_cv2(path, "length 1", count=4)
    assert "length prefixes" in used


@pytest.mark.parametrize("timing", [None, (1, 50), (1001, 60000), (1001, 48000)])
def test_matroska_rate_without_default_duration_equals_jax(timing, tmp_path):
    """Without DefaultDuration FFmpeg takes each H.264 packet's duration from
    the SPS's timing info (rounded down to a tick), or estimates the rate
    from the timestamps (30 frames here: its estimate from fewer differs,
    ROADMAP Queue 3)."""
    writer = W.Writer(32, 32, seed=1, sps=W.Sps(max_num_ref_frames=1, timing=timing))
    units = [writer.random_picture("IDR", coeff_density=0.1)[0]] + [
        writer.random_picture("P", coeff_density=0.1, mb_kinds=(W.SKIP,))[0] for _ in range(29)]
    sps, pps = [s.nal() for s in writer.sps], [p.nal() for p in writer.pps]
    path = write_mkv(str(tmp_path / "t.mkv"), [W.length_prefixed(u) for u in units], 32, 32,
                     codec="V_MPEG4/ISO/AVC", private=W.avcc(sps, pps), doc_type="matroska",
                     default_duration=None, times=[i * 40 for i in range(30)])
    assert probe_video(path) == jax_probe_video(path)


# ---------------------------------------------------------------- surfaces


@pytest.mark.parametrize("name", ["clip.mp4", "clip.avi"])
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


def test_stream_detect_video_equals_jax(files, tmp_path, jax_reads_ffmpeg):
    jax_infer, variables, infer = twin_models()
    port_t, jax_t = transforms()
    kw = dict(thresh=0.0, batch_size=4, every=2, draw=False, save_detections=True)
    path = files["clip.mp4"]
    stats = stream_detect_video(path, infer, port_t, CLASSES, output_dir=str(tmp_path / "port"),
                                device=CPU, **kw)
    want = jax_stream_detect_video(path, jax_infer, variables, jax_t, CLASSES,
                                   output_dir=str(tmp_path / "jax"), **kw)
    assert stats["frames"] == want["frames"] == 6
    assert assert_txt_equal(str(tmp_path / "port" / "clip_det.txt"),
                            str(tmp_path / "jax" / "clip_det.txt")) > 0


def test_stream_detect_videos_h264_mp4_and_vp9_webm_equal_jax(files, tmp_path,
                                                               jax_reads_ffmpeg):
    jax_infer, variables, infer = twin_models()
    port_t, jax_t = transforms()
    webm = vp9_webm(str(tmp_path / "v.webm"), moving_scene(12, 128, 96, seed=6), {"b": 300000})
    paths = [files["clip.mp4"], webm]
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
        main(["--input", files["clip.mkv"], "--output", str(out), "--every", "3"])
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


def test_committed_fixture_equals_its_digests():
    """The card's fixture (``tests/fixtures/make_h264_fixture.py``) decodes
    to the digests OpenCV gave for it, and probes as JAX does."""
    with open(DIGESTS) as f:
        digests = json.load(f)
    got, used = decode_all(VIDEO)
    assert len(got) == len(digests["frames"]) == 48
    for k, ((rgb, y), want) in enumerate(zip(got, digests["frames"])):
        assert hashlib.sha256(y.tobytes()).hexdigest() == want["y"], k
        assert hashlib.sha256(rgb.tobytes()).hexdigest() == want["rgb"], k
    assert {"IDR picture", "P slices", "several slices", "skipped macroblocks"} <= used
    assert probe_video(VIDEO) == {"fps": 25.0, "frame_count": 48, "width": 640, "height": 480}
    assert os.path.getsize(VIDEO) < 1 << 20
