"""H.264 B slices in the port's decoder (``native/h264.cpp``) against
OpenCV's FFmpeg on the CPU, and B-frame H.264 in MP4 / Matroska / AVI on
every surface that reads video against the JAX package.

Every stream is the tests' own writer's (``tests/torch_h264_writer``),
read back both ways: every picture's Y plane and RGB frame equal OpenCV's
bit for bit, in OpenCV's order and number, and the decoder reports the
features the stream claims.  ``STREAMS`` names one stream for each tool, in
CAVLC and in CABAC: spatial and temporal direct prediction (B_Skip,
B_Direct_16x16, B_Direct_8x8), direct prediction without
direct_8x8_inference_flag, explicit weights in P and B slices (also at a
denominator of 7, where FFmpeg's x86 sums saturate), implicit weights (also
beyond both references), reference B pictures in a pyramid, list 1
modification over 4 references, long-term references, several slices with
their deblocking, the 8x8 transform with scaling lists, I_PCM and intra
macroblocks in B slices, B pictures of order count type 2, two IDR
periods with the reorder depth guessed.  Then seeded
random B streams, FFmpeg's output order (the reorder depth the VUI states,
or its guess from the order counts, and the pictures it does not show),
the containers (MP4 with ``ctts`` versions 0 and 1, Matroska, AVI: probes
and frames equal JAX's) and the surfaces against the JAX package, a damaged
B slice, and the card's B-frame fixture against its digests.
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
import viddet_tpu_torch.cli.detect as torch_detect
import viddet_tpu_torch.cli.extract_frames as torch_extract
import viddet_tpu_torch.cli.visualise as torch_visualise
import viddet_tpu_torch.infer.multistream as torch_multistream
from tests import torch_h264_writer as W
from tests.fixtures.make_h264_bframes_fixture import DIGESTS, VIDEO
from tests.fixtures.make_mp4_fixture import moving_scene
from tests.test_torch_h264 import jax_reads_ffmpeg  # noqa: F401
from tests.test_torch_h264 import assert_equal_cv2, avi, decode_all
from tests.test_torch_mp4 import tiny_weights  # noqa: F401
from tests.test_torch_stream import twin_models
from tests.test_torch_video_stream import CLASSES, CPU, _cli, assert_txt_equal, transforms
from tests.torch_mkv_helpers import vp9_webm, write_mkv
from tests.torch_mp4_helpers import cv2_views, write_mp4
from tests.torch_video_helpers import assert_drawn_video
from viddet_tpu.core.precision import FLOAT32_POLICY as JAX_F32
from viddet_tpu.infer.multistream import stream_detect_videos as jax_stream_detect_videos
from viddet_tpu.infer.stream import stream_detect_video as jax_stream_detect_video
from viddet_tpu.utils.video import iterate_frames as jax_iterate_frames
from viddet_tpu.utils.video import probe_video as jax_probe_video
from viddet_tpu_torch.core.precision import FLOAT32_POLICY
from viddet_tpu_torch.infer.stream import FrameSource, NativeFrameSource, stream_detect_video
from viddet_tpu_torch.native import H264Decoder, decode_jpeg, encode_jpeg
from viddet_tpu_torch.native.mp4 import Mp4Reader
from viddet_tpu_torch.utils.video import iterate_frames, probe_video

B = {"B slices", "reordered output"}

# ----------------------------------------------------------------- streams

# B-frame groups after an IDR at order count 0, each (order count step,
# nal_ref_idc, kind) in decoding order: a P picture, then the B pictures
# before it
GROUPS = {"pyramid": [(4, 1, "P"), (2, 1, "B"), (1, 0, "B"), (3, 0, "B")],
          "depth 1": [(2, 1, "P"), (1, 0, "B")],
          "two": [(3, 1, "P"), (1, 0, "B"), (2, 0, "B")],
          "in order": [(1, 1, "P"), (2, 1, "B")]}


def b_stream(w, h, seed, n, *, cabac=0, group="pyramid", restriction=2, nref=3, sps=None,
             pps=None, direct=None, long_term=False, idr_every=0, **kw):
    """An IDR and ``group``'s pictures repeated to ``n`` pictures (a new IDR
    every ``idr_every``); B pictures alternate spatial and temporal direct
    prediction unless ``direct`` fixes it.  Returns the access units."""
    sps = sps or W.Sps(profile=100 if cabac else 77, max_num_ref_frames=nref, poc_type=0,
                       log2_max_poc_lsb=8, restriction=restriction)
    pps = pps or W.Pps(cabac=cabac, num_ref_idx_default=2, num_ref_idx_l1_default=2)
    writer = W.Writer(w, h, seed=seed, sps=sps, pps=pps)
    units = [writer.parameter_sets() + writer.random_picture("IDR", poc={"lsb": 0},
                                                             long_term=long_term, **kw)[0]]
    base, b_count, since = 0, 0, 1
    while len(units) < n:
        if idr_every and since == idr_every:
            units.append(writer.random_picture("IDR", poc={"lsb": 0}, **kw)[0])
            base, since = 0, 1
            continue
        for step, ref_idc, kind in GROUPS[group]:
            if len(units) == n:
                break
            extra = {}
            if kind == "B":
                b_count += 1
                extra["direct_spatial"] = b_count % 2 if direct is None else direct
            units.append(writer.random_picture(kind, poc={"lsb": 2 * (base + step) % 256},
                                               ref_idc=ref_idc, **extra, **kw)[0])
            since += 1
        base += max(step for step, _, _ in GROUPS[group])
    return units


def order_stream(pocs, refs, restriction=None, seed=3):
    """Small pictures of order counts ``pocs`` (units of 2) and
    nal_ref_idc ``refs``, the first an IDR, the rest B."""
    sps = W.Sps(profile=77, poc_type=0, log2_max_poc_lsb=8, max_num_ref_frames=4,
                restriction=restriction)
    writer = W.Writer(32, 32, seed=seed, sps=sps,
                      pps=W.Pps(cabac=1, num_ref_idx_default=1, num_ref_idx_l1_default=1))
    units = [writer.parameter_sets() + writer.random_picture("IDR", poc={"lsb": 0},
                                                             coeff_density=0.2)[0]]
    for i in range(1, len(pocs)):
        units.append(writer.random_picture("B", poc={"lsb": 2 * pocs[i] % 256}, ref_idc=refs[i],
                                           coeff_density=0.2)[0])
    return units


def weighted_pps(cabac, **kw):
    return W.Pps(cabac=cabac, num_ref_idx_default=2, num_ref_idx_l1_default=2, **kw)


def denominator_7(cabac):
    """Explicit weights at denominators of 7, offsets near the top of their
    range: FFmpeg's 16-bit sums saturate (its SIMD blocks)."""
    rng = np.random.default_rng(77)
    pps = weighted_pps(cabac, weighted_pred=1, weighted_bipred=1)
    sps = W.Sps(profile=77, max_num_ref_frames=3, poc_type=0, log2_max_poc_lsb=8, restriction=2)
    writer = W.Writer(80, 64, seed=12, sps=sps, pps=pps)
    units = [writer.parameter_sets() + writer.random_picture("IDR", poc={"lsb": 0})[0]]
    for base in (0, 4, 8, 12):
        for step, ref_idc, kind in GROUPS["pyramid"]:
            table = W.random_weights(rng, (2, 2) if kind == "B" else (2,), (7, 7))
            for rows in table["lists"]:
                for i, (luma, chroma) in enumerate(rows):
                    rows[i] = ((luma[0], int(rng.integers(100, 128))), chroma)
            units.append(writer.random_picture(kind, poc={"lsb": 2 * (base + step)},
                                               ref_idc=ref_idc, weights=table)[0])
    return units


def beyond_references(cabac):
    """Implicit weights of B pictures after both their references (weights
    of 128 and -64)."""
    sps = W.Sps(profile=77, max_num_ref_frames=3, poc_type=0, log2_max_poc_lsb=8, restriction=2)
    writer = W.Writer(96, 64, seed=21, sps=sps, pps=weighted_pps(cabac, weighted_bipred=2))
    units = [writer.parameter_sets() + writer.random_picture("IDR", poc={"lsb": 0})[0]]
    for lsb, ref_idc, kind in ((2, 1, "P"), (4, 1, "B"), (6, 1, "B"), (12, 1, "P"),
                               (8, 1, "B"), (10, 0, "B"), (14, 0, "B"), (16, 0, "B")):
        units.append(writer.random_picture(kind, poc={"lsb": lsb}, ref_idc=ref_idc,
                                           mb_kinds=(W.INTER, W.SKIP), sub_partitions=False,
                                           off_frame=0.0)[0])
    return units


def poc_type_2(cabac):
    """B pictures that are references, in decoding order (order count type 2)."""
    sps = W.Sps(profile=77, max_num_ref_frames=2, poc_type=2)
    writer = W.Writer(64, 48, seed=14, sps=sps, pps=weighted_pps(cabac))
    units = [writer.parameter_sets() + writer.random_picture("IDR")[0]]
    units += [writer.random_picture("B" if i % 2 else "P", direct_spatial=i % 4 == 1)[0]
              for i in range(1, 12)]
    return units


SCALING = [[12 + i // 2 for i in range(16)], None, "default", None, None, None,
           [14 + i // 4 for i in range(64)], "default"]

STREAMS = {
    "spatial direct": (lambda c: b_stream(64, 48, 1, 17, cabac=c, direct=1), 64, 48,
                       B | {"spatial direct", "B_Skip", "B_Direct_16x16", "B_Direct_8x8",
                            "B_8x8", "bi-prediction", "reference B pictures"}),
    "temporal direct": (lambda c: b_stream(64, 48, 2, 13, cabac=c, direct=0), 64, 48,
                        B | {"temporal direct", "B_Skip", "B_Direct_16x16", "B_Direct_8x8"}),
    "direct 4x4": (lambda c: b_stream(80, 64, 11, 13, cabac=c, sps=W.Sps(
        profile=77, max_num_ref_frames=3, poc_type=0, log2_max_poc_lsb=8, restriction=2,
        direct_8x8_inference=0)), 80, 64, B | {"direct 4x4", "spatial direct",
                                               "temporal direct"}),
    "explicit weights": (lambda c: b_stream(64, 48, 4, 13, cabac=c, pps=weighted_pps(
        c, weighted_pred=1, weighted_bipred=1)), 64, 48, B | {"explicit weights", "P slices"}),
    "explicit weights at denominator 7": (denominator_7, 80, 64, B | {"explicit weights"}),
    "implicit weights": (lambda c: b_stream(64, 48, 5, 13, cabac=c, pps=weighted_pps(
        c, weighted_bipred=2)), 64, 48, B | {"implicit weights"}),
    "implicit weights beyond both references": (beyond_references, 96, 64,
                                                B | {"implicit weights"}),
    "list 1 modification, 4 references": (lambda c: b_stream(
        64, 48, 6, 17, cabac=c, nref=4, modify=True, pps=W.Pps(
            cabac=c, num_ref_idx_default=3, num_ref_idx_l1_default=3)), 64, 48,
        B | {"list 1 modification", "several references"}),
    "long-term references": (lambda c: b_stream(64, 48, 17, 9, cabac=c, group="depth 1",
                                                long_term=True), 64, 48,
                             B | {"long-term references", "temporal direct"}),
    "slices and deblocking": (lambda c: b_stream(96, 64, 8, 9, cabac=c, slices=3,
                                                 deblock="offsets"), 96, 64,
                              B | {"several slices", "deblocking offsets"}),
    "8x8 transform and scaling lists": (lambda c: b_stream(64, 48, 9, 9, cabac=c, sps=W.Sps(
        profile=100, max_num_ref_frames=3, poc_type=0, log2_max_poc_lsb=8, restriction=2),
        pps=W.Pps(cabac=c, transform_8x8=1, scaling=1, lists=SCALING, num_ref_idx_default=2,
                  num_ref_idx_l1_default=2)), 64, 48,
        B | {"8x8 transform", "PPS scaling matrices"}),
    "I_PCM and intra in B": (lambda c: b_stream(64, 48, 10, 9, cabac=c, pcm=0.1,
                                                mb_kinds=(W.I4, W.I16, W.INTER)), 64, 48,
                             B | {"I_PCM", "intra in B slices"}),
    "order count type 2": (poc_type_2, 64, 48, {"B slices", "POC type 2",
                                                  "reference B pictures"}),
    "two IDR periods, the depth guessed": (lambda c: b_stream(
        64, 48, 18, 17, cabac=c, idr_every=8, restriction=None), 64, 48, B | {"IDR picture"}),
}


@pytest.mark.parametrize("cabac", [0, 1], ids=["CAVLC", "CABAC"])
@pytest.mark.parametrize("name", STREAMS)
def test_streams_equal_cv2_bit_for_bit(name, cabac, tmp_path):
    make, w, h, features = STREAMS[name]
    units = make(cabac)
    path = avi(str(tmp_path / "b.avi"), units, w, h)
    used = assert_equal_cv2(path, name, features | ({"CABAC"} if cabac else set()),
                            count=len(units))
    assert ("CABAC" in used) == bool(cabac)


def random_b(seed, n=9):
    """A seeded random B stream mixing the sequence's options: CAVLC or
    CABAC, Main or High (the 8x8 transform), direct_8x8_inference_flag, the
    group of pictures, references, weights, slices, deblocking, QP ranges."""
    rng = np.random.default_rng(7000 + seed)
    cabac, high = seed % 2, bool(rng.random() < 0.5)
    nref = int(rng.integers(2, 5))
    sps = W.Sps(profile=100 if high else 77, max_num_ref_frames=nref, poc_type=0,
                log2_max_poc_lsb=8, restriction=int(rng.integers(2, 4)),
                direct_8x8_inference=int(high or rng.random() < 0.5))
    pps = W.Pps(cabac=cabac, transform_8x8=int(high and rng.random() < 0.7),
                num_ref_idx_default=int(rng.integers(1, nref + 1)),
                num_ref_idx_l1_default=int(rng.integers(1, nref + 1)),
                weighted_pred=int(rng.random() < 0.3),
                weighted_bipred=int(rng.integers(0, 3)), cb_offset=int(rng.integers(-6, 7)),
                init_qp=int(rng.integers(16, 40)), constrained_intra=int(rng.random() < 0.2))
    lo = int(rng.integers(10, 40))
    w, h = [(48, 32), (64, 48), (32, 64)][seed % 3]
    kw = dict(slices=int(rng.integers(1, 3)), deblock=[None, "off", "slices", "offsets"][seed % 4],
              qp_range=(lo, lo + int(rng.integers(0, 12))), pcm=0.03, off_frame=0.2,
              modify=bool(rng.random() < 0.4))
    group = ["pyramid", "depth 1", "two", "in order"][int(rng.integers(0, 4))]
    return b_stream(w, h, seed, n, cabac=cabac, group=group, nref=nref, sps=sps, pps=pps,
                    **kw), w, h


RANDOM_SEEDS = range(12)


@pytest.mark.parametrize("seed", RANDOM_SEEDS)
def test_random_b_streams_equal_cv2(seed, tmp_path):
    units, w, h = random_b(seed)
    path = avi(str(tmp_path / "r.avi"), units, w, h)
    assert_equal_cv2(path, f"seed {seed}", {"B slices"}, count=len(units))


# -------------------------------------------------------------- output order

ORDER_CASES = {
    # without bitstream_restriction FFmpeg guesses the depth: its stream probe
    # decodes the first pictures, and a picture out of order later raises it
    # (and the pictures that come too late are not shown)
    "guessed, depth 1": ([0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9], [1, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0],
                         None),
    "guessed, pyramid": ([0, 4, 2, 1, 3, 8, 6, 5, 7, 12, 10, 9, 11], [1, 1, 1, 0, 0] * 3, None),
    "guessed, deeper after the probe": ([0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 14, 12, 11, 13, 18,
                                         16, 15, 17], [1, 1, 0] * 3 + [1, 0] + [1, 1, 0, 0] * 2,
                                        None),
    # with it the depth is stated, and a deeper stream loses pictures
    "stated 0, depth 1": ([0, 2, 1, 4, 3, 6, 5], [1, 1, 0, 1, 0, 1, 0], 0),
    "stated 1, pyramid": ([0, 4, 2, 1, 3, 8, 6, 5, 7], [1, 1, 1, 0, 0, 1, 1, 0, 0], 1),
    "stated 2, pyramid": ([0, 4, 2, 1, 3, 8, 6, 5, 7], [1, 1, 1, 0, 0, 1, 1, 0, 0], 2),
    "B pictures in decoding order": ([0, 1, 2, 3, 4, 5, 6, 7], [1] * 8, None),
}


@pytest.mark.parametrize("case", ORDER_CASES)
def test_output_order_equals_cv2(case, tmp_path):
    """Which pictures FFmpeg shows, and in what order, through every
    reader: MP4 (its depth starts at what ``ctts`` implies), Matroska and
    AVI (their depth starts at 0)."""
    pocs, refs, restriction = ORDER_CASES[case]
    units = order_stream(pocs, refs, restriction)
    writer_sets = units[0][:2]
    display = sorted(range(len(pocs)), key=lambda k: pocs[k])
    rank = [display.index(k) for k in range(len(pocs))]
    delay = max(k - rank[k] for k in range(len(pocs)))
    vcl = [W.length_prefixed([u for u in unit if u[0] & 31 not in (7, 8)]) for unit in units]
    cfg = W.avcc([writer_sets[0]], [writer_sets[1]])
    paths = [avi(str(tmp_path / "o.avi"), units, 32, 32),
             write_mp4(str(tmp_path / "o.mp4"), vcl, 32, 32, kind=b"avc1", config=cfg,
                       ctts=[(rank[k] + delay - k) * 512 for k in range(len(pocs))],
                       edits=[(len(pocs) * 40, delay * 512, 1)]),
             write_mkv(str(tmp_path / "o.mkv"), vcl, 32, 32, codec="V_MPEG4/ISO/AVC",
                       private=cfg, doc_type="matroska", times=[40 * r for r in rank])]
    for path in paths:
        want = cv2_views(path, "bgr")
        got = [f for _, f in iterate_frames(path)]
        assert len(got) == len(want), (path, len(got), len(want))
        for k, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(g, w[..., ::-1], err_msg=f"{path} frame {k}")


@pytest.mark.parametrize("restriction", [None, 1, 2])
def test_mmco_5_between_b_pyramids_equals_cv2(restriction, tmp_path):
    """A P picture after a pyramid, shown after it, with memory management
    operation 5: the order counts start again, and FFmpeg's output (and the
    pictures it drops at a stated depth of 1) is cv2's."""
    sps = W.Sps(profile=77, max_num_ref_frames=3, poc_type=0, log2_max_poc_lsb=8,
                restriction=restriction)
    writer = W.Writer(32, 32, seed=2, sps=sps,
                      pps=W.Pps(cabac=1, num_ref_idx_default=2, num_ref_idx_l1_default=2))
    units = [writer.parameter_sets() + writer.random_picture("IDR", poc={"lsb": 0},
                                                             coeff_density=0.2)[0]]
    base = 0
    for group in range(6):
        for step, ref_idc, kind in GROUPS["pyramid"]:
            units.append(writer.random_picture(kind, poc={"lsb": 2 * (base + step)},
                                               ref_idc=ref_idc, coeff_density=0.2)[0])
        base += 4
        if group in (1, 3):
            units.append(writer.random_picture("P", poc={"lsb": 2 * (base + 1)}, mmco=[(5,)],
                                               coeff_density=0.2)[0])
            base = 0
    path = avi(str(tmp_path / "m.avi"), units, 32, 32)
    used = assert_equal_cv2(path, "MMCO 5", {"MMCO 5", "B slices"},
                            count=21 if restriction == 1 else 27)
    assert ("pictures not shown" in used) == (restriction == 1)


def test_dropped_pictures_are_named_in_the_features(tmp_path):
    pocs, refs, restriction = ORDER_CASES["stated 1, pyramid"]
    path = avi(str(tmp_path / "d.avi"), order_stream(pocs, refs, restriction), 32, 32)
    got, used = decode_all(path)
    assert len(got) == len(cv2_views(path, "bgr")) < len(pocs)
    assert "pictures not shown" in used


# -------------------------------------------------------------- containers


@pytest.fixture(scope="module")
def bclip():
    """A 12-frame B pyramid (CABAC) at 128x96: its access units, each's
    display index, and the parameter sets."""
    sps = W.Sps(profile=100, max_num_ref_frames=3, poc_type=0, log2_max_poc_lsb=8,
                restriction=2)
    pps = W.Pps(cabac=1, transform_8x8=1, num_ref_idx_default=2, num_ref_idx_l1_default=2,
                weighted_bipred=2)
    units = b_stream(128, 96, 31, 12, sps=sps, pps=pps, coeff_density=0.3)
    display = [0, 4, 2, 1, 3, 8, 6, 5, 7, 11, 10, 9]  # b_stream's pyramid, cut at 12
    return units, display, [units[0][0]], [units[0][1]]


def b_layouts(root, units, display, sps, pps):
    vcl = [W.length_prefixed([u for u in unit if u[0] & 31 not in (7, 8)]) for unit in units]
    cfg = W.avcc(sps, pps)
    delay = max(k - d for k, d in enumerate(display))
    return {
        "ctts0.mp4": write_mp4(f"{root}/ctts0.mp4", vcl, 128, 96, kind=b"avc1", config=cfg,
                               ctts=[(d + delay - k) * 512 for k, d in enumerate(display)],
                               edits=[(480, delay * 512, 1)]),
        "ctts1.mp4": write_mp4(f"{root}/ctts1.mp4", vcl, 128, 96, kind=b"avc1", config=cfg,
                               ctts=[(d - k) * 512 for k, d in enumerate(display)],
                               ctts_version=1),
        "clip.mkv": write_mkv(f"{root}/clip.mkv", vcl, 128, 96, codec="V_MPEG4/ISO/AVC",
                              private=cfg, doc_type="matroska", times=[40 * d for d in display]),
        "clip.avi": avi(f"{root}/clip.avi", units, 128, 96),
    }


@pytest.fixture(scope="module")
def bfiles(bclip, tmp_path_factory):
    return b_layouts(str(tmp_path_factory.mktemp("hb")), *bclip)


@pytest.mark.parametrize("name", ["ctts0.mp4", "ctts1.mp4", "clip.mkv", "clip.avi"])
def test_containers_probe_and_frames_equal_jax(name, bfiles, jax_reads_ffmpeg):  # noqa: F811
    path = bfiles[name]
    assert probe_video(path) == jax_probe_video(path)
    got, want = list(iterate_frames(path, every=2)), list(jax_iterate_frames(path, every=2))
    assert [i for i, _ in got] == [i for i, _ in want] == list(range(0, 12, 2))
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert_equal_cv2(path, name, B | {"implicit weights"}, count=12)


@pytest.mark.parametrize("timing", [None, (1, 50)])
def test_matroska_rate_without_default_duration_equals_jax(timing, tmp_path,
                                                          jax_reads_ffmpeg):  # noqa: F811
    """Without DefaultDuration the rate comes from the SPS's timing or the
    blocks' timestamps, which B-frames put out of decoding order (30
    frames: FFmpeg's estimate from fewer differs, ROADMAP Queue 3)."""
    sps = W.Sps(profile=77, max_num_ref_frames=3, poc_type=0, log2_max_poc_lsb=8, restriction=2,
                timing=timing)
    units = b_stream(32, 32, 5, 30, sps=sps, coeff_density=0.1)
    pocs = [0] + [base + step for base in range(0, 32, 4) for step in (4, 2, 1, 3)][:29]
    rank = [sorted(range(30), key=lambda k: pocs[k]).index(k) for k in range(30)]
    vcl = [W.length_prefixed([u for u in unit if u[0] & 31 not in (7, 8)]) for unit in units]
    path = write_mkv(str(tmp_path / "t.mkv"), vcl, 32, 32, codec="V_MPEG4/ISO/AVC",
                     private=W.avcc([units[0][0]], [units[0][1]]), doc_type="matroska",
                     default_duration=None, times=[40 * r for r in rank])
    assert probe_video(path) == jax_probe_video(path)


@pytest.mark.parametrize("name", ["ctts0.mp4", "clip.mkv"])
def test_native_batches_equal_frame_source_batches(name, bfiles):
    port_t, _ = transforms()
    for every in (1, 5):
        native = list(NativeFrameSource(bfiles[name], (64, 64), every=every, normalize=False))
        thread = list(FrameSource(bfiles[name], port_t, every=every))
        assert len(native) == len(thread) == len(range(0, 12, every))
        for g, w in zip(native, thread):
            assert g[0] == w[0]
            np.testing.assert_array_equal(g[2], w[2])
            np.testing.assert_array_equal(g[3], w[3])


def test_stream_detect_video_equals_jax(bfiles, tmp_path, jax_reads_ffmpeg):  # noqa: F811
    jax_infer, variables, infer = twin_models()
    port_t, jax_t = transforms()
    kw = dict(thresh=0.0, batch_size=4, every=2, draw=False, save_detections=True)
    path = bfiles["ctts0.mp4"]
    stats = stream_detect_video(path, infer, port_t, CLASSES, output_dir=str(tmp_path / "port"),
                                device=CPU, **kw)
    want = jax_stream_detect_video(path, jax_infer, variables, jax_t, CLASSES,
                                   output_dir=str(tmp_path / "jax"), **kw)
    assert stats["frames"] == want["frames"] == 6
    assert assert_txt_equal(str(tmp_path / "port" / "ctts0_det.txt"),
                            str(tmp_path / "jax" / "ctts0_det.txt")) > 0


def test_stream_detect_videos_equal_jax(bfiles, tmp_path, jax_reads_ffmpeg):  # noqa: F811
    jax_infer, variables, infer = twin_models()
    port_t, jax_t = transforms()
    webm = vp9_webm(str(tmp_path / "v.webm"), moving_scene(12, 128, 96, seed=6), {"b": 300000})
    paths = [bfiles["clip.mkv"], bfiles["clip.avi"], webm]
    kw = dict(thresh=0.0, batch_size=4, k=1, draw=False, save_detections=True)
    stats = torch_multistream.stream_detect_videos(paths, infer, port_t, CLASSES,
                                                   output_dir=str(tmp_path / "port"),
                                                   device=CPU, **kw)
    want = jax_stream_detect_videos(paths, jax_infer, variables, jax_t, CLASSES,
                                    output_dir=str(tmp_path / "jax"), **kw)
    assert stats["per_stream"] == want["per_stream"]
    assert sum(stats["per_stream"].values()) == 36


def test_extract_frames_equals_jax_and_visualise_reads_them(bfiles, tmp_path,
                                                           jax_reads_ffmpeg):  # noqa: F811
    """``extract_frames`` over the B-frame MP4 equals JAX's; ``visualise
    --images --video`` then writes the frames back as a video, in order."""
    port, jax_out = tmp_path / "port", tmp_path / "jax"
    for main, out in ((torch_extract.main, port), (jax_extract.main, jax_out)):
        main(["--input", bfiles["ctts1.mp4"], "--output", str(out), "--every", "3"])
    names = sorted(os.listdir(port))
    assert names == sorted(os.listdir(jax_out)) and len(names) == 4
    for f in names:
        assert (port / f).read_bytes() == (jax_out / f).read_bytes(), f
    out = tmp_path / "vis"
    assert torch_visualise.main(["--images", str(port), "--output", str(out), "--video",
                                 "v.avi", "--fps", "25"]) == 4
    decoded = [f for _, f in iterate_frames(bfiles["ctts1.mp4"], every=3)]
    images = [decode_jpeg((port / f).read_bytes()) for f in names]
    for image, frame in zip(images, decoded):
        np.testing.assert_array_equal(image, decode_jpeg(encode_jpeg(frame, 95)))
    assert_drawn_video(str(out / "v.avi"), images, 25)


def test_detect_cli_mp4_equals_jax(bfiles, tiny_weights, tmp_path, monkeypatch,  # noqa: F811
                                   jax_reads_ffmpeg):  # noqa: F811
    monkeypatch.setattr(jax_detect, "build_model",
                        functools.partial(jax_detect.build_model, policy=JAX_F32))
    monkeypatch.setattr(torch_detect, "build_model",
                        functools.partial(torch_detect.build_model, policy=FLOAT32_POLICY))
    monkeypatch.setenv("VIDDET_PAIR_TOPK", "det")
    jax.clear_caches()
    path = bfiles["ctts0.mp4"]
    done = _cli(torch_detect.main, path, str(tmp_path / "port"), tiny_weights, "--no-draw")
    _cli(jax_detect.main, path, str(tmp_path / "jax"), tiny_weights, "--no-draw")
    assert done == 12
    assert assert_txt_equal(str(tmp_path / "port" / "ctts0_det.txt"),
                            str(tmp_path / "jax" / "ctts0_det.txt")) > 0


@pytest.mark.parametrize("damage", ["truncated", "flipped"])
def test_damaged_b_slice_raises_after_the_frames_before_it(damage, tmp_path):
    """FFmpeg conceals a damaged slice; the port raises naming the file and
    the sample, after the pictures shown before it, through both readers."""
    units = b_stream(64, 48, 41, 9, group="depth 1", restriction=1)
    slices = [u for u in units[4] if u[0] & 31 == 1]  # a B picture, decoded fifth
    if damage == "truncated":
        units[4] = [slices[0][: len(slices[0]) // 3]]
    else:
        units[4] = [slices[0][:6] + bytes(c ^ 0xFF for c in slices[0][6:])]
    path = avi(str(tmp_path / "d.avi"), units, 64, 48)
    frames = []
    with pytest.raises(ValueError, match=f"{path} frame 4: H.264 decode: "):
        for i, _ in iterate_frames(path):
            frames.append(i)
    assert frames == [0, 1, 2]  # depth 1: shown up to the picture before the last decoded
    got = []
    with pytest.raises(ValueError, match=f"{path}: frame 4: "):
        for i, _, _, _ in NativeFrameSource(path, (32, 32)):
            got.append(i)
    assert got == [0, 1, 2]


# ----------------------------------------------------------- card fixture


def test_committed_fixture_equals_its_digests():
    """The card's B-frame fixture (``tests/fixtures/make_h264_bframes_fixture.py``)
    decodes to the digests OpenCV gave for it, and probes as JAX does."""
    with open(DIGESTS) as f:
        digests = json.load(f)
    got, used = decode_all(VIDEO)
    assert len(got) == len(digests["frames"]) == 48
    for k, ((rgb, y), want) in enumerate(zip(got, digests["frames"])):
        assert hashlib.sha256(y.tobytes()).hexdigest() == want["y"], k
        assert hashlib.sha256(rgb.tobytes()).hexdigest() == want["rgb"], k
    assert {"B slices", "spatial direct", "temporal direct", "explicit weights",
            "implicit weights", "reference B pictures", "reordered output",
            "bitstream restriction"} <= used
    assert probe_video(VIDEO) == jax_probe_video(VIDEO) == {
        "fps": 25.0, "frame_count": 48, "width": 640, "height": 480}
    with Mp4Reader(VIDEO) as video:
        assert video.index.reorder == 2
    assert os.path.getsize(VIDEO) < 1 << 20


def test_decoder_flush_gives_the_waiting_pictures_in_order(tmp_path):
    """``H264Decoder.decode`` holds pictures while the depth needs and
    ``flush`` gives the rest by order count, then None."""
    units = order_stream([0, 4, 2, 1, 3], [1, 1, 1, 0, 0], 2)
    decoder = H264Decoder(b"", "flush")
    shown = [decoder.decode(W.annexb(u), rgb=False) for u in units]
    assert shown == [None, None, True, True, True]
    assert [decoder.flush(rgb=False), decoder.flush(rgb=False), decoder.flush()] == [
        True, True, None]
    decoder.close()
