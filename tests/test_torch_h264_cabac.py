"""The port's H.264 decoder on Main and High streams (CABAC, the 8x8
transform with intra 8x8 prediction, SPS / PPS scaling matrices) against
OpenCV's FFmpeg on the CPU, and CABAC H.264 in MP4 / Matroska / AVI on every
surface that reads video against the JAX package.

As in ``tests/test_torch_h264.py`` every stream is written by the tests' own
writer (``tests/torch_h264_writer``) and read back both ways: every
picture's Y plane (``CAP_PROP_CONVERT_RGB`` 0) and RGB frame equal OpenCV's
bit for bit, and the decoder reports the features the stream claims
(``STREAMS``): CABAC I only and I / P, several slices with their own
cabac_init_idc and QP, I_PCM inside CABAC slices, skip runs across slice
edges, constrained intra, QP 0 and 51 and the mb_qp_delta extremes, 4 and 16
references with list modification, I_8x8 in every mode next to every
availability, 8x8 inter residuals under both coders, CAVLC High with the 8x8
transform, SPS and PPS lists with the default-list escape and fall-back
rules A and B, a profile-77 and a profile-100 stream.  Then 24 seeded
random-syntax CABAC streams, the check that they reach every context
variable I / P frame coding can use, the containers (MP4 ``avc1`` at NAL
length sizes 1, 2 and 4, ``avc3``, Matroska, AVI; probes and frames equal
JAX's), the surfaces against the JAX package, and the card's CABAC fixture
against its digests.
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
from tests import torch_h264_writer as W
from tests.fixtures.make_h264_cabac_fixture import DIGESTS, VIDEO
from tests.fixtures.make_h264_cabac_fixture import parameter_sets as fixture_sets
from tests.fixtures.make_h264_fixture import plain_stream
from tests.fixtures.make_mp4_fixture import moving_scene
from tests.test_torch_h264 import jax_reads_ffmpeg  # noqa: F401
from tests.test_torch_h264 import assert_equal_cv2, avi, decode_all, layouts, stream
from tests.test_torch_mp4 import tiny_weights  # noqa: F401
from tests.test_torch_stream import twin_models
from tests.test_torch_video_stream import CLASSES, CPU, _cli, assert_txt_equal, transforms
from tests.torch_mp4_helpers import write_mp4
from viddet_tpu.core.precision import FLOAT32_POLICY as JAX_F32
from viddet_tpu.infer.stream import stream_detect_video as jax_stream_detect_video
from viddet_tpu.utils.video import iterate_frames as jax_iterate_frames
from viddet_tpu.utils.video import probe_video as jax_probe_video
from viddet_tpu_torch.core.precision import FLOAT32_POLICY
from viddet_tpu_torch.infer.stream import stream_detect_video
from viddet_tpu_torch.native import H264_CONTEXTS, H264Decoder
from viddet_tpu_torch.utils.video import iterate_frames, probe_video

MAIN, HIGH = W.Sps(profile=77), W.Sps(profile=100)
CABAC = {"CABAC"}
BASE = {"IDR picture", "P slices", "CABAC"}


def cabac(**kw):
    return W.Pps(cabac=1, **kw)


def high(**kw):
    return W.Sps(profile=100, **kw)


def refs_stream(w, h, seed, n, nref, log2_frame_num=4, **kw):
    sps = high(max_num_ref_frames=nref, log2_max_frame_num=log2_frame_num)
    writer = W.Writer(w, h, seed=seed, sps=sps,
                      pps=cabac(num_ref_idx_default=nref, transform_8x8=1))
    units = [writer.parameter_sets() + writer.random_picture("IDR")[0]]
    for _ in range(1, n):
        units.append(writer.random_picture("P", modify=bool(writer.rng.random() < 0.5),
                                           **kw)[0])
    return units


def slices_stream(w, h, seed, n):
    """Four slices a picture, each with its own QP and cabac_init_idc (all
    three in each P picture)."""
    writer = W.Writer(w, h, seed=seed, sps=MAIN, pps=cabac())
    units = [writer.parameter_sets() + writer.random_picture("IDR", slices=4, qp_range=(10, 40))[0]]
    for i in range(1, n):
        units.append(writer.random_picture("P", slices=4, qp_range=(10, 40),
                                           cabac_init_idc=(i - 1) % 3)[0])
    return units


def lists(rng, count, sent=1.0, default=0.0):
    """``count`` scaling lists: sent (scan order, 4-64), default or absent."""
    out = []
    for i in range(count):
        r = rng.random()
        n = 16 if i < 6 else 64
        out.append([int(v) for v in rng.integers(4, 64, n)] if r < sent else
                   "default" if r < sent + default else None)
    return out


def scaling_stream(seed, sps_lists, pps_lists, n=4):
    rng = np.random.default_rng(seed)
    sps = high(scaling=int(sps_lists is not None),
               lists=lists(rng, 8, *sps_lists) if sps_lists else None)
    pps = cabac(transform_8x8=1, scaling=int(pps_lists is not None),
                lists=lists(rng, 8, *pps_lists) if pps_lists else None)
    return stream(64, 48, seed, n, sps=sps, pps=pps, qp_range=(15, 35))


def every_intra8(seed):
    """I pictures of I_8x8 only, in slices, with constrained intra in P
    pictures of every kind: the writer picks each block's mode among those
    its samples allow."""
    writer = W.Writer(64, 64, seed=seed, sps=high(max_num_ref_frames=1),
                      pps=cabac(transform_8x8=1, constrained_intra=1))
    units = [writer.parameter_sets() + writer.random_picture(
        "IDR", mb_kinds=(W.I4,), transform_8x8=1.0, slices=3)[0]]
    infos = []
    for i in range(1, 8):
        kind = "I" if i % 2 else "P"
        unit, info = writer.random_picture(kind, mb_kinds=(W.I4, W.INTER, W.SKIP) if kind == "P"
                                           else (W.I4,), transform_8x8=1.0, slices=2)
        units.append(unit)
        infos.append(info)
    return units, infos


# name: (access units, width, height, the features the stream must use)
STREAMS = {
    "CABAC I only": (lambda: stream(64, 48, 31, 4, sps=MAIN, pps=cabac(),
                                    kinds={1: "I", 2: "I", 3: "IDR"}, mb_kinds=(W.I4, W.I16)),
                     64, 48, CABAC | {"IDR picture", "non-IDR I picture", "intra 4x4",
                                      "intra 16x16"}),
    "CABAC I / P": (lambda: stream(64, 48, 32, 6, sps=MAIN, pps=cabac()), 64, 48,
                    BASE | {"P 16x16", "P 16x8", "P 8x16", "P_8x8", "8x4 sub-partitions",
                            "4x8 sub-partitions", "4x4 sub-partitions", "skipped macroblocks",
                            "intra in P slices", "quarter-sample vectors",
                            "vectors off the frame"}),
    "slices, cabac_init_idc 0-2 and QPs": (lambda: slices_stream(64, 48, 33, 4), 64, 48,
                                           BASE | {"several slices", "QP deltas"}),
    "I_PCM in CABAC": (lambda: stream(64, 48, 34, 4, sps=MAIN, pps=cabac(), pcm=0.25, slices=2),
                       64, 48, BASE | {"I_PCM", "I_PCM in CABAC", "several slices"}),
    "skip runs across slice edges": (lambda: stream(64, 48, 35, 5, sps=MAIN, pps=cabac(),
                                                    slices=3, mb_kinds=(W.SKIP, W.SKIP, W.INTER),
                                                    coeff_density=0.2), 64, 48,
                                     BASE | {"skipped macroblocks", "several slices"}),
    "constrained intra": (lambda: stream(64, 48, 36, 5, sps=HIGH,
                                         pps=cabac(constrained_intra=1, transform_8x8=1),
                                         slices=2), 64, 48,
                          BASE | {"constrained intra", "intra in P slices", "intra 8x8"}),
    "QP 0-3, mb_qp_delta extremes": (lambda: stream(48, 32, 37, 4, sps=MAIN,
                                                    pps=cabac(init_qp=0), qp_range=(0, 3)),
                                     48, 32, BASE | {"QP deltas"}),
    "QP 48-51": (lambda: stream(48, 32, 38, 4, sps=MAIN, pps=cabac(init_qp=51),
                                qp_range=(48, 51)), 48, 32, BASE | {"QP deltas"}),
    "QP 0-51": (lambda: stream(48, 32, 39, 5, sps=MAIN, pps=cabac(), qp_range=(0, 51)), 48, 32,
                BASE | {"QP deltas"}),
    "4 references": (lambda: refs_stream(48, 32, 40, 10, 4), 48, 32,
                     BASE | {"several references", "reference list modification"}),
    "16 references": (lambda: refs_stream(32, 32, 41, 22, 16, log2_frame_num=5), 32, 32,
                      BASE | {"several references", "reference list modification"}),
    "8x8 inter residual, CABAC": (lambda: stream(64, 48, 42, 5, sps=HIGH,
                                                 pps=cabac(transform_8x8=1), transform_8x8=1.0,
                                                 mb_kinds=(W.INTER, W.SKIP)), 64, 48,
                                  BASE | {"8x8 transform"}),
    "8x8 inter residual, CAVLC": (lambda: stream(64, 48, 43, 5, sps=HIGH,
                                                 pps=W.Pps(transform_8x8=1), transform_8x8=1.0,
                                                 mb_kinds=(W.INTER, W.SKIP)), 64, 48,
                                  {"IDR picture", "P slices", "8x8 transform"}),
    "CAVLC High with the 8x8 transform": (lambda: stream(64, 48, 44, 5, sps=HIGH,
                                                         pps=W.Pps(transform_8x8=1),
                                                         slices=2, pcm=0.05), 64, 48,
                                          {"IDR picture", "P slices", "8x8 transform",
                                           "intra 8x8", "intra 4x4", "High profile"}),
    "SPS lists": (lambda: scaling_stream(45, (1.0, 0.0), None), 64, 48,
                  BASE | {"SPS scaling matrices", "8x8 transform"}),
    "PPS lists": (lambda: scaling_stream(46, None, (1.0, 0.0)), 64, 48,
                  BASE | {"PPS scaling matrices", "8x8 transform"}),
    "default-list escapes": (lambda: scaling_stream(47, (0.0, 1.0), (0.3, 0.7)), 64, 48,
                             BASE | {"SPS scaling matrices", "PPS scaling matrices",
                                     "default scaling lists"}),
    "fall-back rule A": (lambda: scaling_stream(48, (0.4, 0.0), None), 64, 48,
                         BASE | {"SPS scaling matrices", "default scaling lists",
                                 "scaling fall-back"}),
    "fall-back rule A in the PPS": (lambda: scaling_stream(49, None, (0.4, 0.0)), 64, 48,
                                    BASE | {"PPS scaling matrices", "default scaling lists",
                                            "scaling fall-back"}),
    "fall-back rule B": (lambda: scaling_stream(50, (1.0, 0.0), (0.3, 0.0)), 64, 48,
                         BASE | {"SPS scaling matrices", "PPS scaling matrices",
                                 "scaling fall-back"}),
    "profile 77 Main": (lambda: stream(64, 48, 51, 5, sps=MAIN, pps=cabac(), slices=2,
                                       deblock="offsets"), 64, 48,
                        BASE | {"several slices", "deblocking offsets"}),
    "profile 100 High": (lambda: stream(64, 48, 52, 5, sps=HIGH,
                                        pps=cabac(transform_8x8=1, cb_offset=3, cr_offset=-4),
                                        slices=2, deblock="slices", pcm=0.05), 64, 48,
                         BASE | {"High profile", "8x8 transform", "intra 8x8",
                                 "second chroma QP offset", "deblocking within slices"}),
}


@pytest.mark.parametrize("name", STREAMS)
def test_frames_equal_cv2_bit_for_bit(name, tmp_path):
    build, w, h, features = STREAMS[name]
    units = build()
    path = avi(str(tmp_path / "v.avi"), units, w, h)
    assert_equal_cv2(path, name, features, count=len(units))
    info = probe_video(path)
    assert (info["width"], info["height"], info["frame_count"]) == (w, h, len(units))


def test_intra8_every_mode_and_availability(tmp_path):
    """I_8x8 blocks in all nine modes, next to blocks of every (left, top)
    availability and with the top-right both there and not, equal cv2."""
    units, infos = every_intra8(53)
    modes, avail = set(), set()
    for info in infos:
        state = info["state"]
        for addr, kind in enumerate(state.kind):
            if kind != W.I8:
                continue
            mx, my = addr % state.mb_w, addr // state.mb_w
            for n in range(4):
                a = state.i8_available(mx, my, n)
                modes.add(int(state.modes[my * 4 + (n >> 1) * 2, mx * 4 + (n & 1) * 2]))
                avail.add(a)
    assert modes == set(range(9))
    assert {(l, t) for l, t, _, _ in avail} == {(False, False), (False, True), (True, False),
                                               (True, True)}
    assert {tr for _, t, _, tr in avail if t} == {False, True}
    path = avi(str(tmp_path / "i8.avi"), units, 64, 64)
    assert_equal_cv2(path, "intra 8x8", CABAC | {"intra 8x8", "constrained intra"},
                     count=len(units))


def test_qp_delta_extremes_equal_cv2(tmp_path, monkeypatch):
    """mb_qp_delta at both ends of its range (-26 and +25) in CABAC, the
    QP reaching 0 and 51."""
    deltas = []
    write = W.PictureState.qp_delta
    monkeypatch.setattr(W.PictureState, "qp_delta",
                        lambda self, b, delta: deltas.append(delta) or write(self, b, delta))
    units = stream(64, 48, 57, 6, sps=MAIN, pps=cabac(), qp_range=(0, 51), coeff_density=0.3)
    assert {-26, 25} <= set(deltas)
    path = avi(str(tmp_path / "q.avi"), units, 64, 48)
    assert_equal_cv2(path, "mb_qp_delta extremes", BASE | {"QP deltas"}, count=len(units))


def random_cabac(seed, n=7):
    """A seeded random-syntax CABAC stream mixing the sequence's options:
    Main or High, the 8x8 transform, SPS / PPS scaling lists, POC type,
    references, slices, deblocking, constrained intra, offsets, QP ranges."""
    rng = np.random.default_rng(5000 + seed)
    nref = int(rng.integers(1, 5))
    is_high = rng.random() < 0.7
    sps = W.Sps(profile=100 if is_high else 77, max_num_ref_frames=nref,
                poc_type=int(rng.integers(0, 3)), log2_max_frame_num=int(rng.integers(4, 7)),
                log2_max_poc_lsb=5)
    pps = cabac(transform_8x8=int(is_high and rng.random() < 0.7), num_ref_idx_default=nref,
                constrained_intra=int(rng.integers(0, 2)), cb_offset=int(rng.integers(-12, 13)),
                init_qp=int(rng.integers(10, 45)))
    if is_high and rng.random() < 0.5:
        sps.scaling, sps.lists = 1, lists(rng, 8, 0.6, 0.2)
    if is_high and rng.random() < 0.5:
        pps.scaling, pps.lists = 1, lists(rng, 8, 0.6, 0.2)
    w, h = [(48, 32), (64, 48), (32, 64)][seed % 3]
    writer = W.Writer(w, h, seed=seed, sps=sps, pps=pps)
    lo = int(rng.integers(0, 40))
    kw = dict(slices=int(rng.integers(1, 4)), deblock=[None, "off", "slices", "offsets"][seed % 4],
              qp_range=(lo, lo + int(rng.integers(0, 12))), pcm=0.05, off_frame=0.2)
    units = [writer.parameter_sets() + writer.random_picture("IDR", **kw)[0]]
    for _ in range(1, n):
        kind = "I" if rng.random() < 0.15 else "P"
        units.append(writer.random_picture(kind, modify=bool(rng.random() < 0.4),
                                           ref_idc=int(rng.random() > 0.2), **kw)[0])
    return units, w, h


RANDOM_SEEDS = range(24)


@pytest.mark.parametrize("seed", RANDOM_SEEDS)
def test_random_cabac_streams_equal_cv2(seed, tmp_path):
    units, w, h = random_cabac(seed)
    path = avi(str(tmp_path / "r.avi"), units, w, h)
    assert_equal_cv2(path, f"seed {seed}", CABAC, count=len(units))


def test_random_streams_reach_every_context():
    """The seeded streams (these I / P ones and the CABAC B ones of
    ``test_torch_h264_bslices``) decode a bin with every context variable
    frame-coded I / P / B 4:2:0 can reach (and with no other), so a context
    rule the writer and the decoder share is held to cv2 somewhere."""
    from tests.test_torch_h264_bslices import RANDOM_SEEDS as B_SEEDS
    from tests.test_torch_h264_bslices import random_b

    used = np.zeros(H264_CONTEXTS, bool)
    streams = [random_cabac(seed)[0] for seed in RANDOM_SEEDS]
    streams += [random_b(seed)[0] for seed in B_SEEDS if seed % 2]  # the CABAC ones
    for k, units in enumerate(streams):
        decoder = H264Decoder(b"", f"stream {k}")
        for unit in units:
            decoder.decode(W.annexb(unit), rgb=False)
        used |= decoder.contexts
        decoder.close()
    reachable = np.zeros(H264_CONTEXTS, bool)
    reachable[W.REACHABLE_CONTEXTS] = True
    assert not np.any(reachable & ~used), np.nonzero(reachable & ~used)[0].tolist()
    assert not np.any(used & ~reachable), np.nonzero(used & ~reachable)[0].tolist()


def test_refusals_still_raise_with_cabac(tmp_path):
    """Weighted prediction and B slices, once refused, decode in a CABAC
    stream as cv2 decodes them; SP slices stay refused, before any frame."""
    writer = W.Writer(48, 32, seed=54, sps=W.Sps(profile=77, poc_type=0, max_num_ref_frames=2),
                      pps=cabac(weighted_pred=1, weighted_bipred=1))
    units = [writer.parameter_sets() + writer.random_picture("IDR")[0],
             writer.random_picture("P", poc={"lsb": 4})[0],
             writer.random_picture("B", poc={"lsb": 2}, ref_idc=0)[0]]
    path = avi(str(tmp_path / "b.avi"), units, 48, 32)
    assert_equal_cv2(path, "B and weights", {"CABAC", "B slices", "explicit weights"},
                     count=3)
    units = stream(48, 32, 54, 2, sps=MAIN, pps=cabac())
    b = W.Bits().ue(0).ue(3).ue(0).u(4, 1)
    units.append([W.nal_unit(1, 1, b.u(8, 0).trailing().bytes())])
    path = avi(str(tmp_path / "sp.avi"), units, 48, 32)
    frames = []
    with pytest.raises(ValueError, match="frame 2: .*H.264 SP slices.*FFmpeg"):
        for i, _ in iterate_frames(path):
            frames.append(i)
    assert frames == []


@pytest.mark.parametrize("seed,cr_offset", [(12, None), (19, None), (25, None), (4, -3), (7, -3),
                                            (8, -3)])
def test_cavlc_8x8_blocks_coded_without_coefficients_deblock_as_ffmpeg(seed, cr_offset,
                                                                       tmp_path):
    """CAVLC may code an 8x8 block (its coded_block_pattern bit) whose four
    4x4 lists hold no coefficient.  With equal chroma QP offsets FFmpeg's
    fast loop filter then takes bS 2 on every edge of an inter macroblock
    that codes 8x8 blocks 0-2; with two offsets its filter reads the
    coefficients, as the standard does."""
    pps = W.Pps(transform_8x8=1, num_ref_idx_default=2, cb_offset=2 if cr_offset else 0,
                cr_offset=cr_offset)
    writer = W.Writer(32, 64, seed=seed, sps=high(max_num_ref_frames=2), pps=pps)
    units = [writer.parameter_sets() + writer.random_picture("IDR", slices=2)[0]]
    units += [writer.random_picture("P", slices=2)[0] for _ in range(8)]
    path = avi(str(tmp_path / "e.avi"), units, 32, 64)
    assert_equal_cv2(path, f"seed {seed}", {"8x8 transform", "P slices"}, count=9)


def test_damaged_cabac_slice_raises(tmp_path):
    units = stream(64, 48, 55, 5, sps=HIGH, pps=cabac(transform_8x8=1))
    slices = [u for u in units[3] if u[0] & 31 == 1]
    units[3] = [slices[0][: len(slices[0]) // 3]]
    path = avi(str(tmp_path / "d.avi"), units, 64, 48)
    frames = []
    with pytest.raises(ValueError, match=f"{path} frame 3: H.264 decode: "):
        for i, _ in iterate_frames(path):
            frames.append(i)
    assert frames == [0, 1, 2]


# -------------------------------------------------------------- containers


@pytest.fixture(scope="module")
def clip():
    """A 12-frame plain-encoded High profile CABAC stream at 128x96 (8x8
    transform, PPS scaling lists): its access units and parameter sets."""
    frames = [np.ascontiguousarray(f[..., ::-1]) for f in moving_scene(12, 128, 96, seed=7)]
    sps, pps = fixture_sets()
    writer, units = plain_stream(frames, 128, 96, gop=6, qp=27, sps=sps, pps=pps)
    return units, [s.nal() for s in writer.sps], [p.nal() for p in writer.pps]


@pytest.fixture(scope="module")
def files(clip, tmp_path_factory):
    return layouts(str(tmp_path_factory.mktemp("h264_cabac")), *clip)


@pytest.mark.parametrize("name", ["clip.mp4", "len2.mp4", "avc3.mp4", "clip.mkv", "clip.avi"])
def test_containers_probe_and_frames_equal_jax(name, files, jax_reads_ffmpeg):  # noqa: F811
    path = files[name]
    assert probe_video(path) == jax_probe_video(path)
    got, want = list(iterate_frames(path, every=2)), list(jax_iterate_frames(path, every=2))
    assert [i for i, _ in got] == [i for i, _ in want] == list(range(0, 12, 2))
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert "CABAC" in decode_all(path)[1]


def test_one_byte_nal_lengths_equal_cv2(tmp_path):
    """avcC's lengthSizeMinusOne 0 with CABAC slices under 256 bytes."""
    writer = W.Writer(16, 16, seed=56, sps=high(max_num_ref_frames=1),
                      pps=cabac(transform_8x8=1))
    units = [writer.random_picture("IDR", coeff_density=0.1)[0]] + [
        writer.random_picture("P", coeff_density=0.1, mb_kinds=(W.SKIP, W.INTER),
                              sub_partitions=False)[0] for _ in range(3)]
    sps, pps = [s.nal() for s in writer.sps], [p.nal() for p in writer.pps]
    path = write_mp4(str(tmp_path / "l1.mp4"), [W.length_prefixed(u, 1) for u in units], 16, 16,
                     kind=b"avc1", config=W.avcc(sps, pps, 1))
    used = assert_equal_cv2(path, "length 1", CABAC, count=4)
    assert "length prefixes" in used


# ---------------------------------------------------------------- surfaces


def test_stream_detect_video_equals_jax(files, tmp_path, jax_reads_ffmpeg):  # noqa: F811
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


def test_extract_frames_equals_jax(files, tmp_path, jax_reads_ffmpeg):  # noqa: F811
    port, jax_out = tmp_path / "port", tmp_path / "jax"
    for main, out in ((torch_extract.main, port), (jax_extract.main, jax_out)):
        main(["--input", files["clip.mp4"], "--output", str(out), "--every", "3"])
    names = sorted(os.listdir(port))
    assert names == sorted(os.listdir(jax_out)) and len(names) == 4
    for f in names:
        assert (port / f).read_bytes() == (jax_out / f).read_bytes(), f


def test_detect_cli_mp4_equals_jax(files, tiny_weights, tmp_path, monkeypatch,  # noqa: F811
                                   jax_reads_ffmpeg):  # noqa: F811
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
    """The card's CABAC fixture (``tests/fixtures/make_h264_cabac_fixture.py``)
    decodes to the digests OpenCV gave for it, and probes as JAX does."""
    with open(DIGESTS) as f:
        digests = json.load(f)
    got, used = decode_all(VIDEO)
    assert len(got) == len(digests["frames"]) == 48
    for k, ((rgb, y), want) in enumerate(zip(got, digests["frames"])):
        assert hashlib.sha256(y.tobytes()).hexdigest() == want["y"], k
        assert hashlib.sha256(rgb.tobytes()).hexdigest() == want["rgb"], k
    assert {"CABAC", "8x8 transform", "intra 8x8", "PPS scaling matrices",
            "several slices", "skipped macroblocks"} <= used
    assert probe_video(VIDEO) == jax_probe_video(VIDEO)
    assert probe_video(VIDEO) == {"fps": 25.0, "frame_count": 48, "width": 640, "height": 480}
    assert os.path.getsize(VIDEO) < 1 << 20
