"""Write the card's B-frame H.264 fixture: ``tests/fixtures/h264_bframes_640x480.mp4``
and ``h264_bframes_640x480.json``, the SHA-256 of each Y plane and RGB frame
OpenCV's FFmpeg gives for it.

The third of ``make_h264_fixture`` and ``make_h264_cabac_fixture``: the
tests' own plain encoder (``tests/torch_h264_writer.py``) over 48 frames of
``moving_scene`` at 640x480 and 25 fps in a High profile CABAC stream with
the 8x8 transform and a B pyramid: an IDR at frames 0 and 24, then groups of
a P picture four frames on, a reference B picture two on and two
non-reference B pictures between (B_Skip, B_Direct_16x16 and B_L0 / L1 /
Bi_16x16 from a full-sample search); B pictures alternate spatial and
temporal direct prediction; the first IDR period takes a PPS with explicit
weights in P and B slices, the second one with implicit weights; the VUI
states bitstream_restriction (max_num_reorder_frames 2); two slices a
picture.  In an MP4 (``avc1`` with its avcC) with ``ctts`` composition
offsets and the shifted edit list an MP4 muxer writes.  Each reference
picture's planes for the pictures after it are the port decoder's; the file
is written only if the port's decoder gives OpenCV's Y planes for it.

    python -m tests.fixtures.make_h264_bframes_fixture
"""

from __future__ import annotations

import os

import numpy as np

from tests import torch_h264_writer as W
from tests.fixtures.make_mp4_fixture import moving_scene, write_digests
from tests.torch_mp4_helpers import cv2_views, write_mp4

HERE = os.path.dirname(os.path.abspath(__file__))
VIDEO = os.path.join(HERE, "h264_bframes_640x480.mp4")
DIGESTS = os.path.join(HERE, "h264_bframes_640x480.json")
WIDTH, HEIGHT, FRAMES, GOP, QP = 640, 480, 48, 24, 28
TICK = 512  # the MP4's sample duration (timescale 12800: 25 fps)


def coding_order(frames: int, gop: int):
    """(display index, kind, nal_ref_idc) in decoding order: an IDR every
    ``gop`` frames, then P four frames on, a reference B two on, the two
    between; a GOP's last frames a P and the B pictures before it."""
    out = []
    for start in range(0, frames, gop):
        end = min(start + gop, frames)
        out.append((start, "IDR", 1))
        base = start
        while base + 1 < end:
            step = min(4, end - 1 - base)
            out.append((base + step, "P", 1))
            if step == 4:
                out += [(base + 2, "B", 1), (base + 1, "B", 0), (base + 3, "B", 0)]
            else:
                out += [(base + k, "B", 0) for k in range(1, step)]
            base += step
    return out


def parameter_sets():
    sps = W.Sps(profile=100, level=30, max_num_ref_frames=3, poc_type=0, log2_max_poc_lsb=8,
                restriction=2)
    explicit = W.Pps(id=0, cabac=1, transform_8x8=1, init_qp=QP, weighted_pred=1,
                     weighted_bipred=1)
    implicit = W.Pps(id=1, cabac=1, transform_8x8=1, init_qp=QP, weighted_bipred=2)
    return sps, [explicit, implicit]


def reference_planes(config: bytes, samples, displays, k: int):
    """The port decoder's planes of sample ``k`` (decoding order): every
    sample up to it decoded and flushed, ``k``'s among them found by its
    display index."""
    from viddet_tpu_torch.native import H264Decoder

    decoder, shown = H264Decoder(config, "plain encoder", 2), []
    for sample in samples[:k + 1]:
        if decoder.decode(sample, rgb=False):
            shown.append(decoder.planes())
    while decoder.flush(rgb=False):
        shown.append(decoder.planes())
    decoder.close()
    return shown[sorted(displays[:k + 1]).index(displays[k])]


def encode():
    """The fixture's avcC and samples (4-byte lengths, decoding order), and
    each sample's display index."""
    frames = [np.ascontiguousarray(f[..., ::-1]) for f in moving_scene(FRAMES, WIDTH, HEIGHT,
                                                                        seed=0)]
    sps, pps = parameter_sets()
    writer = W.Writer(WIDTH, HEIGHT, seed=0, sps=sps, pps=pps[0])
    writer.pps = pps
    config = W.avcc([sps.nal()], [p.nal() for p in pps])
    samples, displays = [], []
    b_count = 0
    for k, (display, kind, ref_idc) in enumerate(coding_order(FRAMES, GOP)):
        start = display - display % GOP
        if kind == "B":
            b_count += 1
        unit = writer.encode_picture(frames[display], kind, qp=QP, slices=2,
                                     pps=pps[(display // GOP) % 2],
                                     poc={"lsb": 2 * (display - start)}, ref_idc=ref_idc,
                                     direct_spatial=b_count % 2)[0]
        samples.append(W.length_prefixed([u for u in unit if u[0] & 31 not in (7, 8)]))
        displays.append(display)
        if ref_idc:
            writer.set_reference_planes(reference_planes(config, samples, displays, k))
    return config, samples, displays


def write_fixture() -> None:
    from viddet_tpu_torch.native import H264Decoder

    config, samples, displays = encode()
    delay = max(k - sorted(displays).index(d) for k, d in enumerate(displays))
    ctts = [(d + delay - k) * TICK for k, d in enumerate(displays)]
    keys = [k for k, d in enumerate(displays) if d % GOP == 0]
    write_mp4(VIDEO, samples, WIDTH, HEIGHT, kind=b"avc1", config=config, keyframes=keys,
              ctts=ctts, edits=[(FRAMES * 40, delay * TICK, 1)])
    want = cv2_views(VIDEO, "y")
    decoder, ys = H264Decoder(config, VIDEO, delay), []
    for sample in samples:
        if decoder.decode(sample, rgb=False):
            ys.append(decoder.planes()[0])
    while decoder.flush(rgb=False):
        ys.append(decoder.planes()[0])
    need = {"B slices", "spatial direct", "temporal direct", "explicit weights",
            "implicit weights", "reference B pictures", "reordered output", "bi-prediction",
            "B_Skip", "bitstream restriction", "CABAC", "8x8 transform", "several slices"}
    assert need <= decoder.features, need - decoder.features
    assert len(ys) == len(want) == FRAMES
    assert all(np.array_equal(y, w.reshape(-1)[: y.size].reshape(y.shape))
               for y, w in zip(ys, want))
    write_digests(VIDEO, DIGESTS, WIDTH, HEIGHT, FRAMES)
    print(f"{VIDEO}: {os.path.getsize(VIDEO)} bytes, {FRAMES} frames")


if __name__ == "__main__":
    write_fixture()
