"""Write the card's H.264 fixture: ``tests/fixtures/h264_640x480.mp4`` and
``h264_640x480.json``, the SHA-256 of each Y plane and RGB frame OpenCV's
FFmpeg gives for it.

The wheel's libavcodec has no H.264 encoder, so the stream is the tests' own
plain encoder's (``tests/torch_h264_writer.py``): 48 frames of
``moving_scene`` at 640x480 and 25 fps, an IDR every 12 frames, P pictures
from the last reference (2 reference frames, intra 16x16 / 4x4 chosen by
SAD, P_L0_16x16 from a full-sample search, P_Skip), the loop filter on, two
slices a picture, CAVLC; in an MP4 (``avc1`` with its avcC, 4-byte NAL
lengths).  It is written only if the port's decoder gives OpenCV's Y planes
for it.

    python -m tests.fixtures.make_h264_fixture
"""

from __future__ import annotations

import os

import numpy as np

from tests import torch_h264_writer as W
from tests.fixtures.make_mp4_fixture import moving_scene, write_digests
from tests.torch_mp4_helpers import cv2_views, write_mp4

HERE = os.path.dirname(os.path.abspath(__file__))
VIDEO = os.path.join(HERE, "h264_640x480.mp4")
DIGESTS = os.path.join(HERE, "h264_640x480.json")
WIDTH, HEIGHT, FRAMES, GOP, QP = 640, 480, 48, 12, 28


def plain_stream(frames_rgb, width: int, height: int, gop: int, qp: int, slices: int = 2,
                 refs: int = 2):
    """Access units (NAL units each) of the plain encoder over
    ``frames_rgb``, each P picture predicted from the port decoder's planes
    of the picture before; the SPS and PPS lead the first."""
    from viddet_tpu_torch.native import H264Decoder

    writer = W.Writer(width, height, seed=0, sps=W.Sps(max_num_ref_frames=refs, level=30),
                      pps=W.Pps(init_qp=qp))
    decoder = H264Decoder(b"", "plain encoder")
    units = []
    for i, rgb in enumerate(frames_rgb):
        unit = writer.encode_picture(rgb, "IDR" if i % gop == 0 else "P", qp=qp,
                                     slices=slices)[0]
        if i == 0:
            unit = writer.parameter_sets() + unit
        units.append(unit)
        decoder.decode(W.annexb(unit))
        writer.set_reference_planes(decoder.planes())
    decoder.close()
    return writer, units


def write_fixture() -> None:
    from viddet_tpu_torch.native import H264Decoder

    frames = [np.ascontiguousarray(f[..., ::-1]) for f in moving_scene(FRAMES, WIDTH, HEIGHT,
                                                                        seed=0)]
    writer, units = plain_stream(frames, WIDTH, HEIGHT, GOP, QP)
    sps = [s.nal() for s in writer.sps]
    pps = [p.nal() for p in writer.pps]
    samples = [W.length_prefixed([u for u in unit if u[0] & 31 not in (7, 8)]) for unit in units]
    keys = [i for i in range(FRAMES) if i % GOP == 0]
    write_mp4(VIDEO, samples, WIDTH, HEIGHT, kind=b"avc1", config=W.avcc(sps, pps),
              keyframes=keys)
    want = cv2_views(VIDEO, "y")
    decoder, ys = H264Decoder(W.avcc(sps, pps), VIDEO), []
    for sample in samples:
        if decoder.decode(sample, rgb=False):
            ys.append(decoder.planes()[0])
    need = {"IDR picture", "P slices", "intra 16x16", "intra 4x4", "skipped macroblocks",
            "P 16x16", "several slices", "intra in P slices"}
    assert need <= decoder.features, need - decoder.features
    assert len(ys) == len(want) == FRAMES
    assert all(np.array_equal(y, w.reshape(-1)[: y.size].reshape(y.shape))
               for y, w in zip(ys, want))
    write_digests(VIDEO, DIGESTS, WIDTH, HEIGHT, FRAMES)
    print(f"{VIDEO}: {os.path.getsize(VIDEO)} bytes, {FRAMES} frames")


if __name__ == "__main__":
    write_fixture()
