"""Write the card's CABAC H.264 fixture: ``tests/fixtures/h264_cabac_640x480.mkv``
and ``h264_cabac_640x480.json``, the SHA-256 of each Y plane and RGB frame
OpenCV's FFmpeg gives for it.

The twin of ``make_h264_fixture``: the tests' own plain encoder
(``tests/torch_h264_writer.py``) over 48 frames of ``moving_scene`` at
640x480 and 25 fps, an IDR every 12 frames, two slices a picture, the loop
filter on, in a High profile stream with CABAC, the 8x8 transform (intra
8x8 and 8x8 inter residuals) and PPS scaling lists (sent, absent and
default ones); in Matroska (``V_MPEG4/ISO/AVC`` with its avcC, 4-byte NAL
lengths).  It is written only if the port's decoder gives OpenCV's Y planes
for it.

    python -m tests.fixtures.make_h264_cabac_fixture
"""

from __future__ import annotations

import os

import numpy as np

from tests import torch_h264_writer as W
from tests.fixtures.make_h264_fixture import plain_stream
from tests.fixtures.make_mp4_fixture import moving_scene, write_digests
from tests.torch_mkv_helpers import write_mkv
from tests.torch_mp4_helpers import cv2_views

HERE = os.path.dirname(os.path.abspath(__file__))
VIDEO = os.path.join(HERE, "h264_cabac_640x480.mkv")
DIGESTS = os.path.join(HERE, "h264_cabac_640x480.json")
WIDTH, HEIGHT, FRAMES, GOP, QP = 640, 480, 48, 12, 28
# the PPS's scaling lists (scan order): a sent 4x4 intra luma list (chroma
# falls back to it), the default 4x4 inter lists, a sent 8x8 intra list and
# the default 8x8 inter one
LISTS = [[12 + i // 2 for i in range(16)], None, None, "default", None, None,
         [14 + i // 4 for i in range(64)], "default"]


def parameter_sets():
    sps = W.Sps(profile=100, level=30, max_num_ref_frames=2)
    pps = W.Pps(cabac=1, transform_8x8=1, scaling=1, lists=LISTS, init_qp=QP)
    return sps, pps


def write_fixture() -> None:
    from viddet_tpu_torch.native import H264Decoder

    frames = [np.ascontiguousarray(f[..., ::-1]) for f in moving_scene(FRAMES, WIDTH, HEIGHT,
                                                                        seed=0)]
    sps, pps = parameter_sets()
    writer, units = plain_stream(frames, WIDTH, HEIGHT, GOP, QP, sps=sps, pps=pps)
    config = W.avcc([s.nal() for s in writer.sps], [p.nal() for p in writer.pps])
    samples = [W.length_prefixed([u for u in unit if u[0] & 31 not in (7, 8)]) for unit in units]
    write_mkv(VIDEO, samples, WIDTH, HEIGHT, codec="V_MPEG4/ISO/AVC", private=config,
              doc_type="matroska")
    want = cv2_views(VIDEO, "y")
    decoder, ys = H264Decoder(config, VIDEO), []
    for sample in samples:
        if decoder.decode(sample, rgb=False):
            ys.append(decoder.planes()[0])
    need = {"IDR picture", "P slices", "CABAC", "8x8 transform", "intra 8x8", "intra 16x16",
            "PPS scaling matrices", "default scaling lists", "scaling fall-back",
            "skipped macroblocks", "several slices", "intra in P slices"}
    assert need <= decoder.features, need - decoder.features
    assert len(ys) == len(want) == FRAMES
    assert all(np.array_equal(y, w.reshape(-1)[: y.size].reshape(y.shape))
               for y, w in zip(ys, want))
    write_digests(VIDEO, DIGESTS, WIDTH, HEIGHT, FRAMES)
    print(f"{VIDEO}: {os.path.getsize(VIDEO)} bytes, {FRAMES} frames")


if __name__ == "__main__":
    write_fixture()
