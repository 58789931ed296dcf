"""The port's VP8 decoder (``native/vp8.cpp``, ``native.Vp8Decoder``)
against OpenCV's FFmpeg on the CPU.

Every stream is encoded here by the libvpx encoder inside the
opencv-python wheel's libavcodec (``tests.torch_mkv_helpers``), laid out
as a WebM and read back both ways: every shown frame's Y plane
(``CAP_PROP_CONVERT_RGB`` 0) and RGB frame equal OpenCV's bit for bit, and
the decoder reports the features the stream claims to exercise:

* key frames only (B_PRED, every 4x4 sub-mode context);
* inter frames: split vectors, vectors that leave the frame, new vectors,
  golden / alt-ref references, intra macroblocks in inter frames;
* segmentation with map updates, probabilities not kept from frame to
  frame (error resilient real-time mode); loop filter deltas;
* versions 1-3: bilinear filters, the simple loop filter, full-pixel chroma;
* 2, 4 and 8 token partitions; a loop filter sharpness of 5;
* alt-ref frames (two-pass ``auto-alt-ref``): hidden, decoded, not shown;
* an odd width.  At an odd height OpenCV's swscale leaves its yuv2rgb path
  for its bicubic scaler: the Y plane is still exact, the RGB frame is not
  (ROADMAP Queue 3), and the test holds both.

Failures: a truncated first or token partition raises ValueError naming
the file and the frame after the frames before it (both readers); an inter
frame before any key frame, a key frame of size 0 and a size change raise
in the decoder.
"""

import numpy as np
import pytest

from tests.fixtures.make_mp4_fixture import moving_scene
from tests.torch_mkv_helpers import vp8_packets, vp8_webm, write_mkv
from tests.torch_mp4_helpers import cv2_views
from viddet_tpu_torch.infer.stream import NativeFrameSource
from viddet_tpu_torch.native import Vp8Decoder
from viddet_tpu_torch.native.mkv import MkvReader
from viddet_tpu_torch.utils.video import iterate_frames, probe_video

BASE = {"b": 300000}
# name: (encoder options, frames, width, height, two passes, features the stream must use)
STREAMS = {
    "key frames only": ({"g": 1, "b": 400000}, 6, 96, 64, False, {"key frame", "B_PRED"}),
    "inter frames": (BASE, 12, 160, 96, False,
                     {"inter frame", "split vectors", "vectors off the frame", "new vectors",
                      "golden reference", "intra in inter frames", "B_PRED",
                      "loop filter deltas"}),
    "segmentation": ({"error-resilient": 1, "deadline": "realtime", "cpu-used": 8,
                      "b": 200000}, 12, 128, 80, False,
                     {"segmentation", "segment map update", "no entropy refresh"}),
    "version 1": ({**BASE, "profile": 1}, 10, 96, 64, False,
                  {"bilinear filters", "simple loop filter"}),
    "version 2": ({**BASE, "profile": 2}, 10, 96, 64, False, {"bilinear filters"}),
    "version 3": ({**BASE, "profile": 3}, 10, 96, 64, False,
                  {"bilinear filters", "full-pixel chroma", "simple loop filter"}),
    "2 token partitions": ({**BASE, "slices": 2}, 6, 160, 136, False, {"token partitions"}),
    "4 token partitions": ({**BASE, "slices": 4}, 6, 160, 136, False, {"token partitions"}),
    "8 token partitions": ({**BASE, "slices": 8}, 8, 200, 136, False, {"token partitions"}),
    "sharpness": ({**BASE, "sharpness": 5, "b": 200000}, 8, 96, 64, False, {"sharpness"}),
    "alt-ref frames": ({**BASE, "auto-alt-ref": 1, "lag-in-frames": 16}, 17, 128, 80, True,
                      {"hidden frame", "alt-ref reference", "sign bias", "buffer copies"}),
    "odd width": (BASE, 8, 99, 64, False, {"inter frame"}),
}


def decode_all(path: str):
    """Each shown frame's (RGB, Y) through ``Vp8Decoder`` over the WebM's
    frames, and the decoder's features."""
    decoder = Vp8Decoder(path)
    out = []
    with MkvReader(path) as reader:
        for i in range(len(reader.index.offsets)):
            rgb = decoder.decode(reader.sample(i))
            if rgb is not None:
                out.append((rgb, decoder.planes()[0]))
    return out, decoder.features


def cv2_frames(path: str):
    bgr, ys = cv2_views(path, "bgr"), cv2_views(path, "y")
    h, w = bgr[0].shape[:2]
    return [(b[..., ::-1], y.reshape(-1)[: h * w].reshape(h, w)) for b, y in zip(bgr, ys)]


@pytest.mark.parametrize("name", STREAMS)
def test_frames_equal_cv2_bit_for_bit(name, tmp_path):
    options, n, w, h, two_pass, features = STREAMS[name]
    path = vp8_webm(str(tmp_path / "v.webm"), moving_scene(n, w, h, seed=len(name)), options,
                    two_pass)
    got, used = decode_all(path)
    want = cv2_frames(path)
    assert len(got) == len(want) == n
    for k, ((rgb, y), (want_rgb, want_y)) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(y, want_y, err_msg=f"{name} frame {k} Y")
        np.testing.assert_array_equal(rgb, want_rgb, err_msg=f"{name} frame {k} RGB")
    assert features <= used, features - used
    if name == "key frames only":
        assert "inter frame" not in used
    assert [i for i, _ in iterate_frames(path)] == list(range(n))
    assert probe_video(path)["frame_count"] == n


def test_odd_height_y_exact_rgb_is_swscale_scaler_gap(tmp_path):
    """99x67: the Y planes equal OpenCV's; its RGB frames come from swscale's
    bicubic scaler, not the yuv2rgb path the port reproduces (ROADMAP
    Queue 3), so the RGB frames differ where chroma changes."""
    path = vp8_webm(str(tmp_path / "odd.webm"), moving_scene(6, 99, 67, seed=4), BASE)
    got, _ = decode_all(path)
    want = cv2_frames(path)
    assert len(got) == len(want) == 6
    gap = 0
    for (rgb, y), (want_rgb, want_y) in zip(got, want):
        np.testing.assert_array_equal(y, want_y)
        assert rgb.shape == want_rgb.shape == (67, 99, 3)
        gap = max(gap, int(np.abs(rgb.astype(int) - want_rgb).max()))
    assert gap > 0


@pytest.fixture(scope="module")
def stream():
    """A 12-frame VP8 stream (4 token partitions) at 128x80."""
    packets, _ = vp8_packets(moving_scene(12, 128, 80, seed=9), {**BASE, "slices": 4})
    return packets


def first_partition_end(frame: bytes) -> int:
    tag = frame[0] | frame[1] << 8 | frame[2] << 16
    return 3 + (0 if tag & 1 else 7) + (tag >> 5)


@pytest.mark.parametrize("cut", ["first partition", "token partition"])
def test_truncated_frame_raises_after_the_frames_before_it(cut, stream, tmp_path):
    packets = list(stream)
    end = first_partition_end(packets[5])
    packets[5] = packets[5][: end - 5 if cut == "first partition" else end + 9 + 2]
    path = write_mkv(str(tmp_path / "cut.webm"), packets, 128, 80)
    match = ("the first partition" if cut == "first partition"
             else "token partition 0") + ".*runs past the end of the frame"
    frames = []
    with pytest.raises(ValueError, match=f"{path} frame 5: VP8 decode: {match}"):
        for i, _ in iterate_frames(path):
            frames.append(i)
    assert frames == [0, 1, 2, 3, 4]
    got = []
    with pytest.raises(ValueError, match=f"{path}: frame 5: {match}"):
        for i, _, _, _ in NativeFrameSource(path, (32, 32)):
            got.append(i)
    assert got == [0, 1, 2, 3, 4]


def test_frames_the_decoder_refuses(stream):
    decoder = Vp8Decoder("s")
    with pytest.raises(ValueError, match="s: VP8 decode: an inter frame before the first key"):
        decoder.decode(stream[1])
    key = bytearray(stream[0])
    key[6:8] = b"\x00\x00"  # width 0
    with pytest.raises(ValueError, match="a key frame of size 0x80"):
        Vp8Decoder("s").decode(bytes(key))
    key = bytearray(stream[0])
    key[6] = 64  # width 64
    decoder = Vp8Decoder("s")
    decoder.decode(stream[0])
    with pytest.raises(ValueError, match="frame size changes from 128x80 to 64x80"):
        decoder.decode(bytes(key))
    with pytest.raises(ValueError, match="shorter than its frame tag"):
        Vp8Decoder("s").decode(b"\x00\x01")
