"""The port's drawn video output against the JAX package's, on the CPU:
every surface that draws writes what JAX's ``VideoWriter`` (cv2's ``mp4v``
writer) writes: MPEG-4 Part 2 in ``{stem}_det.mp4``, or in the ``.mp4``,
``.mov`` or ``.avi`` that ``visualise --video`` names.

* Surfaces (a tiny float32 YOLOv3 at 64 px, as
  ``tests/test_torch_video_stream.py`` runs them): ``stream_detect_video``
  over an MPEG-4 ``.mp4`` and a Motion-JPEG ``.avi`` (every 1 and 3),
  ``stream_detect_videos`` over the two, ``detect --input clip.avi`` and
  ``visualise --video`` into each container.  cv2 opens each output with
  the frame count, size and fps of JAX's, decodes it to the port's own
  decoder's frames, and the ``.txt`` lines equal JAX's; where the drawn
  frames are recomputed, the file is the bytes a fresh ``VideoWriter``
  writes from them.
* ``.avi``: the fourcc ``mp4v`` (OpenCV's), the VOS / VOL headers in-band
  before each I-VOP, ``AVIIF_KEYFRAME`` on the I-VOPs in ``idx1`` and the
  ``ix00`` key bit in OpenDML segments.
* Refusals: another container raises ValueError naming it before anything
  is written; an encoder that fails raises, and nothing falls back to
  Motion-JPEG or another container.
"""

import functools
import os
import struct

import jax
import numpy as np
import pytest

import viddet_tpu.cli.detect as jax_detect
import viddet_tpu.cli.visualise as jax_visualise
import viddet_tpu_torch.cli.detect as torch_detect
import viddet_tpu_torch.cli.visualise as torch_visualise
import viddet_tpu_torch.infer.multistream as torch_multistream
import viddet_tpu_torch.utils.video as torch_video
from tests.fixtures.make_mp4_fixture import moving_scene
from tests.test_torch_mp4 import jax_reads_like_the_port  # noqa: F401  (a fixture)
from tests.test_torch_mpeg4 import write_clip
from tests.test_torch_stream import SIZE, twin_models
from tests.test_torch_video_stream import (  # noqa: F401
    CLASSES, CPU, _cli, assert_txt_equal, transforms, videos, weights,
)
from tests.torch_mp4_helpers import cv2_views
from tests.torch_video_helpers import assert_drawn_video, cv2_props, drawn_frames
from viddet_tpu.core.precision import FLOAT32_POLICY as JAX_F32
from viddet_tpu.infer.multistream import stream_detect_videos as jax_stream_detect_videos
from viddet_tpu.infer.stream import stream_detect_video as jax_stream_detect_video
from viddet_tpu_torch.core.precision import FLOAT32_POLICY
from viddet_tpu_torch.data.transforms import invert_affine_to_boxes
from viddet_tpu_torch.infer.stream import FrameSource, stream_detect, stream_detect_video
from viddet_tpu_torch.native import Mpeg4Encoder
from viddet_tpu_torch.native.avi import AviWriter, read_index
from viddet_tpu_torch.utils.image import draw_detections
from viddet_tpu_torch.utils.video import VideoWriter, iterate_frames

SYNTH = ["--dataset", "synthetic", "--data-root", "synthetic"]


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """An MPEG-4 Part 2 .mp4 of 9 frames at 128x96, 10 fps, from cv2's
    ``mp4v`` writer."""
    return write_clip(str(tmp_path_factory.mktemp("out_clip") / "clip.mp4"),
                      moving_scene(9, 128, 96, seed=11), 10)


def drawn_run(path, every):
    """The frames a drawn run of the port's twin model draws over ``path``."""
    _, _, infer = twin_models()
    port_t, _ = transforms()
    return [draw_detections(rgb, invert_affine_to_boxes(boxes, affine), ids, scores, CLASSES,
                            0.0)
            for _, rgb, affine, ids, scores, boxes in stream_detect(
                FrameSource(path, port_t, every=every), infer, 4, (SIZE, SIZE), device=CPU)]


@pytest.mark.parametrize("source,every", [("mp4", 1), ("mp4", 3), ("avi", 2)])
def test_stream_detect_video_writes_det_mp4_as_jax(source, every, clip, videos, tmp_path,
                                                   jax_reads_like_the_port):
    path = clip if source == "mp4" else videos[0]
    stem = os.path.splitext(os.path.basename(path))[0]
    jax_infer, variables, infer = twin_models()
    port_t, jax_t = transforms()
    kw = dict(thresh=0.0, batch_size=4, every=every, draw=True, save_detections=True)
    stats = stream_detect_video(path, infer, port_t, CLASSES, output_dir=str(tmp_path / "port"),
                                device=CPU, **kw)
    want = jax_stream_detect_video(path, jax_infer, variables, jax_t, CLASSES,
                                   output_dir=str(tmp_path / "jax"), **kw)
    assert stats["frames"] == want["frames"]
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax")) == [
        f"{stem}_det.mp4", f"{stem}_det.txt"]
    assert assert_txt_equal(str(tmp_path / "port" / f"{stem}_det.txt"),
                            str(tmp_path / "jax" / f"{stem}_det.txt")) > 0
    fps = cv2_props(path)[3] if source == "mp4" else 10.0
    assert_drawn_video(str(tmp_path / "port" / f"{stem}_det.mp4"), drawn_run(path, every),
                       fps / every, str(tmp_path / "jax" / f"{stem}_det.mp4"))


def test_stream_detect_videos_writes_det_mp4_as_jax(clip, videos, tmp_path,
                                                    jax_reads_like_the_port):
    jax_infer, variables, infer = twin_models()
    port_t, jax_t = transforms()
    paths = [clip, videos[1]]
    kw = dict(thresh=0.0, batch_size=4, k=1, draw=True, save_detections=True)
    stats = torch_multistream.stream_detect_videos(paths, infer, port_t, CLASSES,
                                                   output_dir=str(tmp_path / "port"),
                                                   device=CPU, **kw)
    want = jax_stream_detect_videos(paths, jax_infer, variables, jax_t, CLASSES,
                                    output_dir=str(tmp_path / "jax"), **kw)
    assert stats["per_stream"] == want["per_stream"] == {"clip.mp4": 9, "b.avi": 7}
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    for stem in ("clip", "b"):
        assert assert_txt_equal(str(tmp_path / "port" / f"{stem}_det.txt"),
                                str(tmp_path / "jax" / f"{stem}_det.txt")) > 0
        assert_drawn_video(str(tmp_path / "port" / f"{stem}_det.mp4"), None, None,
                           str(tmp_path / "jax" / f"{stem}_det.mp4"))


def test_detect_cli_writes_det_mp4_as_jax(videos, weights, tmp_path, monkeypatch,  # noqa: F811
                                          jax_reads_like_the_port):
    monkeypatch.setattr(jax_detect, "build_model",
                        functools.partial(jax_detect.build_model, policy=JAX_F32))
    monkeypatch.setattr(torch_detect, "build_model",
                        functools.partial(torch_detect.build_model, policy=FLOAT32_POLICY))
    monkeypatch.setenv("VIDDET_PAIR_TOPK", "det")
    jax.clear_caches()
    assert _cli(torch_detect.main, videos[0], str(tmp_path / "port"), weights[1]) == 11
    _cli(jax_detect.main, videos[0], str(tmp_path / "jax"), weights[1])
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax")) == [
        "a_det.mp4", "a_det.txt"]
    assert assert_txt_equal(str(tmp_path / "port" / "a_det.txt"),
                            str(tmp_path / "jax" / "a_det.txt")) > 0
    assert_drawn_video(str(tmp_path / "port" / "a_det.mp4"), None, None,
                       str(tmp_path / "jax" / "a_det.mp4"))


@pytest.mark.parametrize("name", ["out.mp4", "out.mov", "out.avi"])
def test_visualise_video_writes_the_named_container_as_jax(name, tmp_path):
    args = SYNTH + ["--max-images", "5", "--video", name, "--fps", "12.5"]
    assert torch_visualise.main(args + ["--output", str(tmp_path / "port")]) == 5
    jax_visualise.main(args + ["--output", str(tmp_path / "jax")])
    assert_drawn_video(str(tmp_path / "port" / name), None, None, str(tmp_path / "jax" / name))
    assert cv2_props(str(tmp_path / "port" / name))[::3] == (5, 12.5)


def avi_index(path: str):
    """The (fourcc, flags) of each idx1 entry of the first RIFF segment, and
    the strh / strf fourccs."""
    data = open(path, "rb").read()
    strh = data.index(b"strh")
    strf = data.index(b"strf")
    at = data.index(b"idx1")
    (n,) = struct.unpack_from("<I", data, at + 4)
    entries = [struct.unpack_from("<4sIII", data, at + 8 + i) for i in range(0, n, 16)]
    return data[strh + 12 : strh + 16], data[strf + 24 : strf + 28], entries


def test_avi_holds_mp4v_with_in_band_headers_and_key_flags(tmp_path):
    frames = drawn_frames(26, 96, 64, seed=4)
    path = str(tmp_path / "a.avi")
    with VideoWriter(path, 25, (96, 64)) as writer:
        for f in frames:
            writer.write(f)
    handler, compression, entries = avi_index(path)
    assert handler == compression == b"mp4v"
    assert [i for i, e in enumerate(entries) if e[1] & 0x10] == [0, 12, 24]
    index = read_index(path)
    assert index.codec == "mpeg4" and index.frame_count == 26
    config = Mpeg4Encoder(96, 64, 25, 1).config
    data = open(path, "rb").read()
    for i, (offset, size) in enumerate(zip(index.offsets, index.sizes)):
        head = data[offset : offset + len(config)]
        assert (head == config) == (i % 12 == 0), i
    assert_drawn_video(path, frames, 25)


def test_opendml_mpeg4_avi_marks_key_frames_in_ix00(tmp_path):
    """Past ``segment_bytes`` the file continues in AVIX segments; each
    ix00 entry's bit 31 is set on the frames that are not key frames, and
    both readers see every frame."""
    frames = drawn_frames(30, 64, 48, seed=5)
    encoder = Mpeg4Encoder(64, 48, 25, 1)
    path = str(tmp_path / "odml.avi")
    with AviWriter(path, 64, 48, 25, segment_bytes=12000, codec="mpeg4") as avi:
        for f in frames:
            vop, key = encoder.encode(f)
            avi.write_sample(encoder.config + vop if key else vop, key)
    data = open(path, "rb").read()
    assert data.count(b"AVIX") >= 1
    keys, pos = [], 0
    while (pos := data.find(b"ix00", pos)) >= 0:
        (n,) = struct.unpack_from("<I", data, pos + 12)
        keys += [not struct.unpack_from("<II", data, pos + 32 + 8 * i)[1] >> 31
                 for i in range(n)]
        pos += 4
    assert [i for i, k in enumerate(keys) if k] == [0, 12, 24] and len(keys) == 30
    got = [f for _, f in iterate_frames(path)]
    want = cv2_views(path, "bgr")
    assert len(got) == len(want) == 30
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w[..., ::-1])


@pytest.mark.parametrize("name,named", [("v.mkv", "Matroska"), ("v.webm", "WebM"),
                                        ("v.gif", ".gif"), ("v", "extensionless")])
def test_other_containers_raise_before_anything_is_written(name, named, tmp_path):
    out = tmp_path / "out"
    with pytest.raises(ValueError, match=f"does not write {named}.*FFmpeg"):
        VideoWriter(str(out / name), 25, (64, 48))
    with pytest.raises(ValueError, match=f"does not write {named}"):
        torch_visualise.main(SYNTH + ["--output", str(out), "--video", name])
    assert not out.exists()


def test_a_failing_encoder_raises_and_nothing_falls_back(tmp_path, monkeypatch):
    """A build or an encode that fails raises; no Motion-JPEG (or other)
    file takes the encoder's place."""
    class Broken:
        def __init__(self, *a, **k):
            raise RuntimeError("image codec build failed")

    monkeypatch.setattr(torch_video, "Mpeg4Encoder", Broken)
    with pytest.raises(RuntimeError, match="build failed"):
        VideoWriter(str(tmp_path / "out" / "a.mp4"), 25, (64, 48))
    assert not (tmp_path / "out").exists()
    monkeypatch.undo()

    def fail(self, rgb):
        raise ValueError(f"{self.name} frame {self.frames}: MPEG-4 encode: out of memory")

    monkeypatch.setattr(torch_video.Mpeg4Encoder, "encode", fail)
    writer = VideoWriter(str(tmp_path / "b.avi"), 25, (64, 48))
    with pytest.raises(ValueError, match="b.avi frame 0: MPEG-4 encode"):
        writer.write(np.zeros((48, 64, 3), np.uint8))
    writer.close()
    assert b"MJPG" not in open(tmp_path / "b.avi", "rb").read()
