"""The port's ``visualise`` and ``extract_frames`` CLIs against the JAX
package's, on the CPU (mirrors ``tests/integration/test_cli.py``'s
``test_visualise_cli_side_by_side`` and ``test_extract_frames_cli``).

* ``visualise --side-by-side`` draws GT | detections at twice the width,
  the same layout as JAX's; ``--video`` writes MPEG-4 Part 2 into the
  ``.mp4``, ``.mov`` or ``.avi`` it names, as JAX's ``mp4v`` writer does
  (``tests/test_torch_video_out.py``), and refuses any other extension
  before writing.
* ``visualise --gif``: the port's own GIF encoder, decoded here with PIL,
  has JAX's (PIL's) frame count, size, duration and loop, and each frame's
  PSNR against the drawn frame is no more than 1 dB below that of JAX's
  PIL GIF against JAX's drawn frame (the quantisers differ; the port's
  k-means rounds after the median cut usually come out above PIL's).
* ``extract_frames`` prints JAX's lines and writes the same files: JPEGs
  byte for byte equal to JAX's (JAX reading through OpenCV's MJPEG
  backend, as in ``test_torch_video_stream.py``), PNGs equal in pixels.
"""

import os
import re

import cv2
import numpy as np
import pytest
from PIL import Image, ImageSequence

import viddet_tpu.cli.extract_frames as jax_extract
import viddet_tpu.cli.visualise as jax_visualise
import viddet_tpu_torch.cli.extract_frames as torch_extract
import viddet_tpu_torch.cli.visualise as torch_visualise
from tests.test_torch_video import photo_frames, write_video
from tests.torch_mp4_helpers import h264_mp4
from viddet_tpu_torch.data.base import imread_rgb
from viddet_tpu_torch.data.transforms import resize_plain
from viddet_tpu_torch.utils.gif import lzw, quantize, write_gif
from viddet_tpu_torch.utils.video import iterate_frames

SYNTH = ["--dataset", "synthetic", "--data-root", "synthetic"]


@pytest.fixture
def jax_reads_mjpeg(monkeypatch):
    original = cv2.VideoCapture
    monkeypatch.setattr(cv2, "VideoCapture",
                        lambda path, *api: original(path, *(api or (cv2.CAP_OPENCV_MJPEG,))))


def test_visualise_side_by_side_doubles_the_width(tmp_path):
    base, side = str(tmp_path / "base"), str(tmp_path / "side")
    assert torch_visualise.main(SYNTH + ["--output", base, "--max-images", "1"]) == 1
    torch_visualise.main(SYNTH + ["--output", side, "--max-images", "1", "--side-by-side"])
    jax_visualise.main(SYNTH + ["--output", str(tmp_path / "jax"), "--max-images", "1",
                                "--side-by-side"])
    one = imread_rgb(os.path.join(base, "000000_vis.jpg"))
    two = imread_rgb(os.path.join(side, "000000_vis.jpg"))
    assert two.shape == (one.shape[0], 2 * one.shape[1], 3)
    assert two.shape == imread_rgb(str(tmp_path / "jax" / "000000_vis.jpg")).shape


def _psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0**2 / mse)


def _gif_frames(path: str):
    im = Image.open(path)
    frames = [np.asarray(f.convert("RGB")) for f in ImageSequence.Iterator(im)]
    return frames, Image.open(path).info


@pytest.mark.parametrize("fps,max_width", [(25.0, 0), (30.0, 200)])
def test_visualise_gif_holds_jax_pil_gif(fps, max_width, tmp_path):
    """Frame count, size, duration and loop equal JAX's PIL GIF; each
    frame's PSNR against its drawn frame at most 1 dB below PIL's."""
    common = SYNTH + ["--max-images", "5", "--side-by-side", "--gif", "out.gif", "--fps",
                      str(fps), "--gif-max-width", str(max_width)]
    torch_visualise.main(common + ["--output", str(tmp_path / "port")])
    jax_visualise.main(common + ["--output", str(tmp_path / "jax")])
    got, got_info = _gif_frames(str(tmp_path / "port" / "out.gif"))
    want, want_info = _gif_frames(str(tmp_path / "jax" / "out.gif"))
    assert len(got) == len(want) == 5
    assert got[0].shape == want[0].shape
    assert (got_info["duration"], got_info["loop"]) == (want_info["duration"], want_info["loop"])
    for i, (g, w) in enumerate(zip(got, want)):
        # each package's drawn frame: its _vis.jpg is the drawing through JPEG, so
        # redraw from the dataset instead of decoding it
        port_vis = _drawn(torch_visualise, i, max_width)
        jax_vis = _drawn(jax_visualise, i, max_width)
        assert _psnr(g, port_vis) >= _psnr(w, jax_vis) - 1.0, i


def _drawn(cli, i: int, max_width: int) -> np.ndarray:
    """Frame ``i`` as ``cli`` draws it for ``--side-by-side`` (GT on both
    panels, no detections), scaled as for the GIF."""
    ds, _ = cli.get_dataset("synthetic", "synthetic", split="val")
    img, label = ds[i]
    gt = cli.draw_detections(img, label[:, :4], label[:, 4], np.ones(len(label)),
                             list(ds.classes), thresh=0.0)
    vis = np.concatenate([gt, img], axis=1)
    if max_width and vis.shape[1] > max_width:
        h = int(vis.shape[0] * (max_width / vis.shape[1]))
        vis = resize_plain(vis, (h, max_width))[0]
    return vis


def test_visualise_video_writes_avi_and_refuses_other_containers(tmp_path):
    out = str(tmp_path / "vis")
    torch_visualise.main(SYNTH + ["--output", out, "--max-images", "4", "--video", "v.avi",
                                  "--fps", "12.5"])
    frames = [f for _, f in iterate_frames(os.path.join(out, "v.avi"))]
    assert len(frames) == 4
    assert frames[0].shape == imread_rgb(os.path.join(out, "000000_vis.jpg")).shape
    cap = cv2.VideoCapture(os.path.join(out, "v.avi"), cv2.CAP_FFMPEG)  # MPEG-4 Part 2
    assert cap.get(cv2.CAP_PROP_FPS) == pytest.approx(12.5)
    cap.release()
    with pytest.raises(ValueError, match="FFmpeg"):
        torch_visualise.main(SYNTH + ["--output", str(tmp_path / "no"), "--video", "v.mkv"])
    assert not os.path.exists(tmp_path / "no")


def test_gif_encoder_round_trips_through_pil(tmp_path):
    """LZW past the 4096-code table (clear codes) and the block layout: a
    256-colour frame decodes exactly; a frame of few colours keeps them."""
    rng = np.random.default_rng(0)
    palette = rng.integers(0, 256, (256, 3), dtype=np.uint8)
    noisy = palette[rng.integers(0, 256, (150, 200))]
    flat = np.concatenate([np.full((40, 200, 3), 7, np.uint8),
                           palette[rng.integers(0, 100, (110, 200))]], 0)
    write_gif(str(tmp_path / "g.gif"), [noisy, flat], duration_ms=33, loop=2)
    frames, info = _gif_frames(str(tmp_path / "g.gif"))
    np.testing.assert_array_equal(frames[0], noisy)
    np.testing.assert_array_equal(frames[1], flat)
    assert (info["duration"], info["loop"]) == (30, 2)
    pal, idx = quantize(np.zeros((4, 4, 3), np.uint8) + 9)
    assert pal.tolist() == [[9, 9, 9]] and not idx.any()
    assert lzw(np.zeros(1, np.uint8))[:1] == bytes([0])  # the clear code, 9 bits, LSB first


def test_extract_frames_equals_jax(tmp_path, capsys, jax_reads_mjpeg):
    video = write_video(str(tmp_path / "v.avi"), photo_frames(10, seed=4), 10, "opencv")
    lines = {}
    for name, main in (("port", torch_extract.main), ("jax", jax_extract.main)):
        main(["--input", video, "--output", str(tmp_path / name), "--every", "2"])
        main(["--input", video, "--output", str(tmp_path / f"{name}_png"), "--ext", "png"])
        lines[name] = capsys.readouterr().out.splitlines()
    files = sorted(os.listdir(tmp_path / "port"))
    assert len(files) == 5 and files[0] == "00000000.jpg"
    assert files == sorted(os.listdir(tmp_path / "jax"))
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f
    pngs = sorted(os.listdir(tmp_path / "port_png"))
    assert pngs == sorted(os.listdir(tmp_path / "jax_png")) and len(pngs) == 10
    for f in pngs:
        np.testing.assert_array_equal(imread_rgb(str(tmp_path / "port_png" / f)),
                                      imread_rgb(str(tmp_path / "jax_png" / f)))
    timing = re.compile(r"done: (\d+) frames in .*")
    for got, want in zip(lines["port"], lines["jax"]):
        if timing.match(got):
            assert timing.match(got).group(1) == timing.match(want).group(1)
        else:
            assert got.replace("port", "jax") == want
    assert len(lines["port"]) == len(lines["jax"]) == 4


def test_extract_frames_multi_input_and_refusals(tmp_path):
    a = write_video(str(tmp_path / "a.avi"), photo_frames(4), 10, "port")
    b = write_video(str(tmp_path / "b.avi"), photo_frames(3), 10, "port")
    assert torch_extract.main(["--input", f"{a},{b}", "--output", str(tmp_path / "o")]) == 7
    assert sorted(os.listdir(tmp_path / "o")) == ["a", "b"]
    assert len(os.listdir(tmp_path / "o" / "b")) == 3
    with pytest.raises(ValueError, match="H.264.*FFmpeg"):
        torch_extract.main(["--input", f"{a},{h264_mp4(str(tmp_path / 'c.mp4'))}", "--output",
                            str(tmp_path / "none")])
    assert not os.path.exists(tmp_path / "none")
