"""The port's detect CLI over images (``viddet_tpu_torch.cli.detect``) and its
drawing helpers, against the JAX package's, on the CPU (mirrors
``tests/integration/test_cli.py::test_detect_cli_images``).

Both CLIs load one ``.npz`` (JAX's initial weights of the tiny YOLOv3 over
VOC), build the model in float32 and run their deterministic tail (JAX's
XLA chain, the port under ``VIDDET_PAIR_TOPK=det``), over a directory of
JPEG, PNG and BMP files.  JAX's batch route (the C++ decoder's DCT-domain
prescale) is switched off, so JAX takes its per-file route, the one the
port follows.  Every ``{stem}.txt`` equals JAX's line for line, and every
``{stem}_det.jpg`` decodes to the original's size.  A video the port cannot
read (not a Motion-JPEG ``.avi``) or a webcam index raises ValueError
before anything is written; ``tests/test_torch_video_stream.py`` holds the
video half.

``draw_detections`` holds the rectangles to ``cv2.rectangle``'s pixels and
JAX's colours, and draws nothing below the threshold or for padding rows;
its label text is a bitmap font, not OpenCV's Hershey font.
"""

import functools
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import viddet_tpu.cli.detect as jax_detect
import viddet_tpu.native as jax_native
import viddet_tpu_torch.cli.detect as torch_detect
from tests.torch_mkv_helpers import vp9_mkv
from tests.torch_mp4_helpers import h264_mp4
from viddet_tpu.core.precision import FLOAT32_POLICY as JAX_F32
from viddet_tpu.models.zoo import get_model as jax_get_model
from viddet_tpu.train.state import save_weights_npz
from viddet_tpu.utils.image import class_colors as jax_class_colors
from viddet_tpu.utils.image import draw_detections as jax_draw_detections
from viddet_tpu_torch.core.precision import FLOAT32_POLICY
from viddet_tpu_torch.data.base import imread_rgb
from viddet_tpu_torch.native import encode_png
from viddet_tpu_torch.utils.image import class_colors, draw_detections, draw_rectangle

SIZE = 64


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(0)
    for i in range(3):
        cv2.imwrite(str(d / f"img{i}.jpg"), rng.integers(0, 255, (90, 120, 3)).astype(np.uint8))
    (d / "wide.png").write_bytes(encode_png(rng.integers(0, 255, (40, 150, 3), np.uint8)))
    cv2.imwrite(str(d / "tall.bmp"), rng.integers(0, 255, (130, 60, 3)).astype(np.uint8))
    (d / "notes.txt").write_text("not an image")  # not collected
    return str(d)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    module, _ = jax_get_model("yolo3_tiny_darknet_voc", policy=JAX_F32)
    variables = module.init(jax.random.key(0), jnp.zeros((1, SIZE, SIZE, 3)), train=False)
    path = str(tmp_path_factory.mktemp("weights") / "tiny.npz")
    save_weights_npz(path, variables["params"], variables["batch_stats"])
    return path


def _run(main, image_dir, out, weights, *extra):
    main(["--network", "yolo3_tiny_darknet", "--dataset", "voc", "--input", image_dir,
          "--output", out, "--data-shape", str(SIZE), "--batch-size", "2", "--thresh", "0.0",
          "--weights", weights, "--save-detections", "--platform", "cpu", *extra])


def test_detect_cli_images_equal_jax(image_dir, weights, tmp_path, monkeypatch):
    monkeypatch.setattr(jax_detect, "build_model",
                        functools.partial(jax_detect.build_model, policy=JAX_F32))
    monkeypatch.setattr(torch_detect, "build_model",
                        functools.partial(torch_detect.build_model, policy=FLOAT32_POLICY))
    monkeypatch.setattr(jax_native, "available", lambda: False)  # JAX's per-file route
    monkeypatch.setenv("VIDDET_PAIR_TOPK", "det")
    jax.clear_caches()
    _run(jax_detect.main, image_dir, str(tmp_path / "jax"), weights)
    _run(torch_detect.main, image_dir, str(tmp_path / "port"), weights)
    jax_files = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == jax_files
    stems = ["img0", "img1", "img2", "tall", "wide"]
    assert jax_files == sorted([f"{s}.txt" for s in stems] + [f"{s}_det.jpg" for s in stems])
    lines = 0
    for stem in stems:
        got = (tmp_path / "port" / f"{stem}.txt").read_text()
        want = (tmp_path / "jax" / f"{stem}.txt").read_text()
        assert got == want, stem
        lines += len(got.splitlines())
        drawn = imread_rgb(str(tmp_path / "port" / f"{stem}_det.jpg"))
        assert drawn.shape == imread_rgb(os.path.join(image_dir, stem + (
            ".jpg" if stem.startswith("img") else ".png" if stem == "wide" else ".bmp"))).shape
    assert lines > 0


def test_detect_cli_no_draw_writes_text_only(image_dir, weights, tmp_path):
    _run(torch_detect.main, image_dir, str(tmp_path / "out"), weights, "--no-draw")
    assert sorted(os.listdir(tmp_path / "out")) == sorted(
        f"{s}.txt" for s in ("img0", "img1", "img2", "tall", "wide"))


@pytest.mark.parametrize("source", ["clip.mp4", "0", "a.mp4,b.avi", "CLIP.MKV"])
def test_unreadable_video_input_raises_naming_what_is_missing(source, tmp_path):
    """A CABAC H.264 track and a VP9 profile 1 (4:4:4) track need FFmpeg,
    and a webcam index capture support, none of which the port has (it reads
    CAVLC H.264, MPEG-4 Part 2, VP9 profile 0 and Motion-JPEG in the
    containers it knows)."""
    missing = "capture" if source == "0" else "FFmpeg"
    if ".mp4" in source:  # each .mp4 a CABAC H.264 one
        missing = "H.264.*CABAC.*FFmpeg"
        source = ",".join(h264_mp4(str(tmp_path / "in" / s)) if s.endswith(".mp4") else s
                          for s in source.split(","))
    if source == "CLIP.MKV":  # a Matroska file of a VP9 profile 1 (4:4:4) track
        missing = "VP9.*FFmpeg"
        source = vp9_mkv(str(tmp_path / "in" / source))
    out = tmp_path / "out"
    with pytest.raises(ValueError, match=missing):
        torch_detect.main(["--input", source, "--output", str(out), "--platform", "cpu"])
    assert not out.exists()  # raised before any model or output


def test_collect_inputs_equals_jax(image_dir, tmp_path):
    for path in (image_dir, os.path.join(image_dir, "img0.jpg"), "3", "a.mp4,b.webm",
                 "x.mov"):
        assert torch_detect.collect_inputs(path) == jax_detect.collect_inputs(path)
    with pytest.raises(ValueError):
        torch_detect.collect_inputs("a.mp4,b.jpg")


def test_class_colors_equal_jax():
    for n in (0, 1, 20, 80):
        np.testing.assert_array_equal(class_colors(n), jax_class_colors(n))


def test_draw_rectangle_equals_cv2():
    rng = np.random.default_rng(1)
    for _ in range(500):
        h, w = (int(v) for v in rng.integers(5, 60, 2))
        x1, x2 = (int(v) for v in rng.integers(-10, w + 10, 2))
        y1, y2 = (int(v) for v in rng.integers(-10, h + 10, 2))
        want = np.zeros((h, w, 3), np.uint8)
        cv2.rectangle(want, (x1, y1), (x2, y2), (10, 20, 30), 2)
        got = np.zeros((h, w, 3), np.uint8)
        draw_rectangle(got, x1, y1, x2, y2, (10, 20, 30))
        np.testing.assert_array_equal(got, want, err_msg=str((x1, y1, x2, y2, h, w)))


def test_draw_detections_rectangles_colours_and_threshold_equal_jax():
    """Below the label boxes (which hold text in different fonts) every pixel
    equals JAX's drawing; rows under the threshold or padded with -1 draw
    nothing."""
    rng = np.random.default_rng(2)
    image = rng.integers(0, 256, (120, 160, 3), dtype=np.uint8)
    names = [f"class{i}" for i in range(6)]
    boxes = np.array([[20.4, 40.6, 90.5, 100.2], [100, 50, 150, 110], [5, 60, 40, 80],
                      [60, 30, 120, 70], [0, 0, 0, 0]], np.float32)
    ids = np.array([1, 4, 2, 5, -1])
    scores = np.array([0.9, 0.6, 0.3, 0.55, 0.99], np.float32)
    got = draw_detections(image, boxes, ids, scores, names, thresh=0.5)
    want = jax_draw_detections(image, boxes, ids, scores, names, thresh=0.5)
    assert got.shape == want.shape and not np.shares_memory(got, image)
    drawn = ids >= 0
    drawn &= scores >= 0.5
    # a label box reaches its text's height + 6 rows above its box's top
    # edge: 13 in the bitmap font, under 24 in OpenCV's
    label_rows = np.zeros(image.shape[0], bool)
    for box in boxes[drawn]:
        top = int(round(box[1]))
        label_rows[max(top - 24, 0) : top + 1] = True
    np.testing.assert_array_equal(got[~label_rows], want[~label_rows])
    changed = (got != image).any(-1)
    assert changed.any()
    # the box under the threshold (id 2, its left edge at x = 5) is not drawn
    assert not changed[70, 3:8].any()
    colours = {tuple(int(c) for c in got[y, x]) for y, x in ((100, 20), (110, 150))}
    assert colours == {tuple(int(c) for c in jax_class_colors(6)[i]) for i in (1, 4)}
