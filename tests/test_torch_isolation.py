"""The port stands alone: no JAX, no Flax, nothing of ``viddet_tpu``, no
OpenCV (it resizes in its own integer arithmetic, bit for bit OpenCV's) and
no PIL, and its native library (image codec, MPEG-4 Part 2 and VP8
decoders, video frames) links no image or video library (it decodes and
encodes in its own C++, bit for bit libjpeg-turbo's, libpng's and
libavcodec's results, and walks AVI, MP4 / QuickTime and Matroska / WebM
files in Python)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "viddet_tpu_torch"
FORBIDDEN = ("jax", "flax", "viddet_tpu", "cv2", "PIL")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import(path):
    bad = [name for name in _imports(path) if _forbidden(name)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_import_leaves_jax_unloaded():
    code = (
        "import sys, viddet_tpu_torch.cli.common, viddet_tpu_torch.infer.service, "
        "viddet_tpu_torch.weights, viddet_tpu_torch.kernels.build, "
        "viddet_tpu_torch.cli.evaluate, viddet_tpu_torch.data.loader, "
        "viddet_tpu_torch.eval.coco_eval, viddet_tpu_torch.native, "
        "viddet_tpu_torch.cli.serve, viddet_tpu_torch.cli.detect, "
        "viddet_tpu_torch.infer.stream, viddet_tpu_torch.infer.multistream, "
        "viddet_tpu_torch.cli.train_yolov3, viddet_tpu_torch.train.loop, "
        "viddet_tpu_torch.cli.train_ssd, viddet_tpu_torch.cli.train_faster_rcnn, "
        "viddet_tpu_torch.train.state, viddet_tpu_torch.train.targets, "
        "viddet_tpu_torch.train.losses, viddet_tpu_torch.data.clip_transforms, "
        "viddet_tpu_torch.native.avi, viddet_tpu_torch.native.mp4, viddet_tpu_torch.native.mkv, "
        "viddet_tpu_torch.native.webp, viddet_tpu_torch.native.gif, viddet_tpu_torch.native.pnm, "
        "viddet_tpu_torch.utils.video, "
        "viddet_tpu_torch.utils.gif, "
        "viddet_tpu_torch.cli.extract_frames, viddet_tpu_torch.cli.visualise, "
        "viddet_tpu_torch.quant, viddet_tpu_torch.infer.export, viddet_tpu_torch.ops, "
        "viddet_tpu_torch.cli.export_model; "
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'viddet_tpu', 'cv2', 'PIL')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_resolve_device_raises_without_cuda(monkeypatch):
    from viddet_tpu_torch.core.platform import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_entry_points_default_to_cuda(monkeypatch):
    from viddet_tpu_torch.models.zoo import get_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("yolo3_tiny_darknet_coco", "faster_rcnn_resnet50_fpn_coco"):
        with pytest.raises(RuntimeError):
            get_model(name)


def test_wrappers_never_fall_back_for_cuda_tensors():
    """A wrapper given a non-CPU tensor it cannot launch on raises; it
    never runs the plain version instead."""
    from viddet_tpu_torch.ops import conv_cuda, nms_cuda, nms_gather_cuda, roi_align_cuda, topk_cuda

    meta = torch.zeros((2, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        topk_cuda.topk_indices(meta, 3)
    with pytest.raises(ValueError, match="CUDA"):
        nms_cuda.nms_keep_mask(torch.zeros((2, 8, 4), device="meta"),
                               torch.zeros((2, 8), dtype=torch.bool, device="meta"), 0.5)
    cells = [torch.zeros((2, 4, 3 * 25), device="meta")]
    anchors = ((10.0, 13.0), (33.0, 23.0), (373.0, 326.0))
    idx = torch.zeros((2, 5), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        nms_gather_cuda.gather_decode_pairs(cells, idx, ((4, 2, 32, anchors),), 9, 2)
    with pytest.raises(ValueError, match="CUDA"):
        nms_gather_cuda.finalize_candidates(
            torch.zeros((2, 5, 9), dtype=torch.int64, device="meta"),
            torch.zeros((2, 1, 2), dtype=torch.int64, device="meta"), idx,
            torch.zeros((2, 5, 4), device="meta"), 20)
    x = torch.zeros((1, 8, 4, 4), device="meta").contiguous(memory_format=torch.channels_last)
    vec = torch.ones(16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        conv_cuda.conv_down2_bn_leaky(x, torch.zeros((16, 8, 3, 3), device="meta"),
                                      vec, vec, vec, vec)
    pyramid = [torch.zeros((2, 8 // s, 8 // s, 16), device="meta") for s in (1, 2)]
    with pytest.raises(ValueError, match="CUDA"):
        roi_align_cuda.multilevel_roi_align(pyramid, torch.zeros((2, 3, 4), device="meta"),
                                            (4, 8))
    with pytest.raises(ValueError, match="CUDA"):
        nms_gather_cuda.anchor_scores(cells, 3)
    with pytest.raises(ValueError, match="CUDA"):
        nms_gather_cuda.gather_decode_pairs(cells, idx, ((4, 2, 32, anchors),))
    with pytest.raises(ValueError, match="CUDA"):
        nms_cuda.compact_and_pad(*(torch.zeros((2, 8), device="meta"),) * 3,
                                 torch.zeros((2, 8, 4), device="meta"), 4)


def test_custom_ops_launch_or_raise_for_cuda():
    """Each ``torch.ops.viddet`` op's CUDA implementation launches its
    kernel or raises; given tensors it cannot launch on (meta here) it
    raises before any launch, and never runs the plain version."""
    from viddet_tpu_torch.ops import conv_cuda, nms_cuda, nms_gather_cuda, roi_align_cuda, topk_cuda

    m = "meta"
    cells = [torch.zeros((2, 4, 3 * 25), device=m)]
    idx = torch.zeros((2, 5), dtype=torch.int64, device=m)
    margs = nms_gather_cuda.meta_args(((4, 2, 32, ((10.0, 13.0), (33.0, 23.0), (373.0, 326.0))),))
    vec = torch.ones(16, device=m)
    calls = [
        (topk_cuda._topk_indices_cuda, (torch.zeros((2, 8), device=m), 3)),
        (nms_cuda._nms_keep_mask_cuda, (torch.zeros((2, 8, 4), device=m),
                                        torch.zeros((2, 8), dtype=torch.bool, device=m), 0.5)),
        (nms_cuda._compact_and_pad_cuda, (*(torch.zeros((2, 8), device=m),) * 3,
                                          torch.zeros((2, 8, 4), device=m), 4)),
        (nms_gather_cuda._anchor_scores_cuda, (cells, 3)),
        (nms_gather_cuda._gather_decode_pairs_cuda, (cells, idx, *margs, 3)),
        (nms_gather_cuda._gather_decode_top_m_cuda, (cells, idx, *margs, 3, 9, 2)),
        (nms_gather_cuda._finalize_candidates_cuda, (
            torch.zeros((2, 5, 9), dtype=torch.int64, device=m),
            torch.zeros((2, 1, 2), dtype=torch.int64, device=m), idx,
            torch.zeros((2, 5, 4), device=m), 20)),
        (roi_align_cuda._roi_align_cuda, ([torch.zeros((2, 8, 8, 16), device=m)],
                                          torch.zeros((2, 3, 4), device=m), [4], 7, 2, 2)),
        (conv_cuda._conv_down2_cuda, (
            torch.zeros((1, 8, 4, 4), device=m).contiguous(memory_format=torch.channels_last),
            torch.zeros((16, 8, 3, 3), device=m), vec, vec, vec, vec, 1e-5, 0.1)),
    ]
    assert len(calls) == len(__import__("viddet_tpu_torch.ops", fromlist=["OP_NAMES"]).OP_NAMES)
    for fn, args in calls:
        with pytest.raises(ValueError, match="CUDA"):
            fn(*args)


def test_int8_conv_never_takes_the_float64_route_off_the_cpu(monkeypatch):
    """The int8 conv's plain float64 route is for CPU tensors only: another
    device takes the card route (``torch._int_mm``, which raises for a shape
    it refuses) or raises; it is never sent to float64."""
    from viddet_tpu_torch import quant

    def plain(*_):
        raise AssertionError("the float64 route ran")

    monkeypatch.setattr(quant, "conv_acc_plain", plain)
    xq = torch.zeros((1, 6, 6, 8), dtype=torch.int8, device="meta")
    wq = torch.zeros((16, 3, 3, 8), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        quant.conv_acc(xq, wq, 1)
    assert quant.conv_acc_card(xq, wq, 2).shape == (1, 3, 3, 16)  # im2col and _int_mm only


def test_codec_build_links_no_image_library():
    """One ``g++ -c`` call per repository source (``codec.cpp``, the VP8
    decoder ``vp8.cpp``, the VP9 decoder ``vp9.cpp``, the MPEG-4 encoder
    ``mpeg4enc.cpp``, WebP's bitstreams ``webp.cpp`` and GIF's LZW
    ``gif.cpp``) and one link of their objects, with no ``-l`` flag
    anywhere: no libjpeg, libpng, zlib, libvpx, libwebp, giflib or FFmpeg."""
    from viddet_tpu_torch.native import build_command, compile_commands

    compiles = compile_commands(Path("objects"))
    link = build_command(Path("libviddet_codec.so"), Path("objects"))
    names = ["codec", "vp8", "vp9", "mpeg4enc", "webp", "gif"]
    assert [[Path(a).name for a in cmd if a.endswith(".cpp")] for cmd in compiles] == [
        [n + ".cpp"] for n in names]
    assert all(cmd[0] == "g++" and "-c" in cmd for cmd in compiles)
    assert link[0] == "g++" and "-shared" in link
    assert [Path(a).name for a in link if a.endswith(".o")] == [n + ".o" for n in names]
    for cmd in compiles + [link]:
        assert not {"-ljpeg", "-lpng", "-lz", "-lvpx", "-lavcodec", "-lwebp", "-lgif"} & set(cmd)
        assert not [a for a in cmd if a.startswith("-l")]
    assert [a for a in link if a == "-pthread"] == ["-pthread"]


def test_native_library_needs_no_image_or_video_library():
    """The built library's dynamic dependencies are the C and C++ runtimes
    only: no libjpeg, libpng, zlib, libvpx, libwebp, giflib, libav* (FFmpeg),
    swscale or V4L2."""
    import re

    from viddet_tpu_torch.native import build

    proc = subprocess.run(["readelf", "-d", str(build())], capture_output=True, text=True,
                          timeout=60)
    assert proc.returncode == 0, proc.stderr
    needed = re.findall(r"\(NEEDED\)\s+Shared library: \[([^\]]+)\]", proc.stdout)
    assert needed and "libc.so.6" in needed
    allowed = ("libc.so", "libstdc++.so", "libm.so", "libgcc_s.so", "libpthread.so",
               "ld-linux")
    assert [n for n in needed if not n.startswith(allowed)] == [], needed


def test_video_code_includes_and_imports_nothing_outside():
    """``codec.cpp`` (JPEG, PNG, the MPEG-4 Part 2 decoder, the video
    stream), ``vp8.cpp`` and ``vp8.h`` (the VP8 decoder), ``vp9.cpp`` and
    ``vp9.h`` (the VP9 decoder), ``mpeg4enc.cpp`` (the MPEG-4 Part 2
    encoder), ``mpeg4.h`` (what the MPEG-4 decoder and encoder share),
    ``webp.cpp`` (WebP's bitstreams) and ``gif.cpp`` (GIF's LZW) include C++
    standard headers and the port's three headers only (no ``webp/decode.h``,
    ``gif_lib.h``, ``png.h`` or OpenCV header); ``native/mp4.py``,
    ``native/avi.py``, ``native/mkv.py``, ``native/webp.py``,
    ``native/gif.py``, ``native/pnm.py`` and ``utils/video.py`` import the
    standard library, numpy and the port (no cv2 or PIL)."""
    import re

    standard = {"algorithm", "array", "cmath", "condition_variable", "cstdarg", "cstddef",
                "cstdint", "cstdio", "cstdlib", "cstring", "memory", "mutex", "new", "string",
                "thread", "vector"}
    for name in ("codec.cpp", "vp8.cpp", "vp8.h", "vp9.cpp", "vp9.h", "mpeg4enc.cpp", "mpeg4.h",
                 "webp.cpp", "gif.cpp"):
        includes = set(re.findall(r'#include\s*[<"]([^>"]+)[>"]',
                                  (PORT / "native" / name).read_text()))
        assert includes <= standard | {"vp8.h", "vp9.h", "mpeg4.h"}, (name, includes - standard)
    allowed = {"__future__", "dataclasses", "fractions", "math", "mmap", "os", "struct",
               "typing", "numpy", "viddet_tpu_torch"}
    for name in ("native/mp4.py", "native/avi.py", "native/mkv.py", "utils/video.py"):
        tops = {m.split(".")[0] for m in _imports(PORT / name)}
        assert tops <= allowed, (name, tops - allowed)
