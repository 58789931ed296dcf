"""The port stands alone: no JAX, no Flax, nothing of ``viddet_tpu``, no
OpenCV (it resizes in its own integer arithmetic, bit for bit OpenCV's) and
no PIL, and its image codec links no image library (it decodes and encodes
in its own C++, bit for bit libjpeg-turbo's and libpng's results)."""

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
        "viddet_tpu_torch.train.losses, viddet_tpu_torch.data.clip_transforms; "
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


def test_codec_build_links_no_image_library():
    """One ``g++`` call, with no ``-l`` flag: no libjpeg, libpng or zlib."""
    from viddet_tpu_torch.native import build_command

    cmd = build_command(Path("libviddet_codec.so"))
    assert cmd[0] == "g++"
    assert not {"-ljpeg", "-lpng", "-lz"} & set(cmd)
    assert [a for a in cmd if a.startswith("-l") or a == "-pthread"] == ["-pthread"]
