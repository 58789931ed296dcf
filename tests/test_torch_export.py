"""Deployment export in the port (``viddet_tpu_torch/infer/export.py``,
``cli/export_model.py``) against ``tests/unit/test_export.py``'s contract.

A saved artifact (a) equals the direct predictor on the same route bit for
bit (on one device the program runs the eager operations: no
decomposition), (b) takes any batch when exported with a dynamic one,
(c) runs in a process that imports no ``viddet_tpu_torch`` (the plain
route needs only ``torch``), and (d) refuses unsound device and kernel
combinations.  Against JAX: the port's plain artifact and JAX's ``xla`` CPU
artifact give the same detections on the same weights and uint8 frames at
the golden tolerances (ids exact, scores 1e-5, boxes 1e-3; the convolutions
sum in another order).  ``torch.library.opcheck`` holds every registered
kernel op (schema, fake implementation, dispatch) on the CPU.
"""

import dataclasses
import functools
import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_detector_helpers import one_torch_thread  # noqa: F401 (a fixture)
from viddet_tpu_torch import ops
from viddet_tpu_torch.core.precision import FLOAT32_POLICY
from viddet_tpu_torch.infer.export import (
    SAVEDMODEL_REFUSAL,
    ExportSpec,
    build_infer_fn,
    export_predictor,
    export_savedmodel,
    kernel_ops,
    load_artifact,
    save_artifact,
)
from viddet_tpu_torch.models.yolo3 import YOLOv3
from viddet_tpu_torch.weights import load_flat, seeded_flat

SPEC = ExportSpec(image_size=64, batch=None, input_dtype="uint8", platforms=("cpu",),
                  nms_backend="plain", topk=32, post_nms=8)


def _tiny_yolo(policy=FLOAT32_POLICY, num_classes=2):
    model = YOLOv3(num_classes=num_classes, backbone="tiny", policy=policy)
    model = model.to(memory_format=torch.channels_last).eval()
    load_flat(model, seeded_flat(model, seed=0))
    return model


def _frames(b: int, seed: int = 0, size: int = 64) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 256, (b, size, size, 3),
                                                                 np.uint8))


def _equal(got, want) -> None:
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)


@functools.lru_cache(maxsize=None)
def _tiny_artifact(tmp: str):
    model = _tiny_yolo()
    program = export_predictor(model, SPEC)
    path = f"{tmp}/tiny.pt2"
    save_artifact(program, path, meta={"model": "tiny-test"})
    return model, program, path


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return _tiny_artifact(str(tmp_path_factory.mktemp("export")))


def test_roundtrip_and_batch_polymorphic(tiny):
    model, program, path = tiny
    assert kernel_ops(program) == []
    art = load_artifact(path)
    frames = _frames(2)
    infer = build_infer_fn(model, SPEC)
    with torch.no_grad():
        _equal(art(frames), infer(frames))
        ids1, sc1, bx1 = art(frames[:1])  # the dynamic batch serves any leading dim
        _equal((ids1, sc1, bx1), infer(frames[:1]))
        ids5, _, _ = art(_frames(5, seed=1))
    assert ids1.shape == (1, 8) and bx1.shape == (1, 8, 4) and ids5.shape == (5, 8)
    sidecar = json.loads(open(path + ".json").read())
    assert sidecar["model"] == "tiny-test" and sidecar["platforms"] == ["cpu"]
    assert sidecar["in_specs"][0].startswith("uint8[") and sidecar["kernel_ops"] == []
    assert len(sidecar["out_specs"]) == 3


def test_artifact_runs_without_framework(tiny):
    """A plain artifact loads and runs with torch alone: in a subprocess
    whose modules never include viddet_tpu_torch, bitwise as in-process."""
    _, _, path = tiny
    frames = _frames(1, seed=3)
    with torch.no_grad():
        want = load_artifact(path)(frames)
    np.save(path + ".frames.npy", frames.numpy())
    code = (  # on as many torch threads as here: the conv's sums in the same order
        "import sys, numpy as np, torch\n"
        f"torch.set_num_threads({torch.get_num_threads()})\n"
        f"m = torch.export.load({path!r}).module()\n"
        f"x = torch.from_numpy(np.load({path + '.frames.npy'!r}))\n"
        "with torch.no_grad():\n"
        "    ids, sc, bx = m(x)\n"
        "assert not [k for k in sys.modules if k.startswith('viddet')], 'framework imported'\n"
        "np.save(sys.argv[1], np.concatenate([ids.numpy().ravel(), sc.numpy().ravel(),\n"
        "                                     bx.numpy().ravel()]))\n"
    )
    out = path + ".out.npy"
    subprocess.run([sys.executable, "-c", code, out], capture_output=True, text=True,
                   timeout=300, check=True, cwd="/")
    got = np.load(out)
    np.testing.assert_array_equal(got, np.concatenate([t.numpy().ravel() for t in want]))


def test_ssd_export_roundtrip(tmp_path):
    from viddet_tpu_torch.models.ssd import SSD

    model = SSD(3, 64, FLOAT32_POLICY, backbone_blocks=(1, 1, 1, 1),
                backbone_widths=(8, 16, 32, 64)).to(memory_format=torch.channels_last).eval()
    load_flat(model, seeded_flat(model, seed=1))
    spec = ExportSpec(image_size=64, batch=2, input_dtype="float32", platforms=("cpu",),
                      topk=16, post_nms=4)
    path = str(tmp_path / "ssd.pt2")
    save_artifact(export_predictor(model, spec), path)
    frames = torch.from_numpy(np.random.default_rng(1).random((2, 64, 64, 3), np.float32))
    with torch.no_grad():
        _equal(load_artifact(path)(frames), build_infer_fn(model, spec)(frames))


def test_frcnn_and_int8_export_roundtrip(tmp_path):
    """Faster R-CNN (its proposal NMS and ROIAlign pinned to the plain
    route) and a calibrated int8 YOLOv3 (the folded weights, the codes and
    the int8 conv in the graph) round-trip bit for bit."""
    from tests.test_torch_frcnn import COUNTS
    from viddet_tpu_torch import quant
    from viddet_tpu_torch.core.precision import Policy
    from viddet_tpu_torch.models.faster_rcnn import FasterRCNN, FRCNNConfig

    counts = dict(COUNTS, rpn_pre_nms_topk=16, rpn_nms_input=16, rpn_post_nms_test=8)
    frcnn = FasterRCNN(3, FRCNNConfig(**counts), FLOAT32_POLICY, backbone_blocks=(1, 1, 1, 1),
                       backbone_widths=(8, 16, 32, 64)).to(memory_format=torch.channels_last)
    frcnn = frcnn.eval()
    load_flat(frcnn, seeded_flat(frcnn, seed=2))
    int8 = _tiny_yolo(Policy(compute_dtype=torch.float32, quant="int8"))
    quant.calibrate(int8, [_frames(2, seed=4).float() / 255.0])
    for name, model, size in (("frcnn", frcnn, 64), ("int8", int8, 64)):
        spec = ExportSpec(image_size=size, batch=2, platforms=("cpu",), topk=16, post_nms=4)
        path = str(tmp_path / f"{name}.pt2")
        program = export_predictor(model, spec)
        assert kernel_ops(program) == []
        save_artifact(program, path)
        frames = _frames(2, seed=5, size=size)
        with torch.no_grad():
            want = build_infer_fn(model, spec)(frames)
            _equal(load_artifact(path)(frames), want)
    assert frcnn.config.nms_backend == "auto"  # restored after tracing


def test_cuda_backend_requires_cuda_only_platforms():
    with pytest.raises(ValueError, match="nms_backend='cuda'"):
        ExportSpec(platforms=("cpu",), nms_backend="cuda").validate()
    with pytest.raises(ValueError, match="one device"):
        ExportSpec(platforms=("cpu", "cuda")).validate()
    with pytest.raises(ValueError, match="one device"):
        ExportSpec(platforms=("tpu",)).validate()
    with pytest.raises(ValueError, match="nms_backend"):
        ExportSpec(platforms=("cpu",), nms_backend="pallas").validate()
    ExportSpec(platforms=("cuda",), nms_backend="cuda").validate()
    model = _tiny_yolo()
    with pytest.raises(ValueError, match="exported from a model on that device"):
        export_predictor(model, ExportSpec(platforms=("cuda",)))


def test_export_cli_writes_artifact(tmp_path):
    from viddet_tpu_torch.cli import export_model

    out = str(tmp_path / "cli.pt2")
    export_model.main([
        "--network", "yolo3_tiny_darknet", "--dataset", "voc", "--image-size", "64",
        "--batch", "1", "--platforms", "cpu", "--topk", "16", "--post-nms", "4", "--out", out,
    ])
    with torch.no_grad():
        ids, sc, bx = load_artifact(out)(torch.zeros((1, 64, 64, 3), dtype=torch.uint8))
    assert bx.shape == (1, 4, 4)
    sidecar = json.loads((tmp_path / "cli.pt2.json").read_text())
    assert sidecar["model"] == "yolo3_tiny_darknet_voc" and len(sidecar["classes"]) == 20


def test_savedmodel_refused(tmp_path):
    from viddet_tpu_torch.cli import export_model

    with pytest.raises(SystemExit, match="no torch route"):
        export_model.main(["--platforms", "cpu", "--savedmodel", str(tmp_path / "sm"),
                           "--out", str(tmp_path / "x.pt2")])
    assert not (tmp_path / "x.pt2").exists()
    with pytest.raises(NotImplementedError, match="no torch route"):
        export_savedmodel(None, str(tmp_path / "sm"))
    assert "no torch route" in SAVEDMODEL_REFUSAL


def test_plain_artifact_matches_jax_xla_artifact(tmp_path):
    """The same weights (JAX's init, through ``weights.load_flat``) and the
    same uint8 frames through JAX's ``xla`` CPU artifact and the port's
    plain one."""
    from viddet_tpu.core.precision import FLOAT32_POLICY as JAX_F32
    from viddet_tpu.infer import export as jexport
    from viddet_tpu.models.yolo3 import YOLOv3 as JaxYOLOv3
    from viddet_tpu.train.state import _flatten

    module = JaxYOLOv3(num_classes=2, backbone="tiny", policy=JAX_F32)
    variables = jax.jit(lambda x: module.init(jax.random.key(0), x, train=False))(
        jnp.zeros((1, 64, 64, 3)))
    jspec = jexport.ExportSpec(image_size=64, batch=2, input_dtype="uint8",
                               platforms=("cpu",), nms_backend="xla", topk=32, post_nms=8)
    jpath = str(tmp_path / "tiny.shlo")
    jexport.save_artifact(jexport.export_predictor(module, variables, jspec), jpath)
    frames = _frames(2, seed=7)
    want = [np.asarray(a) for a in jexport.load_artifact(jpath).call(frames.numpy())]

    flat = _flatten({"params": variables["params"]})
    flat.update(_flatten({"batch_stats": variables["batch_stats"]}))
    model = YOLOv3(num_classes=2, backbone="tiny", policy=FLOAT32_POLICY)
    model = model.to(memory_format=torch.channels_last).eval()
    load_flat(model, flat)
    path = str(tmp_path / "tiny.pt2")
    save_artifact(export_predictor(model, dataclasses.replace(SPEC, batch=2)), path)
    with torch.no_grad():
        got = [t.numpy() for t in load_artifact(path)(frames)]
    assert int((want[0] >= 0).sum()) >= 8
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-3)


def _op_args(name: str):
    from viddet_tpu_torch.ops import nms_gather_cuda

    g = torch.Generator().manual_seed(0)
    na, c = 3, 12
    cells = [torch.randn(2, 4, na * (5 + c), generator=g), torch.randn(2, 16, na * (5 + c),
                                                                        generator=g)]
    meta = ((4, 2, 32, ((10.0, 13.0), (16.0, 30.0), (33.0, 23.0))),
            (16, 4, 16, ((30.0, 61.0), (62.0, 45.0), (59.0, 119.0))))
    a_idx = torch.randint(0, 60, (2, 20), generator=g)
    margs = nms_gather_cuda.meta_args(meta)
    boxes = torch.rand(2, 20, 4, generator=g)
    boxes[..., 2:] += boxes[..., :2]
    if name == "anchor_scores":
        return cells, na
    if name == "topk_indices":
        return torch.rand(3, 50, generator=g), 5
    if name == "gather_decode_pairs":
        return cells, a_idx, *margs, na
    if name == "gather_decode_top_m":
        return cells, a_idx, *margs, na, 3, 4
    if name == "finalize_candidates":
        b, _, i_m, _, hot_idx = torch.ops.viddet.gather_decode_top_m(cells, a_idx, *margs, na,
                                                                     3, 4)
        return i_m, hot_idx, torch.randint(0, 20 * 2 + 4 * c, (2, 10), generator=g), b, c
    if name == "nms_keep_mask":
        return boxes, torch.rand(2, 20, generator=g) > 0.2, 0.45
    if name == "compact_and_pad":
        keep = (torch.rand(2, 20, generator=g) > 0.5).float()
        return keep, torch.rand(2, 20, generator=g), torch.rand(2, 20, generator=g), boxes, 8
    if name == "multilevel_roi_align":
        pyramid = [torch.randn(2, s, s, 8, generator=g) for s in (32, 16, 8, 4)]
        rois = torch.rand(2, 5, 4, generator=g) * 60
        rois[..., 2:] += rois[..., :2]
        return pyramid, rois, [4, 8, 16, 32], 7, 2, 2
    x = torch.randn(2, 8, 6, 6, generator=g).contiguous(memory_format=torch.channels_last)
    return (x, torch.randn(16, 8, 3, 3, generator=g), torch.rand(16, generator=g),
            torch.rand(16, generator=g), torch.rand(16, generator=g),
            torch.rand(16, generator=g) + 0.5, 1e-5, 0.1)


@pytest.mark.parametrize("name", ops.OP_NAMES)
def test_registered_op_passes_opcheck(name):
    op = getattr(torch.ops.viddet, name).default
    result = torch.library.opcheck(op, _op_args(name))
    assert set(result.values()) == {"SUCCESS"}, result
