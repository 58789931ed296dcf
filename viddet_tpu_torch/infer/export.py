"""Deployment export: a predictor as one self-contained artifact
(counterpart of ``viddet_tpu/infer/export.py``).

``export_predictor`` traces the predictor of ``cli/common.py``
``make_predictor`` with ``torch.export``: uint8 frames normalized in the
graph, the forward pass, box decode and the NMS tail, the weights carried
in the program, and a batch of ``None`` exported as a ``torch.export.Dim``.
``save_artifact`` writes the program as a ``.pt2`` (``torch.export.save``)
with a JSON sidecar (format, platforms, input and output specs, outputs,
the caller's meta); ``load_artifact`` reads it back as a module to call
on a batch.

Two NMS routes, as JAX's two backends:

* ``nms_backend="plain"`` (JAX: ``"xla"``): every kernel's plain PyTorch
  version, traced into aten operations.  Loading and running it needs
  only ``torch``, no ``viddet_tpu_torch`` (the tests run one in such a
  process).  The conv route is pinned to PyTorch's convolution while
  tracing, so that K8 never enters it.
* ``nms_backend="cuda"`` (JAX: ``"pallas"``, TPU only): the hand-written
  kernels, each a ``torch.ops.viddet`` custom op (``ops/__init__.py``),
  K7 too for Faster R-CNN and K8 under ``VIDDET_CONV_BACKEND=pallas``.
  ``platforms`` must be ``("cuda",)``, and a process that loads it imports
  ``viddet_tpu_torch.ops`` first, which registers the ops (JAX's TPU
  artifact needs no framework; ROADMAP Queue 3).

One device per artifact: a torch program bakes in the device of the
tensors it creates, so ``platforms`` is ``("cpu",)`` or ``("cuda",)``, and
the model is exported from that device; JAX lowers one artifact for
several platforms.  A TF SavedModel (``export_savedmodel``) has no torch
route and raises.

The traced program is not decomposed (no ``run_decompositions``): its
operations are the eager ones, so on one device it computes what the
direct predictor computes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
from typing import Optional, Sequence

import torch

from viddet_tpu_torch.core import platform
from viddet_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD

NMS_BACKENDS = ("plain", "cuda")
PLATFORMS = ("cpu", "cuda")
MAX_BATCH = 4096  # the dynamic batch's upper bound
SAVEDMODEL_REFUSAL = ("a TF SavedModel has no torch route: export a .pt2 with export_predictor "
                      "and save_artifact (cli.export_model without --savedmodel)")


@dataclasses.dataclass(frozen=True)
class ExportSpec:
    """Input and postprocess contract of one exported predictor."""

    image_size: int = 416
    batch: Optional[int] = None  # None = dynamic (any batch size)
    input_dtype: str = "uint8"  # "uint8" (normalized in the graph) or "float32"
    platforms: Sequence[str] = ("cuda",)
    nms_backend: str = "plain"
    # NMS knobs: None = the model family's own default (YOLOv3 / SSD
    # 0.45 / 0.01 / 400 / 100, Faster R-CNN 0.5 / 0.05 / 400 / 100)
    iou_thresh: Optional[float] = None
    valid_thresh: Optional[float] = None
    topk: Optional[int] = None
    post_nms: Optional[int] = None

    def validate(self) -> None:
        plats = tuple(self.platforms)
        if len(plats) != 1 or plats[0] not in PLATFORMS:
            raise ValueError(f"platforms={plats!r}: a torch program bakes in one device, so an "
                             f"artifact takes one of {PLATFORMS}, ('cpu',) or ('cuda',)")
        if self.nms_backend not in NMS_BACKENDS:
            raise ValueError(f"nms_backend {self.nms_backend!r} is not one of {NMS_BACKENDS}")
        if self.nms_backend == "cuda" and plats != ("cuda",):
            raise ValueError("nms_backend='cuda' launches the hand-written kernels, which run "
                             "only on the card; use platforms=('cuda',) or the portable "
                             "nms_backend='plain'")
        if self.input_dtype not in ("uint8", "float32"):
            raise ValueError(f"unsupported input_dtype {self.input_dtype!r}")


@contextlib.contextmanager
def _pinned_routes(model: torch.nn.Module, spec: ExportSpec):
    """The kernels' routes of ``spec`` for the enclosed calls: Faster
    R-CNN's proposal NMS and ROIAlign follow ``nms_backend``, and under
    "plain" the conv route is PyTorch's (K8 off)."""
    from viddet_tpu_torch.models.faster_rcnn import FasterRCNN

    backend = "auto" if spec.nms_backend == "cuda" else "plain"
    config = getattr(model, "config", None)
    conv = platform._conv_backend
    try:
        if isinstance(model, FasterRCNN):
            model.config = dataclasses.replace(config, nms_backend=backend, roi_backend=backend)
        if spec.nms_backend == "plain":
            platform.set_conv_backend("xla")
        yield
    finally:
        if isinstance(model, FasterRCNN):
            model.config = config
        platform._conv_backend = conv


def build_infer_fn(model: torch.nn.Module, spec: ExportSpec):
    """``infer(images) -> (ids, scores, boxes)`` with the NMS route pinned
    to ``spec.nms_backend`` (``make_predictor`` takes the tensor's device
    instead).  uint8 frames are ImageNet-normalized in the graph, as the
    predictor does."""
    from viddet_tpu_torch import quant
    from viddet_tpu_torch.models.faster_rcnn import FasterRCNN, frcnn_forward_and_postprocess
    from viddet_tpu_torch.models.ssd import SSD, ssd_forward_and_postprocess
    from viddet_tpu_torch.models.yolo3 import NMSConfig, forward_and_postprocess

    spec.validate()
    if quant.quant_cells(model):
        quant.check_calibrated(model)
    backend = "auto" if spec.nms_backend == "cuda" else "plain"
    kw = {k: v for k, v in (("iou_thresh", spec.iou_thresh), ("valid_thresh", spec.valid_thresh),
                            ("topk", spec.topk), ("post_nms", spec.post_nms)) if v is not None}
    if isinstance(model, SSD):
        nms = NMSConfig(backend=backend, **kw)

        def forward(images):
            return ssd_forward_and_postprocess(model, images, nms)
    elif isinstance(model, FasterRCNN):
        def forward(images):
            return frcnn_forward_and_postprocess(model, images, backend=backend, **kw)
    else:
        nms = NMSConfig(backend=backend, **kw)

        def forward(images):
            return forward_and_postprocess(model, images, nms)

    device = next(model.parameters()).device
    mean = torch.as_tensor(IMAGENET_MEAN, device=device)
    std = torch.as_tensor(IMAGENET_STD, device=device)

    def infer(images: torch.Tensor):
        with _pinned_routes(model, spec):
            if images.dtype == torch.uint8:
                images = (images.float() / 255.0 - mean) / std
            return forward(images)

    return infer


def _input_shape(model: torch.nn.Module, spec: ExportSpec, batch: int) -> tuple:
    """Temporal models take (B, k, H, W, 3) clips, the others (B, H, W, 3)."""
    k = getattr(model, "k", None)
    hw = (spec.image_size, spec.image_size, 3)
    return (batch, k) + hw if k is not None else (batch,) + hw


class _Predictor(torch.nn.Module):
    """The module ``torch.export`` traces: the model (its weights become the
    program's) and the predictor function."""

    def __init__(self, model: torch.nn.Module, infer):
        super().__init__()
        self.model = model
        self.infer = infer

    def forward(self, images: torch.Tensor):
        return self.infer(images)


def export_predictor(model: torch.nn.Module, spec: ExportSpec = ExportSpec()):
    """Trace the predictor of ``model`` for ``spec`` and return the
    ``torch.export.ExportedProgram`` (weights carried in the program).

    The model must be on ``spec.platforms``' device, in eval mode.  One
    eager call first fills the model's constant caches (decode constants,
    anchors) with real tensors, which the program then holds as
    constants.  A plain-route program holding a ``viddet`` op raises."""
    spec.validate()
    device = next(model.parameters()).device
    if device.type != spec.platforms[0]:
        raise ValueError(f"the model is on {device}; an artifact for {spec.platforms[0]!r} is "
                         f"exported from a model on that device")
    if model.training:
        raise ValueError("export_predictor takes a model in eval mode")
    infer = build_infer_fn(model, spec)
    dtype = torch.uint8 if spec.input_dtype == "uint8" else torch.float32
    example = torch.zeros(_input_shape(model, spec, spec.batch or 2), dtype=dtype, device=device)
    dynamic = None
    if spec.batch is None:
        dynamic = ({0: torch.export.Dim("batch", min=1, max=MAX_BATCH)},)
    with torch.no_grad():
        infer(example)
        program = torch.export.export(_Predictor(model, infer), (example,),
                                      dynamic_shapes=dynamic, strict=False)
    if spec.nms_backend == "plain" and kernel_ops(program):
        raise RuntimeError(f"a plain-route program holds {kernel_ops(program)}")
    return program


def kernel_ops(program) -> list:
    """The ``torch.ops.viddet`` ops in a program's graph, in order."""
    return [str(node.target) for node in program.graph.nodes
            if node.op == "call_function" and str(node.target).startswith("viddet.")]


def _specs(nodes) -> list:
    return [f"{str(v.dtype).replace('torch.', '')}{list(v.shape)}"
            for v in (n.meta.get("val") for n in nodes) if isinstance(v, torch.Tensor)]


def save_artifact(program, path: str, meta: Optional[dict] = None) -> None:
    """Write the program (``torch.export.save``, a ``.pt2``) and a JSON
    provenance sidecar ``<path>.json``."""
    if os.path.dirname(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.export.save(program, path)
    user_inputs = set(program.graph_signature.user_inputs)
    inputs = [n for n in program.graph.nodes if n.op == "placeholder" and n.name in user_inputs]
    outputs = list(program.graph.output_node().args[0])
    devices = sorted({str(n.meta["val"].device.type) for n in inputs})
    sidecar = {
        "format": "torch.export ExportedProgram (.pt2, torch.export.save)",
        "platforms": devices,
        "in_specs": _specs(inputs),
        "out_specs": _specs(outputs),
        "outputs": ["class_ids (-1 = empty slot)", "scores", "boxes xyxy"],
        "kernel_ops": sorted(set(kernel_ops(program))),
        "torch": torch.__version__,
        **(meta or {}),
    }
    with open(path + ".json", "w") as f:
        json.dump(sidecar, f, indent=2)
        f.write("\n")


def load_artifact(path: str) -> torch.nn.Module:
    """Read an artifact; call the returned module on a batch.  A plain
    artifact needs only ``torch.export.load`` (what this does, after
    registering the port's ops for a kernel-route one)."""
    import viddet_tpu_torch.ops  # noqa: F401  (registers torch.ops.viddet)

    return torch.export.load(path).module()


def export_savedmodel(model, out_dir: str, spec: ExportSpec = ExportSpec()):
    """JAX's TF SavedModel export (``jax2tf``) has no torch counterpart."""
    raise NotImplementedError(SAVEDMODEL_REFUSAL)
