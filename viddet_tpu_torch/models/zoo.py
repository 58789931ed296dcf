"""Model factory (counterpart of ``viddet_tpu/models/zoo.py:32-153``), with the
same 13 registered names.

``get_model(name)`` builds the module on ``cuda:0`` unless ``device`` says
otherwise, in eval mode and channels_last.  Its parameters come from
PyTorch's initialisers; load real or seeded weights through ``weights.py``
(``load_flat``, ``init_flat``) or ``cli.common.load_weights``.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import torch

from viddet_tpu_torch.core.platform import resolve_device
from viddet_tpu_torch.core.precision import DEFAULT_POLICY
from viddet_tpu_torch.data.names import COCO_CLASSES, VID_CLASSES, VOC_CLASSES
from viddet_tpu_torch.models.faster_rcnn import FasterRCNN
from viddet_tpu_torch.models.ssd import SSD
from viddet_tpu_torch.models.temporal import TemporalYOLOv3
from viddet_tpu_torch.models.yolo3 import YOLOv3

_REGISTRY: Dict[str, Callable[..., Tuple[torch.nn.Module, Sequence[str]]]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def list_models() -> Sequence[str]:
    return sorted(_REGISTRY)


def get_model(name: str, device=None, **kwargs):
    """Returns (module on the device, class-name tuple)."""
    if name not in _REGISTRY:
        raise ValueError(f"unknown model {name!r}; available: {list_models()}")
    module, classes = _REGISTRY[name](**kwargs)
    return place(module, device), classes


def place(module: torch.nn.Module, device=None) -> torch.nn.Module:
    """The module on the device (``cuda:0`` unless ``device`` says
    otherwise), in eval mode and channels_last, as ``get_model`` returns
    it; for the unregistered custom builds."""
    return module.to(device=resolve_device(device), memory_format=torch.channels_last).eval()


def _yolo(backbone: str, classes, policy=DEFAULT_POLICY, **kwargs):
    return YOLOv3(num_classes=len(classes), backbone=backbone, policy=policy, **kwargs), tuple(classes)


@register("yolo3_darknet53_voc")
def yolo3_darknet53_voc(**kw):
    return _yolo("darknet53", VOC_CLASSES, **kw)


@register("yolo3_darknet53_coco")
def yolo3_darknet53_coco(**kw):
    return _yolo("darknet53", COCO_CLASSES, **kw)


@register("yolo3_darknet53_vid")
def yolo3_darknet53_vid(**kw):
    return _yolo("darknet53", VID_CLASSES, **kw)


@register("yolo3_tiny_darknet_voc")
def yolo3_tiny_darknet_voc(**kw):
    return _yolo("tiny", VOC_CLASSES, **kw)


@register("yolo3_tiny_darknet_coco")
def yolo3_tiny_darknet_coco(**kw):
    return _yolo("tiny", COCO_CLASSES, **kw)


@register("yolo3_tiny_darknet_vid")
def yolo3_tiny_darknet_vid(**kw):
    return _yolo("tiny", VID_CLASSES, **kw)


def yolo3_custom(classes: Sequence[str], backbone: str = "darknet53", **kw):
    """Arbitrary class list (combined datasets); not registered, as in JAX."""
    return _yolo(backbone, classes, **kw)


def _temporal_yolo(backbone: str, classes, k: int = 3, aggregation: str = "max",
                   policy=DEFAULT_POLICY, **kw):
    module = TemporalYOLOv3(num_classes=len(classes), k=k, backbone=backbone,
                            aggregation=aggregation, policy=policy, **kw)
    return module, tuple(classes)


@register("yolo3_darknet53_k3_vid")
def yolo3_darknet53_k3_vid(**kw):
    return _temporal_yolo("darknet53", VID_CLASSES, **kw)


@register("yolo3_tiny_darknet_k3_vid")
def yolo3_tiny_darknet_k3_vid(**kw):
    return _temporal_yolo("tiny", VID_CLASSES, **kw)


def temporal_yolo3_custom(classes: Sequence[str], k: int, aggregation: str = "max",
                          backbone: str = "darknet53", **kw):
    """Arbitrary class list and clip length; not registered, as in JAX."""
    return _temporal_yolo(backbone, classes, k=k, aggregation=aggregation, **kw)


def _ssd(classes, image_size: int = 512, policy=DEFAULT_POLICY, **kw):
    return SSD(num_classes=len(classes), image_size=image_size, policy=policy, **kw), tuple(classes)


@register("ssd_512_resnet50_voc")
def ssd_512_resnet50_voc(**kw):
    return _ssd(VOC_CLASSES, **kw)


@register("ssd_512_resnet50_coco")
def ssd_512_resnet50_coco(**kw):
    return _ssd(COCO_CLASSES, **kw)


@register("ssd_512_resnet50_vid")
def ssd_512_resnet50_vid(**kw):
    return _ssd(VID_CLASSES, **kw)


def _frcnn(classes, policy=DEFAULT_POLICY, **kw):
    kw.pop("image_size", None)
    return FasterRCNN(num_classes=len(classes), policy=policy, **kw), tuple(classes)


@register("faster_rcnn_resnet50_fpn_voc")
def faster_rcnn_resnet50_fpn_voc(**kw):
    return _frcnn(VOC_CLASSES, **kw)


@register("faster_rcnn_resnet50_fpn_coco")
def faster_rcnn_resnet50_fpn_coco(**kw):
    return _frcnn(COCO_CLASSES, **kw)
