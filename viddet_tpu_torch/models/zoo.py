"""Model factory (counterpart of ``viddet_tpu/models/zoo.py:32-153``).

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
from viddet_tpu_torch.data.names import COCO_CLASSES
from viddet_tpu_torch.models.faster_rcnn import FasterRCNN
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
    dev = resolve_device(device)
    module, classes = _REGISTRY[name](**kwargs)
    module = module.to(device=dev, memory_format=torch.channels_last).eval()
    return module, classes


def _yolo(backbone: str, classes, policy=DEFAULT_POLICY, **kwargs):
    return YOLOv3(num_classes=len(classes), backbone=backbone, policy=policy, **kwargs), tuple(classes)


@register("yolo3_darknet53_coco")
def yolo3_darknet53_coco(**kw):
    return _yolo("darknet53", COCO_CLASSES, **kw)


@register("yolo3_tiny_darknet_coco")
def yolo3_tiny_darknet_coco(**kw):
    return _yolo("tiny", COCO_CLASSES, **kw)


@register("faster_rcnn_resnet50_fpn_coco")
def faster_rcnn_resnet50_fpn_coco(policy=DEFAULT_POLICY, **kw):
    return FasterRCNN(num_classes=len(COCO_CLASSES), policy=policy, **kw), tuple(COCO_CLASSES)
