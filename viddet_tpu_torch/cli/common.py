"""Shared plumbing of the port's entry points (counterpart of
``viddet_tpu/cli/common.py``): the flag parser with JSON configs, logging,
the dataset and model factories, the predictor and weight loading."""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
from typing import Optional

import numpy as np
import torch

from viddet_tpu_torch.core.platform import resolve_device
from viddet_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from viddet_tpu_torch.models.faster_rcnn import FasterRCNN, frcnn_forward_and_postprocess
from viddet_tpu_torch.models.ssd import SSD, ssd_forward_and_postprocess
from viddet_tpu_torch.models.yolo3 import NMSConfig, forward_and_postprocess
from viddet_tpu_torch.weights import load_flat, seeded_flat

PLATFORMS = ("auto", "cpu", "gpu")


def parse_with_config(parser: argparse.ArgumentParser, argv=None):
    """argparse plus ``--config FILE`` (JSON flag defaults; flags given on
    the command line still win), ``--dump-config [FILE|-]`` (write the
    resolved flags as JSON and exit) and ``--platform``: ``auto`` and
    ``gpu`` run on ``cuda:0`` and raise without CUDA, ``cpu`` runs the
    plain versions on the CPU (``platform_device``).  JAX's
    ``--jax-cache-dir`` has no counterpart."""
    parser.add_argument("--config", default="", help="JSON file of flag defaults")
    parser.add_argument(
        "--dump-config", nargs="?", const="-", default=None, metavar="FILE",
        help="write resolved config as JSON (default stdout) and exit",
    )
    parser.add_argument(
        "--platform", default="auto", choices=PLATFORMS,
        help="auto and gpu: cuda:0, an error without CUDA; cpu: the CPU",
    )
    args = parser.parse_args(argv)
    if args.config:
        with open(args.config) as f:
            overrides = json.load(f)
        unknown = [k for k in overrides if not hasattr(args, k.replace("-", "_"))]
        if unknown:
            parser.error(f"--config contains unknown keys: {unknown}")
        parser.set_defaults(**{k.replace("-", "_"): v for k, v in overrides.items()})
        args = parser.parse_args(argv)  # CLI flags override config values
    if args.dump_config is not None:
        resolved = {k: v for k, v in vars(args).items()
                    if k not in ("config", "dump_config")}
        text = json.dumps(resolved, indent=2, default=str)
        if args.dump_config == "-":
            print(text)
        else:
            with open(args.dump_config, "w") as f:
                f.write(text + "\n")
        sys.exit(0)
    return args


def platform_device(platform: str) -> torch.device:
    """``--platform`` to a device: ``cpu`` is the CPU; ``auto`` and ``gpu``
    are ``cuda:0`` and raise when CUDA is not available."""
    if platform not in PLATFORMS:
        raise ValueError(f"platform {platform!r} is not one of {PLATFORMS}")
    return resolve_device("cpu" if platform == "cpu" else None)


def setup_logging(save_prefix: Optional[str] = None) -> logging.Logger:
    """Console and ``<save_prefix>_train.log`` logging."""
    logger = logging.getLogger("viddet_tpu_torch")
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if save_prefix:
        os.makedirs(os.path.dirname(os.path.abspath(save_prefix)) or ".", exist_ok=True)
        fh = logging.FileHandler(f"{save_prefix}_train.log")
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


def get_dataset(name: str, root: str, split: str = "train", **dataset_kw):
    """Dataset factory keyed by ``--dataset``: voc, coco, det, vid, packed,
    synthetic (also ``--data-root synthetic``) or '+'-combined (``det+vid``
    with ``--data-root rootA,rootB`` or one root for all).

    Returns (dataset, metric_factory) where metric_factory(class_names)
    builds the dataset's eval metric.
    """
    name = name.lower()
    if "+" in name:
        from viddet_tpu_torch.data.combined import CombinedDetection
        from viddet_tpu_torch.eval.voc_map import VOC07MApMetric

        members = name.split("+")
        roots = root.split(",")
        if len(roots) == 1:
            roots = roots * len(members)
        if len(roots) != len(members):
            raise ValueError(
                f"--data-root must give 1 or {len(members)} comma-separated "
                f"roots for dataset {name!r}, got {len(roots)}"
            )
        children = [
            # temporal kwargs (window/stride) only apply to VID members
            get_dataset(m, r, split=split,
                        **(dataset_kw if m == "vid" else {}))[0]
            for m, r in zip(members, roots)
        ]
        ds = CombinedDetection(children)
        return ds, lambda names: VOC07MApMetric(iou_thresh=0.5, class_names=names)
    if name == "packed":
        # --data-root is the shard prefix, or 'trainprefix,valprefix' so
        # train and val resolve to their own packed sets (open_packed
        # raises on a split mismatch).
        from viddet_tpu_torch.data.packed import open_packed
        from viddet_tpu_torch.eval.voc_map import VOC07MApMetric

        roots = root.split(",")
        if len(roots) == 2:
            root = roots[0] if split == "train" else roots[1]
        elif len(roots) != 1:
            raise ValueError(
                "--data-root for packed takes 1 prefix or "
                f"'trainprefix,valprefix', got {len(roots)}"
            )
        ds = open_packed(root, split=split)
        return ds, lambda names: VOC07MApMetric(iou_thresh=0.5, class_names=names)
    if name == "synthetic" or root == "synthetic":
        from viddet_tpu_torch.data.synthetic import SyntheticDetection
        from viddet_tpu_torch.eval.voc_map import VOCMApMetric

        ds = SyntheticDetection(
            num_images=64 if split == "train" else 16,
            size=256,
            num_classes=4,
            seed=0 if split == "train" else 1,
        )
        return ds, lambda names: VOCMApMetric(iou_thresh=0.5, class_names=names)
    if name == "voc":
        from viddet_tpu_torch.data.voc import VOCDetection
        from viddet_tpu_torch.eval.voc_map import VOC07MApMetric

        if split == "train":
            ds = VOCDetection(root, splits=(("2007", "trainval"), ("2012", "trainval")))
        else:
            ds = VOCDetection(root, splits=(("2007", "test"),))
        return ds, lambda names: VOC07MApMetric(iou_thresh=0.5, class_names=names)
    if name == "coco":
        from viddet_tpu_torch.data.coco import COCODetection
        from viddet_tpu_torch.eval.coco_eval import COCODetectionMetric

        if split == "train":
            ds = COCODetection(root, split="train2017")
        else:
            ds = COCODetection(root, split="val2017")
        return ds, lambda names: COCODetectionMetric(ds)
    if name == "det":
        from viddet_tpu_torch.data.imgnetdet import ImageNetDetection
        from viddet_tpu_torch.eval.voc_map import VOC07MApMetric

        ds = ImageNetDetection(root, split="train" if split == "train" else "val")
        return ds, lambda names: VOC07MApMetric(iou_thresh=0.5, class_names=names)
    if name == "vid":
        from viddet_tpu_torch.data.imgnetvid import ImageNetVidDetection
        from viddet_tpu_torch.eval.vid_motion_iou import VIDDetectionMetric

        ds = ImageNetVidDetection(
            root, split="train" if split == "train" else "val", **dataset_kw
        )
        return ds, lambda names: VIDDetectionMetric(ds, class_names=names)
    raise ValueError(
        f"unknown dataset {name!r} (voc|coco|det|vid|packed, or '+'-combined "
        "e.g. det+vid)"
    )


def build_model(network: str, dataset: str, classes=None, device=None, **kw):
    """Model from (--network, --dataset), composed as ``yolo3_darknet53_voc``;
    an unregistered combination (a custom, combined or synthetic class set)
    builds with ``classes``.  Returns (module on ``device``, class names);
    ``device`` None is ``cuda:0``."""
    from viddet_tpu_torch.models.zoo import _frcnn, _ssd, get_model, list_models, place, yolo3_custom

    name = f"{network}_{dataset.lower()}"
    if name in list_models():
        return get_model(name, device=device, **kw)
    if classes is None:
        raise ValueError(
            f"unknown model {name!r}; pass classes= for a custom build"
        )
    if network.startswith("ssd"):
        module, names = _ssd(classes, **kw)
    elif network.startswith("faster_rcnn"):
        module, names = _frcnn(classes, **kw)
    else:
        kw.pop("image_size", None)
        backbone = "tiny" if "tiny" in network else "darknet53"
        module, names = yolo3_custom(classes, backbone=backbone, **kw)
    return place(module, device), names


def make_predictor(model: torch.nn.Module, nms: NMSConfig | None = None):
    """``infer(images) -> (ids, scores, boxes)`` on the model's device, for
    a YOLOv3, a temporal YOLOv3, an SSD or a Faster R-CNN (dispatched as
    ``viddet_tpu/cli/common.py:271-276`` does).  Images are NHWC frames, or
    (B, k, H, W, 3) clips for a temporal model.

    ``nms`` None keeps each family's defaults (YOLOv3 and SSD:
    ``NMSConfig()``; Faster R-CNN: ``frcnn_postprocess``'s IoU 0.5, valid
    0.05, topk 400, post_nms 100); an SSD and a Faster R-CNN ignore
    ``nms.ranking``.

    uint8 frames are ImageNet-normalized on the device, with the
    expression of ``viddet_tpu/train/loop.py:37`` ``_maybe_normalize``
    (a quarter of the host->device bytes of float frames), broadcast over
    the leading dimensions; float batches pass through untouched.
    """
    device = next(model.parameters()).device
    mean = torch.as_tensor(IMAGENET_MEAN, device=device)
    std = torch.as_tensor(IMAGENET_STD, device=device)
    if isinstance(model, SSD):
        ssd_nms = nms or NMSConfig()

        def step(images):
            return ssd_forward_and_postprocess(model, images, ssd_nms)
    elif isinstance(model, FasterRCNN):
        kw = {} if nms is None else nms.kwargs()

        def step(images):
            return frcnn_forward_and_postprocess(model, images, **kw)
    else:
        def step(images):
            return forward_and_postprocess(model, images, nms or NMSConfig())

    @torch.inference_mode()
    def infer(images: torch.Tensor):
        if images.dtype == torch.uint8:
            images = (images.float() / 255.0 - mean) / std
        return step(images)

    return infer


def load_weights(model: torch.nn.Module, weights_path: str) -> torch.nn.Module:
    """Load a JAX-package ``.npz`` weights file (``train/state.py`` schema)
    into the model, in place; an empty path leaves it as it is."""
    if weights_path:
        with np.load(weights_path) as data:
            load_flat(model, {k: data[k] for k in data.files})
    return model


def load_weights_or_seed(model: torch.nn.Module, weights_path: str) -> torch.nn.Module:
    """``--weights`` into the model, or, when the path is empty,
    ``weights.seeded_flat(model, seed=0)``: the seeded Flax initialisers,
    not the values of JAX's ``module.init(key(0))``, so the two packages'
    random-weight runs differ unless both load one ``.npz``."""
    if weights_path:
        return load_weights(model, weights_path)
    load_flat(model, seeded_flat(model, seed=0))
    return model
