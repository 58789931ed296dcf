"""Shared plumbing of the port's entry points (counterpart of
``viddet_tpu/cli/common.py``): the flag parser with JSON configs, logging,
the dataset and model factories, the predictor and weight loading."""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from viddet_tpu_torch.core.platform import resolve_device
from viddet_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from viddet_tpu_torch.models.faster_rcnn import FasterRCNN, frcnn_forward_and_postprocess
from viddet_tpu_torch.models.ssd import SSD, ssd_forward_and_postprocess
from viddet_tpu_torch.models.yolo3 import NMSConfig, forward_and_postprocess
from viddet_tpu_torch.parallel.mesh import active, initialize_distributed, local_rank
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
    are ``cuda:0``, under a process group ``cuda:{LOCAL_RANK}``, and raise
    when CUDA is not available."""
    if platform not in PLATFORMS:
        raise ValueError(f"platform {platform!r} is not one of {PLATFORMS}")
    if platform == "cpu":
        return resolve_device("cpu")
    return resolve_device(f"cuda:{local_rank()}" if active() else None)


def initialize_for(platform: str) -> None:
    """``parallel.initialize_distributed`` for a CLI's ``--platform``: gloo
    for ``cpu`` (also where CUDA is present), else NCCL where CUDA is
    available.  Without torch's launcher environment it is a no-op."""
    initialize_distributed(backend="gloo" if platform == "cpu" else None)


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
    the leading dimensions; float batches pass through untouched.  An int8
    model must be calibrated first (``quant.check_calibrated`` raises).
    """
    from viddet_tpu_torch import quant

    if quant.quant_cells(model):
        quant.check_calibrated(model)
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


def fit_detector(args, logger, model: torch.nn.Module, class_names, datasets, step,
                 log_names) -> None:
    """The training loop of the SSD and Faster R-CNN CLIs (counterpart of
    ``viddet_tpu/cli/train_ssd.py:70-150``, which ``train_faster_rcnn.py``
    repeats): uint8 batches at ``--data-shape`` through ``TrainTransform``,
    copied pinned to the model's device, ``step(state, images, gt_boxes,
    gt_ids) -> (state, losses)``; the losses summed on the device and read
    at each log line; validation through ``cli.evaluate.evaluate`` with
    BatchNorm on its running statistics; ``{prefix}_ckpt/step_*``,
    ``{prefix}_best.npz`` and ``{prefix}_final.npz`` as JAX writes them.
    ``log_names``: (label, loss key) pairs of the log line.

    Under a process group (``parallel/mesh.py``) each process loads its
    strided shard of the training set (``--batch-size`` per process, as in
    JAX), the replicas start from process 0's state (``replicate``), the
    validation is sharded and its metric states merged (``evaluate``, as
    JAX's loop calls it), and only process 0 writes the checkpoints and the
    ``.npz`` files; the others wait for a blocking save at a barrier."""
    from viddet_tpu_torch.cli.evaluate import evaluate
    from viddet_tpu_torch.data.loader import DetectionLoader
    from viddet_tpu_torch.data.transforms import TrainTransform
    from viddet_tpu_torch.parallel.mesh import barrier, make_mesh, put_batch, replicate
    from viddet_tpu_torch.train.state import (
        TrainState, latest_checkpoint, make_lr_schedule, make_optimizer, restore_checkpoint,
        save_checkpoint, save_weights_npz,
    )

    train_ds, val_ds, metric_factory = datasets
    mesh = make_mesh(next(model.parameters()).device)
    primary = mesh.rank == 0
    shape = args.data_shape
    loader = DetectionLoader(
        train_ds,
        TrainTransform(size=(shape, shape), normalize=False),  # normalized on the device
        batch_size=args.batch_size,
        train=True,
        num_workers=args.num_workers,
        seed=args.seed,
        max_boxes=args.max_gt_boxes,
        shard=(mesh.rank, mesh.size) if mesh.size > 1 else None,
    )
    steps_per_epoch = max(len(loader), 1)
    schedule = make_lr_schedule(
        args.lr, steps_per_epoch,
        warmup_epochs=args.warmup_epochs,
        decay_epochs=[int(e) for e in args.lr_decay_epoch.split(",") if e],
        decay_factor=args.lr_decay,
    )
    state = TrainState(model, make_optimizer(schedule, momentum=args.momentum,
                                             weight_decay=args.wd))
    start_epoch = 0
    if args.resume:
        path = args.resume if os.path.basename(args.resume).startswith("step_") \
            else latest_checkpoint(args.resume)
        if path:
            state = restore_checkpoint(path, state)
            start_epoch = state.step // steps_per_epoch
            logger.info("resumed from %s", path)
    replicate(model, state.momenta)
    logger.info("device: %s, process %d/%d; %d steps/epoch", mesh.device, mesh.rank, mesh.size,
                steps_per_epoch)
    ckpt_dir = f"{args.save_prefix}_ckpt"
    best_map = -1.0
    total_steps = 0
    fmt = "[Epoch %d][Batch %d] speed: %.1f samples/sec, " + ", ".join(
        f"{label}=%.3f" for label, _ in log_names)

    def save_and_wait():
        if primary:
            save_checkpoint(ckpt_dir, state, state.step, block=True)
        barrier()

    for epoch in range(start_epoch, args.epochs):
        btic = time.time()
        running = {}
        for i, (images, boxes, ids, _d, _a, _x) in enumerate(loader):
            state, losses = step(state, *put_batch((images, boxes, ids.astype(np.int32)), mesh))
            total_steps += 1
            for k, v in losses.items():  # summed on the device: no wait per step
                running[k] = running.get(k, 0.0) + v.double()
            if args.log_interval and (i + 1) % args.log_interval == 0:
                means = [float(running.get(key, 0.0)) / (i + 1) for _, key in log_names]
                speed = args.log_interval * args.batch_size / (time.time() - btic)
                btic = time.time()
                logger.info(fmt, epoch, i + 1, speed, *means)
            if args.max_steps and total_steps >= args.max_steps:
                logger.info("reached max-steps=%d, stopping", args.max_steps)
                save_and_wait()
                return
        if loader.dropped_boxes:
            logger.warning("[Epoch %d] %d GT boxes dropped by --max-gt-boxes=%d pad",
                           epoch, loader.dropped_boxes, args.max_gt_boxes)
        if args.val_interval and (epoch + 1) % args.val_interval == 0:
            eval_args = argparse.Namespace(
                data_shape=shape, batch_size=max(args.batch_size, 1),
                num_workers=args.num_workers, letterbox=False, max_images=0,
                save_detections="", device_normalize=False,
            )
            model.eval()  # BatchNorm on its running statistics
            try:
                names, values = evaluate(model, val_ds, metric_factory(class_names), eval_args,
                                         logger)
            finally:
                model.train()
            logger.info("[Epoch %d] validation %s=%.4f", epoch, names[-1], values[-1])
            if values[-1] > best_map:
                best_map = values[-1]
                if primary:
                    save_weights_npz(f"{args.save_prefix}_best.npz", model)
        if args.save_interval and (epoch + 1) % args.save_interval == 0 and primary:
            save_checkpoint(ckpt_dir, state, state.step)
    if primary:
        save_checkpoint(ckpt_dir, state, state.step, block=True)
        save_weights_npz(f"{args.save_prefix}_final.npz", model)
    barrier()


def build_for_training(args, built=None, **model_kw):
    """The datasets, and the model on ``--platform``'s device in train mode:
    ``built`` (a caller's model and class names, weights loaded), else
    ``--network`` / ``--dataset`` with ``weights.seeded_flat(model,
    --seed)`` (the seeded Flax initialisers, not the values of JAX's
    ``module.init(key(seed))``)."""
    device = platform_device(args.platform)
    train_ds, _ = get_dataset(args.dataset, args.data_root, split="train")
    val_ds, metric_factory = get_dataset(args.dataset, args.data_root, split="val")
    if built is not None:
        model, class_names = built
    else:
        model, class_names = build_model(args.network, args.dataset, classes=train_ds.classes,
                                         device=device, **model_kw)
        load_flat(model, seeded_flat(model, seed=args.seed))
    return model.train(), class_names, (train_ds, val_ds, metric_factory)


def add_quant_flags(p) -> None:
    """``--quant int8`` and ``--calib-batches`` (``viddet_tpu/cli/common.py:301``):
    post-training int8 inference (``viddet_tpu_torch/quant.py``), the conv
    cells as BN-folded int8 convs after a short calibration of activation
    ranges.  Not bit for bit with the float path; off by default."""
    p.add_argument("--quant", default="", choices=["", "int8"],
                   help="post-training quantization for inference (int8 convs; "
                        "calibrated over --calib-batches batches)")
    p.add_argument("--calib-batches", type=int, default=4,
                   help="batches used to calibrate activation ranges for --quant")


def quant_policy_kw(args) -> dict:
    """Model-factory kwargs for ``--quant`` ({} when unset)."""
    if not getattr(args, "quant", ""):
        return {}
    from viddet_tpu_torch.core.precision import INT8_POLICY

    return {"policy": INT8_POLICY}


def calibrate_variables(model: torch.nn.Module, batches, logger) -> torch.nn.Module:
    """Calibrate an int8 model's activation ranges over ``batches`` (each a
    normalized NHWC batch, or clips, on the model's device), in place;
    returns the model."""
    from viddet_tpu_torch import quant

    quant.calibrate(model, batches)
    logger.info("int8 calibration: %d batches, %d conv cells ranged", len(batches),
                len(quant.quant_cells(model)))
    return model
