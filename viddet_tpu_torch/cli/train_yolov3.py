"""YOLOv3 training entry point (counterpart of
``viddet_tpu/cli/train_yolov3.py``): the same flags, defaults, log lines
and output files (``{prefix}_train.log``, ``{prefix}_ckpt/step_*``,
``{prefix}_best.npz``, ``{prefix}_final.npz``, ``--metrics-jsonl``
records), on one card.

Targets are assigned inside the train step on the device; multi-scale
training draws each batch's size from the buckets 320..608 (step 64);
checkpoints carry the full state (momentum included).  One process: the
loader's ``shard`` stays None and ``--syncbn`` does nothing.

Example, on the card:
  python -m viddet_tpu_torch.cli.train_yolov3 --dataset voc \
      --data-root /data/VOCdevkit --network yolo3_darknet53 --batch-size 64

and on the CPU (the kernels' plain versions): add ``--platform cpu``.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import time

import numpy as np
import torch

from viddet_tpu_torch.cli.common import (
    build_model,
    get_dataset,
    make_predictor,
    parse_with_config,
    platform_device,
    setup_logging,
)
from viddet_tpu_torch.data.loader import DetectionLoader
from viddet_tpu_torch.data.transforms import TrainTransform, ValTransform
from viddet_tpu_torch.infer.service import to_device_batch
from viddet_tpu_torch.train.loop import make_train_step
from viddet_tpu_torch.train.state import (
    TrainState,
    latest_checkpoint,
    make_lr_schedule,
    make_optimizer,
    restore_checkpoint,
    save_checkpoint,
    save_weights_npz,
)
from viddet_tpu_torch.weights import load_flat, seeded_flat


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train YOLOv3.")
    p.add_argument("--network", default="yolo3_darknet53")
    p.add_argument("--dataset", default="voc")
    p.add_argument("--data-root", required=True)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--lr-decay", type=float, default=0.1)
    p.add_argument("--lr-decay-epoch", default="160,180")
    p.add_argument("--warmup-epochs", type=float, default=2.0)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--wd", type=float, default=5e-4)
    p.add_argument("--data-shape", type=int, default=416)
    p.add_argument("--no-random-shape", action="store_true")
    p.add_argument("--mixup", action="store_true")
    p.add_argument("--no-mixup-epochs", type=int, default=20,
                   help="disable mixup for the final N epochs")
    p.add_argument("--label-smooth", action="store_true")
    p.add_argument("--num-workers", type=int, default=4)
    p.add_argument("--max-gt-boxes", type=int, default=100,
                   help="static GT pad per image; overflow boxes are dropped "
                        "and counted in the per-epoch log")
    p.add_argument("--temporal-k", type=int, default=1,
                   help="k-frame clip window (VID temporal models; 1 = single frame)")
    p.add_argument("--temporal-stride", type=int, default=1)
    p.add_argument("--temporal-agg", default="max",
                   choices=["stack", "max", "mean", "conv"])
    p.add_argument("--resume", default="", help="checkpoint dir/path to resume")
    p.add_argument("--start-epoch", type=int, default=0)
    p.add_argument("--save-prefix", default="yolo3")
    p.add_argument("--save-interval", type=int, default=10)
    p.add_argument("--val-interval", type=int, default=10)
    p.add_argument("--log-interval", type=int, default=100)
    p.add_argument("--seed", type=int, default=233)
    p.add_argument("--max-steps", type=int, default=0,
                   help="stop after N steps total (debug/smoke)")
    p.add_argument("--syncbn", action="store_true",
                   help="accepted for reference CLI parity; one process has "
                        "one batch, so BatchNorm statistics are already global")
    p.add_argument("--profile", type=int, default=0,
                   help="trace N steps with torch.profiler into <save-prefix>_trace")
    p.add_argument("--fault-inject", type=int, default=0,
                   help="crash (after checkpointing) at step N (resume-path "
                        "test hook)")
    p.add_argument("--log-dataset-stats", action="store_true",
                   help="print per-class image/box counts before training")
    p.add_argument("--metrics-jsonl", default="",
                   help="append per-log-interval scalars to this jsonl file")
    p.add_argument("--tensorboard", action="store_true",
                   help="write scalars to <save-prefix>_tb (tensorboardX)")
    p.add_argument("--precompile", action="store_true",
                   help="run one step per multi-scale bucket on a copy of "
                        "the state before the first epoch, so each bucket's "
                        "cuDNN plans are chosen up front")
    return parse_with_config(p, argv)


def mixup_batch(images, boxes, ids, rng):
    """Image-level mixup: blend pairs, concatenate labels with weights."""
    b = images.shape[0]
    perm = rng.permutation(b)
    lam = rng.beta(1.5, 1.5, size=(b,)).astype(np.float32)
    lam = np.maximum(lam, 1.0 - lam)  # keep the primary image dominant
    lam_b = lam.reshape((b,) + (1,) * (images.ndim - 1))  # images or clips
    mixed = images.astype(np.float32) * lam_b + images[perm].astype(np.float32) * (1 - lam_b)
    if images.dtype == np.uint8:
        # keep the uint8 transfer path: quantizing the blend adds at most
        # 0.5/255 of noise to an augmentation that is itself random
        mixed = (mixed + 0.5).astype(np.uint8)
    boxes2 = np.concatenate([boxes, boxes[perm]], axis=1)
    ids2 = np.concatenate([ids, ids[perm]], axis=1)
    w = np.concatenate(
        [np.broadcast_to(lam[:, None], ids.shape),
         np.broadcast_to((1 - lam)[:, None], ids.shape)], axis=1,
    ).astype(np.float32)
    w = np.where(ids2 >= 0, w, 0.0)
    return mixed, boxes2, ids2, w


def _device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    return to_device_batch(np.ascontiguousarray(x), x.shape[0], device)


def main(argv=None, built=None):
    """Run the CLI; ``built``: a caller's (model, class names), weights
    loaded, instead of the model and seeded weights that ``--network``,
    ``--dataset`` and ``--seed`` name (a single-frame YOLOv3)."""
    args = parse_args(argv)
    logger = setup_logging(args.save_prefix)
    logger.info("args: %s", vars(args))
    device = platform_device(args.platform)

    temporal = args.temporal_k > 1
    # window kwargs reach VID members only (combined names route them per
    # member, cli/common.get_dataset); still-image datasets are tiled into
    # static k-frame clips by the clip transforms below.
    ds_kw = (
        dict(window=args.temporal_k, stride=args.temporal_stride)
        if temporal and "vid" in args.dataset.split("+") else {}
    )
    train_ds, _ = get_dataset(args.dataset, args.data_root, split="train", **ds_kw)
    val_ds, metric_factory = get_dataset(args.dataset, args.data_root, split="val", **ds_kw)
    if built is not None:
        model, class_names = built
    elif temporal:
        from viddet_tpu_torch.models.zoo import place, temporal_yolo3_custom

        backbone = "tiny" if "tiny" in args.network else "darknet53"
        model, class_names = temporal_yolo3_custom(
            train_ds.classes, k=args.temporal_k, aggregation=args.temporal_agg,
            backbone=backbone,
        )
        model = place(model, device)
    else:
        model, class_names = build_model(args.network, args.dataset,
                                         classes=train_ds.classes, device=device)
    if built is None:
        # the seeded Flax initialisers (weights.seeded_flat), not the values
        # of JAX's module.init(key(seed))
        load_flat(model, seeded_flat(model, seed=args.seed))
    model.train()
    num_classes = len(class_names)
    if args.log_dataset_stats:
        stats = train_ds.statistics()
        logger.info("train dataset: %d images, %d boxes", stats["images"], stats["boxes"])
        for cls, n in stats["boxes_per_class"].items():
            logger.info("  %-20s %6d boxes in %5d images",
                        cls, n, stats["images_per_class"][cls])

    shape = args.data_shape
    sizes = None if args.no_random_shape else [(s, s) for s in range(320, 609, 64)]
    if temporal:
        from viddet_tpu_torch.data.clip_transforms import ClipTrainTransform

        train_transform = ClipTrainTransform(size=(shape, shape), k=args.temporal_k,
                                             normalize=False)
    else:
        # uint8 batches, normalized in the train step on the device
        train_transform = TrainTransform(size=(shape, shape), normalize=False)
    train_loader = DetectionLoader(
        train_ds,
        train_transform,
        batch_size=args.batch_size,
        train=True,
        sizes=sizes,
        num_workers=args.num_workers,
        seed=args.seed,
        max_boxes=args.max_gt_boxes,
    )
    steps_per_epoch = max(len(train_loader), 1)

    # --- state -------------------------------------------------------------
    schedule = make_lr_schedule(
        args.lr,
        steps_per_epoch,
        warmup_epochs=args.warmup_epochs,
        decay_epochs=[int(e) for e in args.lr_decay_epoch.split(",") if e],
        decay_factor=args.lr_decay,
    )
    state = TrainState(model, make_optimizer(schedule, momentum=args.momentum,
                                             weight_decay=args.wd))
    start_epoch = args.start_epoch
    if args.resume:
        path = args.resume if os.path.basename(args.resume).startswith("step_") \
            else latest_checkpoint(args.resume)
        if path:
            state = restore_checkpoint(path, state)
            start_epoch = state.step // steps_per_epoch
            logger.info("resumed from %s (step %d, epoch %d)", path, state.step, start_epoch)
    logger.info("device: %s; %d steps/epoch", device, steps_per_epoch)

    train_step = make_train_step(
        strides=tuple(model.head.strides),
        anchors=tuple(tuple(tuple(a) for a in s) for s in model.head.anchors),
        num_classes=num_classes,
        label_smooth=args.label_smooth,
    )
    eval_step = make_predictor(model)  # runs on running statistics in eval mode

    best_map = -1.0
    total_steps = 0
    mix_rng = np.random.default_rng(args.seed + 1)
    ckpt_dir = f"{args.save_prefix}_ckpt"
    tb_writer = None
    if args.tensorboard:
        from tensorboardX import SummaryWriter

        tb_writer = SummaryWriter(f"{args.save_prefix}_tb")

    if args.precompile and sizes and not temporal:
        # one step per bucket on a copy of the state (its model too), with
        # the hot loop's dtypes and GT pad
        logger.info("precompiling %d bucket sizes...", len(sizes))
        for sh, sw in sizes:
            dummy = copy.deepcopy(state)
            tic = time.time()
            m = train_loader.max_boxes
            train_step(dummy, torch.zeros((args.batch_size, sh, sw, 3), dtype=torch.uint8,
                                          device=device),
                       -torch.ones((args.batch_size, m, 4), device=device),
                       -torch.ones((args.batch_size, m), dtype=torch.int32, device=device))
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            del dummy
            logger.info("  %dx%d compiled in %.1fs", sh, sw, time.time() - tic)

    profiler = None
    for epoch in range(start_epoch, args.epochs):
        tic = time.time()
        btic = time.time()
        running = {}
        use_mixup = args.mixup and epoch < args.epochs - args.no_mixup_epochs
        for i, (images, boxes, ids, _diff, _aff, _idx) in enumerate(train_loader):
            gt_weights = None
            if use_mixup:
                images, boxes, ids, gt_weights = mixup_batch(images, boxes, ids, mix_rng)
            batch = (_device(images, device), _device(boxes, device),
                     _device(ids.astype(np.int32), device))
            gw = None if gt_weights is None else _device(gt_weights, device)
            if args.profile and total_steps == 5:
                activities = [torch.profiler.ProfilerActivity.CPU]
                if device.type == "cuda":
                    activities.append(torch.profiler.ProfilerActivity.CUDA)
                profiler = torch.profiler.profile(activities=activities)
                profiler.start()
            state, losses = train_step(state, *batch, gw)
            if profiler is not None and total_steps == 5 + args.profile:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                profiler.stop()
                os.makedirs(f"{args.save_prefix}_trace", exist_ok=True)
                profiler.export_chrome_trace(f"{args.save_prefix}_trace/trace.json")
                profiler = None
                logger.info("profile trace written to %s_trace", args.save_prefix)
            total_steps += 1
            for k, v in losses.items():  # summed on the device: no wait per step
                running[k] = running.get(k, 0.0) + v.double()
            if args.log_interval and (i + 1) % args.log_interval == 0:
                means = {k: float(v) / (i + 1) for k, v in running.items()}
                speed = args.log_interval * args.batch_size / (time.time() - btic)
                btic = time.time()
                logger.info(
                    "[Epoch %d][Batch %d] speed: %.1f samples/sec, "
                    "ObjLoss=%.3f, BoxCenterLoss=%.3f, BoxScaleLoss=%.3f, ClassLoss=%.3f",
                    epoch, i + 1, speed,
                    means.get("obj", 0), means.get("center", 0),
                    means.get("scale", 0), means.get("cls", 0),
                )
                if args.metrics_jsonl:
                    with open(args.metrics_jsonl, "a") as mf:
                        mf.write(json.dumps({
                            "step": total_steps, "epoch": epoch,
                            "samples_per_sec": round(speed, 2),
                            **{k: round(v, 5) for k, v in means.items()},
                        }) + "\n")
                if tb_writer is not None:
                    tb_writer.add_scalar("speed/samples_per_sec", speed, total_steps)
                    for k, v in means.items():
                        tb_writer.add_scalar(f"loss/{k}", v, total_steps)
            if args.fault_inject and total_steps == args.fault_inject:
                save_checkpoint(ckpt_dir, state, state.step, block=True)
                raise RuntimeError(
                    f"fault injected at step {total_steps} (checkpoint saved; "
                    f"resume with --resume {ckpt_dir})"
                )
            if args.max_steps and total_steps >= args.max_steps:
                logger.info("reached max-steps=%d, stopping", args.max_steps)
                save_checkpoint(ckpt_dir, state, state.step, block=True)
                return
        logger.info("[Epoch %d] done in %.1fs", epoch, time.time() - tic)
        if train_loader.dropped_boxes:
            logger.warning(
                "[Epoch %d] %d GT boxes dropped by --max-gt-boxes=%d pad",
                epoch, train_loader.dropped_boxes, args.max_gt_boxes,
            )

        if args.val_interval and (epoch + 1) % args.val_interval == 0:
            metric = validate(model, val_ds, metric_factory(class_names), args, eval_step)
            names, values = metric.get()
            logger.info("[Epoch %d] validation: %s=%.4f", epoch, names[-1], values[-1])
            if values[-1] > best_map:
                best_map = values[-1]
                save_weights_npz(f"{args.save_prefix}_best.npz", model)
        if args.save_interval and (epoch + 1) % args.save_interval == 0:
            save_checkpoint(ckpt_dir, state, state.step)
    save_checkpoint(ckpt_dir, state, state.step, block=True)
    save_weights_npz(f"{args.save_prefix}_final.npz", model)


def validate(model, val_ds, metric, args, eval_step):
    """The val set through ``eval_step`` with BatchNorm on its running
    statistics (the model in eval mode, back in train mode after); the
    metric updated in original image coordinates."""
    from viddet_tpu_torch.data.transforms import invert_affine_to_boxes

    if getattr(args, "temporal_k", 1) > 1:
        from viddet_tpu_torch.data.clip_transforms import ClipValTransform

        val_transform = ClipValTransform(size=(args.data_shape, args.data_shape),
                                         k=args.temporal_k)
    else:
        val_transform = ValTransform(size=(args.data_shape, args.data_shape))
    loader = DetectionLoader(
        val_ds,
        val_transform,
        batch_size=args.batch_size,
        train=False,
        num_workers=args.num_workers,
    )
    device = next(model.parameters()).device
    model.eval()
    try:
        for images, gt_boxes, gt_ids, difficult, affines, idxs in loader:
            n = images.shape[0]
            out = eval_step(to_device_batch(images, args.batch_size, device))
            ids, scores, boxes = (r[:n].cpu().numpy() for r in out)
            boxes_orig = np.stack(
                [invert_affine_to_boxes(boxes[i], affines[i]) for i in range(n)]
            )
            if hasattr(metric, "update_with_indices"):  # COCO / VID protocols
                metric.update_with_indices(boxes_orig, ids, scores, idxs[:n])
            else:
                gt_orig = np.stack(
                    [invert_affine_to_boxes(gt_boxes[i], affines[i]) for i in range(n)]
                )
                gt_orig[gt_ids < 0] = -1.0
                metric.update(boxes_orig, ids, scores, gt_orig, gt_ids,
                              difficult if difficult is not None else None)
    finally:
        model.train()
    return metric


if __name__ == "__main__":
    main()
