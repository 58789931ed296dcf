"""Evaluation entry point: mAP on VOC / COCO / DET / VID (counterpart of
``viddet_tpu/cli/evaluate.py``).

Builds the val loader and the dataset's metric, runs the predictor
(forward pass and the kernel tail) batch by batch on the card, rescales
the detections to original image coordinates, accumulates the metric and
prints its table.  One process evaluates the whole set (or the shard that
``VIDDET_EVAL_SHARD=i,count`` names).  Under several processes
(``parallel/mesh.py``) each evaluates its strided shard, writes its
detections to ``{path}.p{i}``, and the metric states are gathered and
merged (``eval/distributed.py``) before ``get()``, so every process
returns the whole set's result; process 0 prints it.  ``--quant int8``
builds the model under ``INT8_POLICY`` and calibrates it on the first
``--calib-batches`` loader batches, normalized on the host
(``viddet_tpu/cli/evaluate.py:101-120``); under several processes those
are the whole set's first batches, so every replica is calibrated alike.

Example, on the card:
  python -m viddet_tpu_torch.cli.evaluate --network yolo3_darknet53 \
      --dataset voc --data-root /data/VOCdevkit --weights model.npz

on N cards of one host:
  python -m torch.distributed.run --nproc_per_node=N -m viddet_tpu_torch.cli.evaluate ...

and on the CPU (the kernels' plain versions, gloo ranks): add ``--platform cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from viddet_tpu_torch.cli.common import (
    add_quant_flags,
    build_model,
    calibrate_variables,
    get_dataset,
    initialize_for,
    load_weights,
    make_predictor,
    parse_with_config,
    platform_device,
    quant_policy_kw,
    setup_logging,
)
from viddet_tpu_torch.data.loader import DetectionLoader
from viddet_tpu_torch.data.transforms import ValTransform, invert_affine_to_boxes, normalize
from viddet_tpu_torch.eval.distributed import gather_states, merge_metric_states
from viddet_tpu_torch.infer.service import to_device_batch
from viddet_tpu_torch.parallel.mesh import process_count, process_index
from viddet_tpu_torch.weights import load_flat, seeded_flat


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate a detector.")
    p.add_argument("--network", default="yolo3_darknet53")
    p.add_argument("--dataset", default="voc")
    p.add_argument("--data-root", required=True)
    p.add_argument("--weights", default="",
                   help=".npz weights; if empty, seeded random weights (seed 0)")
    p.add_argument("--data-shape", type=int, default=416)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--num-workers", type=int, default=4)
    p.add_argument("--letterbox", action="store_true", default=False)
    p.add_argument("--max-images", type=int, default=0, help="0 = all")
    p.add_argument("--save-detections", default="",
                   help="write per-image detections (original coords) to "
                        "this jsonl file while evaluating")
    p.add_argument("--from-detections", default="",
                   help="re-score a saved detections jsonl against the "
                        "dataset GT without running the model")
    p.add_argument("--device-normalize", action="store_true",
                   help="ship raw uint8 val batches and normalize on the "
                        "device (a quarter of the host->device bytes)")
    p.add_argument("--temporal-k", type=int, default=1,
                   help="k-frame clip window for VID temporal models")
    p.add_argument("--temporal-stride", type=int, default=1)
    p.add_argument("--temporal-agg", default="max",
                   choices=["stack", "max", "mean", "conv"])
    add_quant_flags(p)
    return parse_with_config(p, argv)


def detection_line(index, ids, scores, boxes) -> str:
    """One ``--save-detections`` line: an image's kept detections (ids >= 0),
    boxes in original image coordinates, floats as JSON numbers."""
    keep = ids >= 0
    return json.dumps({
        "index": int(index),
        "ids": ids[keep].astype(int).tolist(),
        "scores": scores[keep].astype(float).tolist(),
        "boxes": boxes[keep].astype(float).tolist(),
    }) + "\n"


def evaluate(model, dataset, metric, args, logger, stats: dict | None = None):
    """Run ``model`` over ``dataset`` and return ``metric.get()``.

    Every batch, the last one zero-padded to ``args.batch_size``, crosses
    to the model's device as one pinned, non-blocking copy and goes
    through one predictor built here.  ``stats``, when given, receives the
    image count and the wall-time split: waiting on the loader, the device
    step (copy in, forward pass and tail, results back on the host) and the
    metric update with its host rescale (and the detections file).

    Under several processes each evaluates its strided shard (``eval_shard``)
    into ``{save_detections}.p{i}``, then the metric states of all are merged
    into ``metric`` before ``get()``.
    """
    device = next(model.parameters()).device
    infer = make_predictor(model)
    loader = val_loader(dataset, args, eval_shard())

    split = {"loader_s": 0.0, "device_s": 0.0, "metric_s": 0.0}
    t0 = time.perf_counter()
    seen = 0
    det_path = args.save_detections
    if det_path and process_count() > 1:
        det_path = f"{det_path}.p{process_index()}"  # one file a process; join by index
    det_file = open(det_path, "w") if det_path else None
    try:
        # explicit iterator so an early --max-images break closes the
        # generator deterministically (its finally stops prefetch workers)
        batches = iter(loader)
        t_ready = time.perf_counter()
        for images, gt_boxes, gt_ids, difficult, affines, idxs in batches:
            t_batch = time.perf_counter()
            split["loader_s"] += t_batch - t_ready
            out = infer(to_device_batch(images, args.batch_size, device))
            ids, scores, boxes = (r.cpu().numpy() for r in out)
            t_step = time.perf_counter()
            n = images.shape[0]
            ids, scores, boxes = ids[:n], scores[:n], boxes[:n]
            # metric protocol runs in ORIGINAL image coordinates
            boxes_orig = np.stack(
                [invert_affine_to_boxes(boxes[i], affines[i]) for i in range(n)]
            )
            gt_orig = np.stack(
                [invert_affine_to_boxes(gt_boxes[i], affines[i]) for i in range(n)]
            )
            gt_orig[gt_ids < 0] = -1.0
            if hasattr(metric, "update_with_indices"):
                metric.update_with_indices(boxes_orig, ids, scores, idxs[:n])
            else:
                metric.update(boxes_orig, ids, scores, gt_orig, gt_ids[:n],
                              difficult[:n] if difficult is not None else None)
            if det_file is not None:
                for i in range(n):
                    det_file.write(detection_line(idxs[i], ids[i], scores[i], boxes_orig[i]))
            seen += n
            t_ready = time.perf_counter()
            split["device_s"] += t_step - t_batch
            split["metric_s"] += t_ready - t_step
            if args.max_images and seen >= args.max_images:
                batches.close()
                break
    finally:
        if det_file is not None:
            det_file.close()
            logger.info("detections written to %s", det_path)
    dt = time.perf_counter() - t0
    logger.info("evaluated %d images in %.1fs (%.1f img/s): loader %.2fs, device %.2fs, "
                "metric %.2fs", seen, dt, seen / dt, split["loader_s"], split["device_s"],
                split["metric_s"])
    if stats is not None:
        stats.update(images=seen, seconds=dt, **split)
    if process_count() > 1:
        states = gather_states(metric.state_dict())
        merge_metric_states(metric, states)
        logger.info("merged metric state from %d process(es)", len(states))
    return metric.get()


def eval_shard(by_process: bool = True):
    """The strided shard (index, count) to evaluate: ``VIDDET_EVAL_SHARD=
    i,count`` if set, else this process's under several processes
    (``by_process``), else None (the whole set)."""
    shard_env = os.environ.get("VIDDET_EVAL_SHARD", "")
    if shard_env:
        return tuple(int(x) for x in shard_env.split(","))
    if by_process and process_count() > 1:
        return process_index(), process_count()
    return None


def val_loader(dataset, args, shard=None) -> DetectionLoader:
    """The evaluation loader: ``ValTransform`` (``ClipValTransform`` for a
    temporal model) at ``--data-shape``, batches of ``--batch-size``, over
    the strided ``shard`` (index, count) of the set, or the whole set (the
    loader keeps uneven tails: evaluation must not drop images)."""
    from viddet_tpu_torch.data.clip_transforms import ClipValTransform

    size = (args.data_shape, args.data_shape)
    if getattr(args, "temporal_k", 1) > 1:
        transform = ClipValTransform(
            size=size, letterbox_resize=args.letterbox, k=args.temporal_k,
            normalize=not args.device_normalize,
        )
    else:
        transform = ValTransform(size=size, letterbox_resize=args.letterbox,
                                 normalize=not args.device_normalize)
    return DetectionLoader(dataset, transform, batch_size=args.batch_size, train=False,
                           num_workers=args.num_workers, shard=shard)


def calibrate_on_loader(model, dataset, args, logger):
    """Calibrate an int8 model on the first ``--calib-batches`` batches of
    the evaluation loader, uint8 batches normalized on the host first."""
    device = next(model.parameters()).device
    batches, it = [], iter(val_loader(dataset, args, eval_shard(by_process=False)))
    try:
        for _ in range(max(1, args.calib_batches)):
            try:
                images = next(it)[0]
            except StopIteration:
                break
            if images.dtype == np.uint8:
                images = normalize(images)
            batches.append(torch.from_numpy(np.ascontiguousarray(images)).to(device))
    finally:
        it.close()
    return calibrate_variables(model, batches, logger)


def rescore_from_detections(dataset, metric, path, logger):
    """Feed a saved detections jsonl back into the metric, with no model run.

    Detections were saved in original image coordinates, which is the
    metric protocol, and GT comes from ``dataset.label(idx)`` without
    decoding images.
    """
    t0 = time.time()
    seen = 0
    with_idx = hasattr(metric, "update_with_indices")
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            idx = int(rec["index"])
            m = len(rec["ids"])
            ids = np.asarray(rec["ids"], np.float32).reshape(1, m)
            scores = np.asarray(rec["scores"], np.float32).reshape(1, m)
            boxes = np.asarray(rec["boxes"], np.float32).reshape(1, m, 4)
            if with_idx:
                metric.update_with_indices(boxes, ids, scores, [idx])
            else:
                label = dataset.label(idx)
                g = label.shape[0]
                metric.update(
                    boxes, ids, scores,
                    label[None, :, :4].astype(np.float32),
                    label[None, :, 4].astype(np.float32),
                    label[None, :, 5].astype(np.float32) if label.shape[1] > 5 else np.zeros((1, g), np.float32),
                )
            seen += 1
    logger.info(
        "re-scored %d images from %s in %.1fs", seen, path, time.time() - t0
    )
    return metric.get()


def log_table(logger, names, values) -> None:
    width = max(len(str(n)) for n in names)
    for name, value in zip(names, values):
        logger.info("%-*s %s", width, name, f"{value:.4f}" if isinstance(value, float) else value)


def main(argv=None):
    """Run the CLI; returns the metric's (names, values), the whole set's
    on every process."""
    args = parse_args(argv)
    initialize_for(args.platform)
    logger = setup_logging()
    temporal = args.temporal_k > 1
    ds_kw = (
        dict(window=args.temporal_k, stride=args.temporal_stride)
        if temporal and "vid" in args.dataset.split("+") else {}
    )
    dataset, metric_factory = get_dataset(
        args.dataset, args.data_root, split="val", **ds_kw
    )
    if args.from_detections:
        metric = metric_factory(list(dataset.classes))
        result = rescore_from_detections(dataset, metric, args.from_detections, logger)
        if process_index() == 0:
            log_table(logger, *result)
        return result
    device = platform_device(args.platform)
    if temporal:
        from viddet_tpu_torch.models.zoo import place, temporal_yolo3_custom

        backbone = "tiny" if "tiny" in args.network else "darknet53"
        model, class_names = temporal_yolo3_custom(
            dataset.classes, k=args.temporal_k, aggregation=args.temporal_agg,
            backbone=backbone, **quant_policy_kw(args),
        )
        model = place(model, device)
    else:
        model, class_names = build_model(args.network, args.dataset,
                                         classes=dataset.classes, device=device,
                                         **quant_policy_kw(args))
    if args.weights:
        load_weights(model, args.weights)
    else:
        # weights.init_flat's seeded Flax initialisers; not the values of
        # JAX's module.init(key(0)), so the two packages' random-weight
        # runs differ unless both load one .npz
        load_flat(model, seeded_flat(model, seed=0))
    if args.quant:
        calibrate_on_loader(model, dataset, args, logger)
    metric = metric_factory(class_names)
    result = evaluate(model, dataset, metric, args, logger)
    if process_index() == 0:
        log_table(logger, *result)
    return result


if __name__ == "__main__":
    main()
