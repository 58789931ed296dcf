"""Faster R-CNN ResNet-50 FPN training entry point (counterpart of
``viddet_tpu/cli/train_faster_rcnn.py``): the same flags, defaults, log
lines (``RPNAcc-loss=``, ``RPNL1=``, ``RCNNCE=``, ``RCNNL1=``) and output
files, on one card.

Fixed input size; the RPN and roi minibatches are sampled in the step on
the device from one ``torch.Generator`` seeded with ``--seed + 7`` (JAX
seeds its sampling key from the same value; the streams differ).  On the
card each step launches K5 once (proposal NMS at K = 1000); validation
runs ``cli.evaluate.evaluate`` (K7, K5 twice, K2 and K6 a batch).  One
process.

Example, on the card:
  python -m viddet_tpu_torch.cli.train_faster_rcnn --dataset coco \
      --data-root /data/coco --batch-size 8

and on the CPU (the kernels' plain versions): add ``--platform cpu``.
"""

from __future__ import annotations

import argparse

import torch

from viddet_tpu_torch.cli.common import (
    build_for_training,
    fit_detector,
    parse_with_config,
    setup_logging,
)
from viddet_tpu_torch.train.loop import make_frcnn_train_step


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train Faster R-CNN.")
    p.add_argument("--network", default="faster_rcnn_resnet50_fpn")
    p.add_argument("--dataset", default="coco")
    p.add_argument("--data-root", required=True)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--epochs", type=int, default=26)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--lr-decay", type=float, default=0.1)
    p.add_argument("--lr-decay-epoch", default="17,23")
    p.add_argument("--warmup-epochs", type=float, default=0.3)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--wd", type=float, default=1e-4)
    p.add_argument("--data-shape", type=int, default=800)
    p.add_argument("--num-workers", type=int, default=4)
    p.add_argument("--max-gt-boxes", type=int, default=100,
                   help="static GT pad per image; overflow is dropped+logged")
    p.add_argument("--resume", default="")
    p.add_argument("--save-prefix", default="frcnn")
    p.add_argument("--save-interval", type=int, default=1)
    p.add_argument("--val-interval", type=int, default=1)
    p.add_argument("--log-interval", type=int, default=100)
    p.add_argument("--seed", type=int, default=233)
    p.add_argument("--max-steps", type=int, default=0)
    return parse_with_config(p, argv)


def main(argv=None, built=None):
    """Run the CLI; ``built``: a caller's (model, class names), weights
    loaded, instead of the seeded model that ``--network``, ``--dataset``
    and ``--seed`` name."""
    args = parse_args(argv)
    logger = setup_logging(args.save_prefix)
    logger.info("args: %s", vars(args))
    model, class_names, datasets = build_for_training(args, built)
    generator = torch.Generator(device=next(model.parameters()).device).manual_seed(args.seed + 7)
    step = make_frcnn_train_step(model)
    fit_detector(args, logger, model, class_names, datasets,
                 lambda state, *batch: step(state, generator, *batch),
                 (("RPNAcc-loss", "rpn_cls"), ("RPNL1", "rpn_box"), ("RCNNCE", "cls"),
                  ("RCNNL1", "box")))


if __name__ == "__main__":
    main()
