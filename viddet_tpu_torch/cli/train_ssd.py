"""SSD-512 training entry point (counterpart of ``viddet_tpu/cli/train_ssd.py``):
the same flags, defaults, log lines (``CrossEntropy=``, ``SmoothL1=``) and
output files (``{prefix}_train.log``, ``{prefix}_ckpt/step_*``,
``{prefix}_best.npz``, ``{prefix}_final.npz``), on one card.

Fixed 512-px input (the anchors are size-coupled); the multi-scale
augmentation is ``TrainTransform``'s random expand and crop.  Targets and
hard-negative mining run in the step on the device (``train.loop``); the
step launches no kernel.  Validation runs ``cli.evaluate.evaluate`` (on the
card K2 twice, K5 and K6 a batch).  One process.

Example, on the card:
  python -m viddet_tpu_torch.cli.train_ssd --dataset voc \
      --data-root /data/VOCdevkit --batch-size 32

and on the CPU (the kernels' plain versions): add ``--platform cpu``.
"""

from __future__ import annotations

import argparse

from viddet_tpu_torch.cli.common import (
    build_for_training,
    fit_detector,
    parse_with_config,
    setup_logging,
)
from viddet_tpu_torch.train.loop import make_ssd_train_step


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train SSD-512.")
    p.add_argument("--network", default="ssd_512_resnet50")
    p.add_argument("--dataset", default="voc")
    p.add_argument("--data-root", required=True)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--epochs", type=int, default=240)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--lr-decay", type=float, default=0.1)
    p.add_argument("--lr-decay-epoch", default="160,200")
    p.add_argument("--warmup-epochs", type=float, default=1.0)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--wd", type=float, default=5e-4)
    p.add_argument("--data-shape", type=int, default=512)
    p.add_argument("--num-workers", type=int, default=4)
    p.add_argument("--max-gt-boxes", type=int, default=100,
                   help="static GT pad per image; overflow is dropped+logged")
    p.add_argument("--resume", default="")
    p.add_argument("--save-prefix", default="ssd512")
    p.add_argument("--save-interval", type=int, default=10)
    p.add_argument("--val-interval", type=int, default=10)
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
    model, class_names, datasets = build_for_training(args, built, image_size=args.data_shape)
    fit_detector(args, logger, model, class_names, datasets, make_ssd_train_step(model),
                 (("CrossEntropy", "cls"), ("SmoothL1", "box")))


if __name__ == "__main__":
    main()
