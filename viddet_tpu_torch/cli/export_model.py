"""Export CLI: a predictor as one deployment artifact (counterpart of
``viddet_tpu/cli/export_model.py``).

Writes a ``torch.export`` program (``.pt2``: weights carried, uint8 frames
normalized in the graph, decode and NMS included) and its ``.json``
sidecar; ``viddet_tpu_torch.infer.export.load_artifact`` (or, for the
plain route, ``torch.export.load(path).module()`` alone) reads it back.
The port's values of JAX's flags: ``--platforms cpu|cuda`` (one device per
artifact), ``--nms-backend plain|cuda`` (``cuda``: the hand-written
kernels as ``torch.ops.viddet`` custom ops; needs ``--platforms cuda``
and, where it loads, the port's ops), ``--batch 0`` for a dynamic batch;
``--savedmodel`` is refused (no torch route to a TF SavedModel).

Examples:
  # portable artifact, any batch size, uint8 frames in, on the card
  python -m viddet_tpu_torch.cli.export_model --network yolo3_darknet53 \\
      --dataset coco --weights weights.npz --out yolo3_coco.pt2

  # the hand-written kernels inside, batch 128
  python -m viddet_tpu_torch.cli.export_model --network yolo3_darknet53 \\
      --dataset coco --weights weights.npz --nms-backend cuda --batch 128 \\
      --out yolo3_coco_cuda.pt2

  # on the CPU
  python -m viddet_tpu_torch.cli.export_model --network yolo3_tiny_darknet \\
      --dataset voc --image-size 64 --platforms cpu --out tiny.pt2
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Export a predictor artifact.")
    p.add_argument("--network", default="yolo3_darknet53")
    p.add_argument("--dataset", default="coco",
                   help="class set / registered-model suffix (voc|coco|vid|...)")
    p.add_argument("--weights", default="",
                   help=".npz weights; empty = seeded random weights (seed 0)")
    p.add_argument("--image-size", type=int, default=416)
    p.add_argument("--batch", type=int, default=0,
                   help="static batch size; 0 = dynamic (the artifact takes any batch)")
    p.add_argument("--platforms", default="cuda",
                   help="the artifact's device: cpu or cuda (one device per artifact)")
    p.add_argument("--input", default="uint8", choices=("uint8", "float32"),
                   help="artifact input dtype; uint8 is normalized in the graph")
    p.add_argument("--nms-backend", default="plain", choices=("plain", "cuda"),
                   help="plain = PyTorch's operations only (loads with torch alone); cuda = "
                        "the hand-written kernels (requires --platforms cuda)")
    p.add_argument("--iou-thresh", type=float, default=None)
    p.add_argument("--valid-thresh", type=float, default=None)
    p.add_argument("--topk", type=int, default=None)
    p.add_argument("--post-nms", type=int, default=None)
    p.add_argument("--out", default="model.pt2")
    p.add_argument("--savedmodel", default="",
                   help="refused: a TF SavedModel has no torch route")
    from viddet_tpu_torch.cli.common import parse_with_config

    return parse_with_config(p, argv)


def main(argv=None):
    args = parse_args(argv)
    from viddet_tpu_torch.cli.common import build_model, load_weights_or_seed, setup_logging
    from viddet_tpu_torch.infer.export import (
        SAVEDMODEL_REFUSAL,
        ExportSpec,
        export_predictor,
        save_artifact,
    )

    if args.savedmodel:
        raise SystemExit(f"--savedmodel: {SAVEDMODEL_REFUSAL}")
    logger = setup_logging()
    spec = ExportSpec(
        image_size=args.image_size,
        batch=args.batch or None,
        input_dtype=args.input,
        platforms=tuple(p.strip() for p in args.platforms.split(",")),
        nms_backend=args.nms_backend,
        iou_thresh=args.iou_thresh,
        valid_thresh=args.valid_thresh,
        topk=args.topk,
        post_nms=args.post_nms,
    )
    spec.validate()
    model, classes = build_model(args.network, args.dataset,
                                 device="cpu" if spec.platforms[0] == "cpu" else None)
    load_weights_or_seed(model, args.weights)
    program = export_predictor(model, spec)
    meta = {
        "model": f"{args.network}_{args.dataset}",
        "classes": list(classes),
        "weights": args.weights or "(seeded random weights, seed 0)",
        "nms_backend": args.nms_backend,
    }
    save_artifact(program, args.out, meta)
    logger.info("wrote %s (+.json sidecar): platforms=%s nms_backend=%s", args.out,
                ",".join(spec.platforms), args.nms_backend)


if __name__ == "__main__":
    main()
