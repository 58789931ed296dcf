"""Detection CLI over images, image directories and videos (counterpart of
``viddet_tpu/cli/detect.py``).

Images: decode -> letterbox -> forward pass and kernel tail on the card ->
rescale to original coordinates -> ``{stem}.txt`` lines and
``{stem}_det.jpg`` drawings.  Files go one by one through ``imread_rgb``
and ``ValTransform`` (the JAX CLI's per-file route; its batch route
decodes with a DCT-domain prescale that does not equal OpenCV, and has no
counterpart here), and each batch is padded to ``--batch-size`` so every
batch has one shape.

Videos (Motion-JPEG ``.avi``, MPEG-4 Part 2 or Motion-JPEG ``.mp4`` /
``.mov``, see ``utils/video.py``): one video goes through
``infer.stream.stream_detect_video``; several (comma-separated, any mix of
those), ``--temporal-k`` > 1 (a k-frame clip model) or a live source go
through ``infer.multistream.stream_detect_videos``.  They write
``{stem}_det.mp4`` (MPEG-4 Part 2, as JAX's) and ``{stem}_det.txt``.  Another
container or codec, or a webcam index, raises ValueError before the model
is built or anything is written.

``--quant int8`` builds the model under ``INT8_POLICY`` (``quant.py``) and
calibrates its activation ranges on ``--calib-batches`` batches of
``--calib-images`` (a file or a directory; the inputs may be a stream, so
the calibration set is named apart), normalized on the host; a temporal
model calibrates on static clips of those images.

Example, on the card:
  python -m viddet_tpu_torch.cli.detect --network yolo3_darknet53 --dataset voc \
      --weights model.npz --input clip.avi --output out/ --thresh 0.5 --save-detections
  # int8 convs, ranges from 4 batches of calibration images
  python -m viddet_tpu_torch.cli.detect --network yolo3_darknet53 --dataset voc \
      --weights model.npz --input images/ --output out/ --quant int8 --calib-images calib/
"""

from __future__ import annotations

import argparse
import glob
import os
import time

import numpy as np
import torch

from viddet_tpu_torch.cli.common import (
    add_quant_flags,
    build_model,
    calibrate_variables,
    load_weights_or_seed,
    make_predictor,
    parse_with_config,
    platform_device,
    quant_policy_kw,
    setup_logging,
)
from viddet_tpu_torch.data.base import imread_rgb
from viddet_tpu_torch.data.transforms import ValTransform, invert_affine_to_boxes, normalize
from viddet_tpu_torch.infer.service import to_device_batch
from viddet_tpu_torch.utils.image import draw_detections, imwrite
from viddet_tpu_torch.utils.video import check_readable

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp")
VIDEO_EXTS = (".mp4", ".avi", ".mov", ".mkv", ".webm")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Run object detection.")
    p.add_argument("--network", default="yolo3_darknet53")
    p.add_argument("--dataset", default="voc", help="class set: voc|coco|vid")
    p.add_argument("--weights", default="",
                   help=".npz weights; if empty, seeded random weights (seed 0)")
    p.add_argument("--input", required=True,
                   help="image / dir / video file; comma-separate multiple "
                        "videos to stream them through one shared batch")
    p.add_argument("--output", default="results", help="output directory")
    p.add_argument("--data-shape", type=int, default=416)
    p.add_argument("--thresh", type=float, default=0.5)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--every", type=int, default=1, help="process every nth frame")
    p.add_argument("--flush-ms", type=float, default=None,
                   help="max wait from a batch's first frame before a "
                        "partial batch is submitted (default: 50 for live "
                        "webcam sources, 200 for video files)")
    p.add_argument("--save-detections", action="store_true", help="write det .txt")
    p.add_argument("--no-draw", action="store_true")
    p.add_argument("--temporal-k", type=int, default=1,
                   help="k-frame clip window for VID temporal models "
                        "(video input only; per-stream ring buffers "
                        "assemble clips from the live stream)")
    p.add_argument("--temporal-stride", type=int, default=1,
                   help="emit one clip per this many frames")
    p.add_argument("--temporal-agg", default="max",
                   choices=("stack", "max", "mean", "conv"))
    add_quant_flags(p)
    p.add_argument("--calib-images", default="",
                   help="image file or directory to calibrate --quant int8 activation ranges "
                        "on (required with --quant: the inputs may be a live stream)")
    return parse_with_config(p, argv)


def collect_inputs(path: str):
    if path.isdigit():  # webcam index, as the reference's detect.py supports
        return "video", [int(path)]
    if "," in path:  # multiple videos -> one shared continuous batch
        parts = [p.strip() for p in path.split(",") if p.strip()]
        if all(p.lower().endswith(VIDEO_EXTS) for p in parts):
            return "video", parts
        raise ValueError(
            "comma-separated --input requires every entry to be a video file"
        )
    if os.path.isdir(path):
        files = sorted(
            f for f in glob.glob(os.path.join(path, "*"))
            if f.lower().endswith(IMAGE_EXTS)
        )
        return "images", files
    if path.lower().endswith(VIDEO_EXTS):
        return "video", [path]
    return "images", [path]


def detection_lines(ids, scores, boxes, class_names, thresh: float) -> str:
    """``{stem}.txt``: one ``class score x1 y1 x2 y2`` line per detection
    at or above ``thresh``, boxes in original image coordinates."""
    return "".join(
        f"{class_names[int(cid)]} {s:.4f} {bb[0]:.1f} {bb[1]:.1f} {bb[2]:.1f} {bb[3]:.1f}\n"
        for cid, s, bb in zip(ids, scores, boxes) if cid >= 0 and s >= thresh)


def calibrate_for_detect(model, args, transform, logger):
    """Calibrate an int8 model from ``--calib-images`` (``viddet_tpu/cli/detect.py:92``):
    up to ``--calib-batches`` batches of ``--batch-size`` images through
    ``transform`` and normalized on the host; a temporal model takes
    static clips (each image k times)."""
    if not args.calib_images:
        raise SystemExit("--quant int8 needs --calib-images (file or dir)")
    kind, files = collect_inputs(args.calib_images)
    if kind != "images" or not files:
        raise SystemExit(f"--calib-images {args.calib_images!r}: no images")
    device = next(model.parameters()).device
    limit = args.batch_size * max(1, args.calib_batches)
    k = getattr(args, "temporal_k", 1)
    batches = []
    for start in range(0, min(len(files), limit), args.batch_size):
        batch = normalize(np.stack([transform(imread_rgb(f))[0]
                                    for f in files[start:start + args.batch_size]]))
        if k > 1:  # a static clip: the same frame k times
            batch = np.repeat(batch[:, None], k, axis=1)
        batches.append(torch.from_numpy(batch).to(device))
    return calibrate_variables(model, batches, logger)


def main(argv=None, built=None):
    """Run the CLI; ``built``: a caller's (model, class names), weights
    loaded, instead of the model that the flags name.  Returns the number
    of images or video frames done."""
    args = parse_args(argv)
    logger = setup_logging()
    kind, files = collect_inputs(args.input)
    temporal = args.temporal_k > 1
    if temporal and kind != "video":
        raise SystemExit("--temporal-k > 1 needs video input (clips are "
                         "assembled from the frame stream)")
    if kind == "video":
        for source in files:
            check_readable(source)
    os.makedirs(args.output, exist_ok=True)
    device = platform_device(args.platform)
    if built is not None:
        model, class_names = built
    elif temporal:
        # a k-frame clip model over the dataset's class set; per-stream
        # windows assemble the clips from the frame stream
        from viddet_tpu_torch.models.zoo import place, temporal_yolo3_custom

        _, class_names = build_model(args.network, args.dataset, device="cpu")
        backbone = "tiny" if "tiny" in args.network else "darknet53"
        model, class_names = temporal_yolo3_custom(list(class_names), k=args.temporal_k,
                                                   aggregation=args.temporal_agg,
                                                   backbone=backbone, **quant_policy_kw(args))
        model = place(model, device)
        load_weights_or_seed(model, args.weights)
    else:
        model, class_names = build_model(args.network, args.dataset, device=device,
                                         **quant_policy_kw(args))
        load_weights_or_seed(model, args.weights)
    transform = ValTransform(size=(args.data_shape, args.data_shape), letterbox_resize=True,
                             normalize=False)
    if args.quant:
        calibrate_for_detect(model, args, transform, logger)
    # uint8 frames cross to the device and are normalized there (a quarter
    # of the bytes of float frames; see make_predictor)
    infer = make_predictor(model)
    if kind == "video":
        return detect_videos(args, files, infer, transform, class_names, device, logger)

    logger.info("detecting on %d image(s)", len(files))
    t0 = time.time()
    num_done = 0
    for start in range(0, len(files), args.batch_size):
        chunk = files[start : start + args.batch_size]
        origs, frames, affines = [], [], []
        for f in chunk:
            img = imread_rgb(f)
            x, _, affine = transform(img)
            origs.append(img)
            frames.append(x)
            affines.append(affine)
        batch = to_device_batch(np.stack(frames), args.batch_size, device)
        ids, scores, boxes = (t.cpu().numpy() for t in infer(batch))
        for i, f in enumerate(chunk):
            restored = invert_affine_to_boxes(boxes[i], affines[i])
            stem = os.path.splitext(os.path.basename(f))[0]
            if args.save_detections:
                with open(os.path.join(args.output, f"{stem}.txt"), "w") as out:
                    out.write(detection_lines(ids[i], scores[i], restored, class_names,
                                              args.thresh))
            if not args.no_draw:
                vis = draw_detections(origs[i], restored, ids[i], scores[i], class_names,
                                      args.thresh)
                imwrite(os.path.join(args.output, f"{stem}_det.jpg"), vis)
            num_done += 1
    dt = time.time() - t0
    logger.info("done: %d images in %.2fs (%.1f img/s)", num_done, dt,
                num_done / dt if dt > 0 else 0.0)
    return num_done


def detect_videos(args, files, infer, transform, class_names, device, logger) -> int:
    """The video half: one file through ``stream_detect_video``; several, a
    temporal model or a live source through ``stream_detect_videos``, with
    ``--flush-ms`` 50 for a live source and 200 for files unless given.
    Returns the number of frames (or clips) done."""
    live = isinstance(files[0], int)
    flush_ms = args.flush_ms if args.flush_ms is not None else (50.0 if live else 200.0)
    common = dict(output_dir=args.output, thresh=args.thresh, batch_size=args.batch_size,
                  every=args.every, draw=not args.no_draw,
                  save_detections=args.save_detections, logger=logger, device=device)
    if args.temporal_k > 1 or len(files) > 1 or live:
        from viddet_tpu_torch.infer.multistream import stream_detect_videos

        stats = stream_detect_videos(files, infer, transform, class_names, k=args.temporal_k,
                                     stride=args.temporal_stride, flush_ms=flush_ms, **common)
    else:
        from viddet_tpu_torch.infer.stream import stream_detect_video

        stats = stream_detect_video(files[0], infer, transform, class_names, **common)
    return stats["frames"]

if __name__ == "__main__":
    main()
