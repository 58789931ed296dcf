"""Visualisation CLI (counterpart of ``viddet_tpu/cli/visualise.py``): draw
ground-truth boxes and/or the boxes of detection files on the images of a
dataset or a directory, optionally assembling an annotated video or GIF.

Detections are read from the ``.txt`` files ``detect --save-detections``
writes (``<class> <score> <x1> <y1> <x2> <y2>`` per line).  ``--video``
writes MPEG-4 Part 2 (``mp4v``) into the ``.mp4``, ``.mov`` or ``.avi`` it
names, as JAX's does (``utils.video.VideoWriter``, the port's own encoder
and muxers), ``--gif`` an animated GIF from the port's own encoder
(``utils.gif``; JAX saves through PIL), each frame scaled to
``--gif-max-width`` by the port's ``cv2.resize``-exact resize.

Examples:
  python -m viddet_tpu_torch.cli.visualise --dataset voc --data-root /data/VOCdevkit \\
      --split val --output vis/ --max-images 50
  python -m viddet_tpu_torch.cli.visualise --images frames/ --detections dets/ \\
      --output vis/ --video out.mp4 --fps 25
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from viddet_tpu_torch.cli.common import get_dataset, parse_with_config, setup_logging
from viddet_tpu_torch.data.base import imread_rgb
from viddet_tpu_torch.data.transforms import resize_plain
from viddet_tpu_torch.utils.image import draw_detections, imwrite


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Visualise GT and/or detections.")
    p.add_argument("--dataset", default="", help="draw GT from this dataset")
    p.add_argument("--data-root", default="")
    p.add_argument("--split", default="val")
    p.add_argument("--images", default="", help="or: a directory of images")
    p.add_argument("--detections", default="",
                   help="directory of per-image det .txt files (detect.py format)")
    p.add_argument("--output", default="vis")
    p.add_argument("--thresh", type=float, default=0.5)
    p.add_argument("--max-images", type=int, default=0)
    p.add_argument("--video", default="",
                   help="also write a video of the frames (.mp4, .mov or .avi; MPEG-4 Part 2)")
    p.add_argument("--gif", default="", help="also write an animated GIF of the frames")
    p.add_argument("--fps", type=float, default=25.0)
    p.add_argument("--gif-max-width", type=int, default=480,
                   help="downscale GIF frames to this width (0 = original)")
    p.add_argument("--side-by-side", action="store_true",
                   help="comparison layout: GT on the left panel, "
                        "detections on the right (the reference's "
                        "comparison-video mode) instead of one overlay")
    return parse_with_config(p, argv)


def load_det_txt(path, name_to_id):
    boxes, ids, scores = [], [], []
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                parts = line.split()
                if len(parts) < 6:
                    continue
                name, score = parts[0], float(parts[1])
                boxes.append([float(v) for v in parts[2:6]])
                ids.append(name_to_id.get(name, -1))
                scores.append(score)
    return (
        np.asarray(boxes, np.float32).reshape(-1, 4),
        np.asarray(ids, np.float32),
        np.asarray(scores, np.float32),
    )


def main(argv=None):
    """Run the CLI; returns the number of visualisations written."""
    args = parse_args(argv)
    logger = setup_logging()
    if args.video:
        from viddet_tpu_torch.utils.video import VideoWriter, check_output

        check_output(args.video)  # .mp4, .mov or .avi, before anything is written
    os.makedirs(args.output, exist_ok=True)

    frames = []  # (stem, rgb image, gt label or None)
    class_names = []
    if args.dataset:
        ds, _ = get_dataset(args.dataset, args.data_root, split=args.split)
        class_names = list(ds.classes)
        n = len(ds) if not args.max_images else min(len(ds), args.max_images)
        for i in range(n):
            img, label = ds[i]
            frames.append((f"{i:06d}", img, label))
    elif args.images:
        files = sorted(
            f for f in glob.glob(os.path.join(args.images, "*"))
            if f.lower().endswith((".jpg", ".jpeg", ".png"))
        )
        if args.max_images:
            files = files[: args.max_images]
        for f in files:
            frames.append((os.path.splitext(os.path.basename(f))[0], imread_rgb(f), None))
    else:
        raise SystemExit("need --dataset or --images")

    name_to_id = {n: i for i, n in enumerate(class_names)}
    writer = None
    gif_frames = []
    try:
        for stem, img, label in frames:
            gt_vis = img
            if label is not None and len(label):
                gt_vis = draw_detections(img, label[:, :4], label[:, 4], np.ones(len(label)),
                                         class_names or None, thresh=0.0)
            det_vis = img if args.side_by_side else gt_vis
            if args.detections:
                boxes, ids, scores = load_det_txt(
                    os.path.join(args.detections, f"{stem}.txt"), name_to_id)
                if len(boxes):
                    det_vis = draw_detections(det_vis, boxes, ids, scores, class_names or None,
                                              args.thresh)
            vis = np.concatenate([gt_vis, det_vis], axis=1) if args.side_by_side else det_vis
            imwrite(os.path.join(args.output, f"{stem}_vis.jpg"), vis)
            if args.video:
                if writer is None:
                    writer = VideoWriter(os.path.join(args.output, args.video), args.fps,
                                         (vis.shape[1], vis.shape[0]))
                writer.write(vis)
            if args.gif:
                g = vis
                if args.gif_max_width and g.shape[1] > args.gif_max_width:
                    scale = args.gif_max_width / g.shape[1]
                    g = resize_plain(g, (int(g.shape[0] * scale), args.gif_max_width))[0]
                gif_frames.append(g)
    finally:
        if writer is not None:
            writer.close()
    if args.gif and gif_frames:
        from viddet_tpu_torch.utils.gif import write_gif

        write_gif(os.path.join(args.output, args.gif), gif_frames,
                  duration_ms=max(1, int(1000.0 / args.fps)), loop=0)
        logger.info("wrote GIF %s (%d frames)", args.gif, len(gif_frames))
    logger.info("wrote %d visualisations to %s", len(frames), args.output)
    return len(frames)


if __name__ == "__main__":
    main()
