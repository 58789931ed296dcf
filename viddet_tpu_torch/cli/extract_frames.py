"""Pre-extract video frames to numbered images (counterpart of
``viddet_tpu/cli/extract_frames.py``), over ``utils.video.extract_frames``:
Motion-JPEG ``.avi`` or MPEG-4 Part 2 / Motion-JPEG ``.mp4`` / ``.mov``
input (``utils/video.py``), ``{idx:08d}.jpg`` (the bytes ``cv2.imwrite``
writes) or ``.png`` out.

Example:
  python -m viddet_tpu_torch.cli.extract_frames --input clip.avi --output frames/ --every 2
"""

from __future__ import annotations

import argparse
import os
import time

from viddet_tpu_torch.utils.video import check_readable, extract_frames, probe_video


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Extract video frames to images.")
    p.add_argument("--input", required=True,
                   help="video file, or comma-separated list of videos")
    p.add_argument("--output", required=True,
                   help="output directory (one subdir per video when "
                        "multiple inputs are given)")
    p.add_argument("--every", type=int, default=1,
                   help="write every nth frame")
    p.add_argument("--ext", default="jpg", choices=("jpg", "png"))
    p.add_argument("--quality", type=int, default=95,
                   help="JPEG quality (ext=jpg)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    """Run the CLI; returns the number of frames written."""
    args = parse_args(argv)
    videos = [v.strip() for v in args.input.split(",") if v.strip()]
    for video in videos:  # every input readable before anything is written
        check_readable(video)
    multi = len(videos) > 1
    t0 = time.time()
    total = 0
    for video in videos:
        stem = os.path.splitext(os.path.basename(video))[0]
        out_dir = os.path.join(args.output, stem) if multi else args.output
        info = probe_video(video)
        n = extract_frames(video, out_dir, every=args.every, ext=args.ext,
                           quality=args.quality)
        total += n
        print(f"{video}: {n} frames -> {out_dir} "
              f"({info['frame_count']} total @ {info['fps']:.1f} fps)")
    dt = time.time() - t0
    print(f"done: {total} frames in {dt:.1f}s ({total / dt if dt > 0 else 0.0:.1f} frames/s)")
    return total


if __name__ == "__main__":
    main()
