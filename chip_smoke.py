#!/usr/bin/env python3
"""Drive the PyTorch port (``viddet_tpu_torch``) on one CUDA card and check it.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, each printed as one JSON line:

1. device:  the card's name and power limit (``nvidia-smi``);
2. build:   compile the hand-written kernels from ``viddet_tpu_torch/csrc``,
            and beside them the image codec (``native/codec.cpp``);
3. kernels: each kernel against its plain PyTorch version on the card, at
            the main paths' shapes plus edge cases (K1, K3 in both forms and
            K4 also at batch 128, K3 and K4 on bf16 heads and their float32
            copy; K7 with the cells and L2 bytes its rois read, K5 at
            K = 1000 and at K = 400 at batch 8, and K2 at N = 24,000 at the
            Faster R-CNN path's), with its time (a wrapper's kernels apart
            where it launches several: K5's mask and scan), the plain
            version's time, a PyTorch library call's time where one
            computes the same function, and its bound (K5 also beside its
            scan's chain of tile rounds); each time from torch.profiler
            windows checked to hold every launch, the kernel's and the
            library call's also from CUDA events around calls queued back
            to back; K8 also per layer, with the route its shape took, its
            bound, TB/s and TFLOP/s, the bytes its tiles read from L2 and
            cuDNN's convolution alone; and the launch floor: an empty
            kernel of one block and, at the grids of K3-m0, K4 and K6 (as
            launched now and in their earlier designs) at batch 32 and
            128, an empty kernel and one of a load and a store a thread;
4. main path: YOLOv3-416 / Darknet-53 / COCO at full width in bf16 with
            seeded weights, batch 32, through ``make_predictor`` under the
            default (hierarchical) ranking; the kernel launch counts of that
            one call; the kernel tail equal to the plain tail on the same
            head outputs; then the deterministic tail
            (``VIDDET_PAIR_TOPK=det``) on those head outputs, its launch
            counts and its equality to its plain tail; at batch 128, K2's
            two calls, both kernel tails and the predictor against their
            plain versions; both tails' device time at batch 32 and 128;
            time per batch and frames/s at batch 32 and 128;
5. conv:    the same model under ``VIDDET_CONV_BACKEND=pallas`` (K8 on the
            three shallow downsamples), its launch counts, well-formed
            detections, head outputs close to the default path's, frames/s
            at batch 32;
6. serving: ``DetectionService`` answers 16 requests from 4 threads, each
            equal to the direct batched call;
7. evaluate: ``cli.evaluate.evaluate`` with the main path's model (416 px,
            bf16, seeded weights, NMSConfig()) over 256 synthetic images of
            640 px in batches of 32 from 4 loader threads, VOC07 mAP over
            the 80 COCO names, detections saved: K1, K3, K4, K5 and K6
            launched once a batch and K2 twice, every saved line equal to
            the direct ``make_predictor`` call on the same loader batch,
            ``rescore_from_detections`` on the file equal to the metric;
            images/s, the split of wall time (loader, device step, metric),
            peak memory, under device (uint8 frames) and host
            normalization, and the predictor's own frames/s on the batches;
8. codec:   64 seeded 640x480 images through the port's own JPEG (q 95)
            and PNG encoders to files and back through its decoder: PNGs
            exact, each JPEG equal to its decode in a second thread; encode
            and decode rates on one thread and on the loader's 4 (host CPU);
            then the still fixtures (``tests/fixtures/stills/``: WebP, GIF,
            BMP, PNG with eXIf, 16-bit PPM, TIFF with CCITT and CIELab, Sun
            raster, PFM, HDR, JPEG 2000) each to its OpenCV digest, and the
            decode rates of STILL_RATES (CCITT Group 4 and both JP2s among
            them);
9. evaluate_files: ``cli.evaluate.evaluate`` over 256 of them as JPEG files
            in the VOC layout (XML from seeded boxes), YOLOv3-416
            Darknet-53 over VOC's 20 classes (bf16, seeded weights), batch
            32, 4 loader threads: launches, images/s and the wall-time
            split, every image's saved detections equal to the direct
            predictor on the file decoded apart from the loader;
10. http:   ``cli.serve.serve_forever`` on 127.0.0.1 with the main path's
            model (batch 8, flush 5 ms): ``/healthz``, then 8 client threads
            posting JPEG and PNG uploads and the still fixtures of
            STILL_UPLOADS (WebP, GIF, PPM, BMP, PNG with eXIf, TIFF, Sun
            raster, PFM, HDR, CCITT Group 4, 9/7 JP2) for 5 s, every
            reply equal to
            ``detections_to_json`` of the direct predictor on the decoded
            upload; requests/s, latency p50 / p95, batch fill, launches;
11. stream: ``stream_detect`` over 128 frames at batch 8 with the main
            path's predictor, and ``stream_detect_multi`` over 2 streams of
            48 frames with yolo3_darknet53_k3_vid (k = 3): launches, every
            result equal to the direct predictor on the batch that held it;
            frames/s and clips/s beside the direct step, and the card's idle
            share over one window of each;
12. video:  two seeded 640x480 Motion-JPEG AVIs of 128 frames at 25 fps
            written by ``native.avi.AviWriter``; with the main path's
            model at batch 8, ``stream_detect_video`` drawing and saving
            detections (``FrameSource``), again without drawing
            (``NativeFrameSource``), ``stream_detect_videos`` over both
            AVIs with yolo3_darknet53_k3_vid (k = 3), ``cli.detect.main``
            over one AVI and ``cli.extract_frames.main`` with ``--every
            4``: each run's launches (K1, K3, K4, K5, K6 once a batch, K2
            twice), each batch's frames equal to the decoded and
            transformed frames and its kernel tail equal to its plain tail
            on the same head outputs, every saved line equal to the direct
            predictor's, the drawn ``_det.mp4`` (MPEG-4 Part 2, as the JAX
            package writes it) read back by the port's reader, equal byte
            for byte to a fresh ``VideoWriter``'s file of the drawn frames,
            each frame decoded equal to the encoder's reconstruction and
            within DRAWN_PSNR_DB of its drawn frame (so too the ``mp4``,
            ``mpeg4_bvop`` and ``webm`` phases' drawn outputs and
            ``visualise --video``'s), both sources' batches equal, the
            extracted JPEGs equal to the encoder's bytes; frames/s of each
            run beside the direct step, the Motion-JPEG writer's, the MPEG-4
            encoder's alone, the reader's and each source's frames/s, and
            the card's idle share over one window (``--phases video`` runs
            this phase and ``mp4`` alone);
13. detect: ``cli.detect.main`` over 8 JPEG and 8 PNG files and an 8-bit
            BMP with the main path's model, then a WebP, a TIFF and a 9/7
            JP2 each given alone: every
            ``.txt`` equal to the direct predictor, every ``_det.jpg``
            decoding; images/s;
14. temporal: yolo3_darknet53_k3_vid (VID) at full width, 416 px, bf16,
            seeded weights, batches of 8 clips of k = 3 frames (24 frames
            through Darknet-53), under each aggregation (max, stack, mean,
            conv): the launch counts of one ``make_predictor`` call on uint8
            clips (the hierarchical tail: K1, K2 twice, K3, K4, K5, K6), the
            kernel tail equal to the plain tail on the same head outputs,
            each of those kernels equal to its plain version on the path's
            own intermediates (C = 30), well-formed detections; under max,
            the default, also each kernel's time, plain and library time and
            bound at the path's shapes, time per batch and clips/s;
15. ssd:    SSD-512 ResNet-50 / COCO at full width (512 px, batch 32, bf16,
            seeded weights) through ``make_predictor``: its launch counts
            (K2 twice, K5 and K6 once), the kernel tail equal to the plain
            tail on the same head outputs, K2 at the path's two shapes
            ((32, 24,564) anchors, (32, 32,000) pairs), K5 on the path's
            candidates and K6 on its keep mask against their plain versions,
            with their times, torch.topk's time and their bounds, the steps'
            result equal to the predictor's; time per batch, frames/s, peak
            memory and a device breakdown;
16. frcnn:  Faster R-CNN ResNet-50 FPN / COCO at full width (512 px, batch
            8, bf16, seeded weights) through ``make_predictor``: its kernel
            launch counts (K7 once, K5 twice, K2 and K6 once), the kernel
            tail equal to the plain tail on the same head outputs and
            proposals, the head outputs under the plain ROIAlign close to
            the kernel's, K7 on the path's own pyramid and proposals, time
            per batch, frames/s, peak memory and a device breakdown; then
            ``DetectionService`` answers 8 requests, each equal to the direct
            call;
17. train (in a process of its own, ``child_phases``): the float32 step
            against the JAX fixture
            (``tests/fixtures/jax_train_steps.npz``: tiny YOLOv3, 64 px,
            three steps, TF32 off for the check): the batch's targets equal
            bit for bit, losses and a sample of every leaf close; then the
            main path's model trained by ``cli.train_yolov3.main`` (bf16,
            batch 64, ``--dataset synthetic`` of 64 images, multi-scale and
            mixup on, 4 loader workers, 20 epochs of one step, validated
            once): finite losses and samples/s from its JSONL, the card's
            idle share over its ``--profile`` window, the validation batch's
            launches (K1, K3, K4, K5, K6 once, K2 twice) and its kernel tail
            equal to the plain tail, the checkpoint and ``_final.npz``
            (loaded back through ``weights.load_flat``); one step alone at
            320 and 608 px with peak memory, and one at 416 px by part
            (forward, loss and targets, backward, optimizer) and kernel
            group; 40 steps on one batch with ``VIDDET_CONV_BACKEND=pallas``
            (no kernel launched: K8 stays off in training), the total loss
            below half its first value;
18. detector_train (in a process of its own, ``child_phases``): SSD and
            Faster R-CNN training.  The float32 steps
            (TF32 off) against the JAX fixtures
            (``tests/fixtures/jax_{ssd,frcnn}_train_steps.npz``: the shallow
            models, SSD at 64 px and Faster R-CNN at 128 px, three steps,
            the Faster R-CNN steps on JAX's recorded draws): the targets
            bit for bit (Faster R-CNN: the roi sampling of JAX's proposals,
            the RPN labels), the float32 losses, and in float64 compute the
            losses and a sample of every leaf.  Then for each family at full
            width in bf16 (``SSD_MODEL`` at 512 px, batch 32;
            ``FRCNN_MODEL`` at 800 px, batch 8): ``cli.train_ssd.main`` /
            ``cli.train_faster_rcnn.main`` on ``--dataset synthetic``
            (2 epochs of 2 steps / 1 epoch of 8 steps, validated once):
            finite losses and samples/s from its log, peak memory, the
            launches (validation: ``SSD_LAUNCHES`` / ``FRCNN_LAUNCHES`` a
            batch; Faster R-CNN also K5 once a step), the validation
            batch's kernel tail equal to the plain tail, the checkpoint and
            ``_final.npz`` loaded back; one step alone (ms, samples/s, peak
            memory, device time by part and kernel group, no wait for the
            card); for Faster R-CNN, K5 in one step: one launch at (8,
            1000), equal to its plain version on that step's proposals, its
            time beside its bound; the overfit of one batch by the JAX unit
            tests' recipes (SSD: 25 steps, the least of the last three
            losses below 0.7 x the greatest of the first three; Faster
            R-CNN: 12 steps, below the greatest);
19. int8:   in a process of its own with the export phase
            (``child_phases``), the main path's model under INT8_POLICY
            (bf16 compute, every conv+BN cell a BN-folded int8 conv,
            ``quant.py``), seeded
            weights, calibrated on one batch of 32 seeded frames (as
            ``bench.py``'s int8 variant): through ``make_predictor`` at batch
            32 and 128, each batch launching K1, K3, K4, K5, K6 once and K2
            twice, and K8 never, also under ``VIDDET_CONV_BACKEND=pallas``;
            each int8 cell's int32 accumulator on its own input (batch 8) by
            the card route (im2col, ``torch._int_mm``) equal to the plain
            float64 route bit for bit; the kernel tail on the int8 heads
            equal to the plain tail; an int8 GEMM and no float64 convolution
            on the device profile; frames/s beside the bf16 model's at both
            batches, ``head_ms``, ms by stage on CUDA events (quantize,
            im2col, int8 GEMM, epilogue), device ms by kernel group, peak
            memory, calibration
            seconds, the heads' correlation with the bf16 twin and the share
            of the twin's detections the int8 run matches (reported, not
            held); then SSD-512 under INT8_POLICY at batch 32 (its ResNet
            cells: a 7x7 stride-2 stem, relu and none, 1x1 stride-2
            projections), with the same accumulator, launch and tail checks;
20. export: the main path's model exported from the card
            (``infer/export.py``, ``torch.export``) with a dynamic batch by
            the plain route and the cuda route (the kernels as
            ``torch.ops.viddet`` custom ops), saved and loaded: at batch 32
            and 8 the artifact's detections equal the direct predictor's on
            its route bit for bit, the cuda artifact launching K1, K3, K4,
            K5, K6 once and K2 twice a batch and the plain one nothing;
            under ``VIDDET_CONV_BACKEND=pallas`` a cuda artifact carrying
            K8 too (three launches a batch, at batch 32); the
            plain artifact also run in a process that imports no
            ``viddet_tpu_torch``, equal; SSD-512 (batch 32) and Faster R-CNN
            (512 px, batch 8; K7 inside) by the cuda route, likewise; trace
            and load seconds, artifact bytes, the artifact's frames/s beside
            the direct predictor's;
21. data_parallel (in a process of its own, ``child_phases``): the
            data-parallel slice (``parallel/mesh.py``) on the one card.
            (a) NCCL at world size 1: the main path's model trained by
            ``cli.train_yolov3.main`` (bf16, batch 64, 416 px, mixup off,
            ``DP_CLI_STEPS`` one-step epochs, validated once) under an
            NCCL group of one, its losses and ``_final.npz`` equal to the
            same run without a group bit for bit (cuDNN deterministic in
            both), its validation batch launching K1, K3, K4, K5, K6 once
            and K2 twice; the Faster R-CNN step (800 px, batch 8) under
            the group launching K5 once a step; each step's ms (YOLOv3 at
            batch 64, Faster R-CNN) with and without the group, and the
            NCCL gradient all-reduce alone.  (b) ``DP_WORLD`` gloo
            processes on cuda:0 (NCCL refuses two ranks on one card): the
            three float32 fixtures (TF32 off) one image a process, the
            Faster R-CNN draws split by the draw rule, each within the
            train phases' limits and the processes' leaves bit-identical
            after every step; the main path's model in float32 at
            ``DP_F32_B`` images a process against one process of twice
            that, the losses within ``DP_LOSS_RTOL``, with each step's ms,
            peak memory, the gloo gradient all-reduce alone and a global
            BatchNorm's forward and backward in float32 and bf16 against
            ``native_batch_norm``'s.  (c) The same processes run
            ``cli.evaluate.evaluate`` over the evaluate phase's 256 images,
            each its strided shard (K1, K3, K4, K5, K6 once a batch and K2
            twice): the merged VOC07 mAP equal to one process's over the
            whole set and, with every record of the merged metric state,
            to the two shards evaluated in turn in one process and merged;
            each ``.p{i}`` detection file equal to its
            shard's file from one process, line for line (against the whole
            set in one process, where an image sits elsewhere in its batch
            of 32, the lines that differ are reported: cuDNN's bf16
            convolutions round by an image's place in the batch);
22. profiler: the profiler windows that missed a launch and were taken
            again; then ``script``, the seconds since ``main`` began;
23. kernels: one line listing every ported kernel;
then the card's ``nvidia-smi`` line and, last, ``{"ok": true, "device": ...}``.

Any failed check raises, and the script exits non-zero without that last
line.  It needs no network and imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time
import warnings

import numpy as np

# H100 SXM peaks (NVIDIA data sheet), for the bound of each kernel.  Each
# row names the operation peak it uses.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12  # outside the tensor cores; also used for int32 compares
BF16_TC_OPS_PER_S = 989e12  # dense bf16 on the tensor cores
INT8_TC_OPS_PER_S = 1979e12  # dense int8 on the tensor cores
PEAKS = {"f32": F32_OPS_PER_S, "bf16_tensor": BF16_TC_OPS_PER_S,
         "int8_tensor": INT8_TC_OPS_PER_S}
B, N, K, PAIRS, TOPK, POST = 32, 10647, 400, 32000, 400, 100
CELLS = (169, 676, 2704)  # 13x13, 26x26, 52x52 at 416 px
NA, NUM_PRED = 3, 85
C = NUM_PRED - 5
TOP_M, HOT_J = 9, 45  # the hierarchical ranking's m and J at topk 400
K1_MAX_ULP = 0  # every chip run measured 0
# K8 on Darknet-53 at 416 px: (Cin, Cout, input H = W) of the three
# stride-2 layers it takes, and one narrow edge shape (batch, Cin, Cout, H).
K8_LAYERS = ((32, 64, 416), (64, 128, 208), (128, 256, 104))
K8_EDGE = (2, 8, 16, 18)
K8_F32_RTOL = 1e-5
# Head outputs of the K8 configuration against the default conv path:
# relative L2 distance per scale.  bf16 keeps 8 bits (a relative 2**-9 per
# rounding) and the two paths round the three layers' outputs differently;
# the difference then passes through the ~70 layers above them.
CONV_HEAD_REL_L2 = 5e-2
MODEL, IMAGE_SIZE, E2E_BATCHES = "yolo3_darknet53_coco", 416, (32, 128)

# The Faster R-CNN path: tools/frcnn_bench.py's configuration (512 px, batch
# 8, bf16), FRCNNConfig() and frcnn_postprocess defaults.
FRCNN_MODEL, FRCNN_SIZE, FRCNN_B = "faster_rcnn_resnet50_fpn_coco", 512, 8
FRCNN_R, FRCNN_NMS_K, FRCNN_TOPK, FPN_C = 300, 1000, 400, 256
FRCNN_LEVELS = tuple(FRCNN_SIZE // s for s in (4, 8, 16, 32))  # P2..P5 sides
FRCNN_PAIRS = FRCNN_R * C  # the detection ranking's width, 24,000
# Head outputs under the kernel ROIAlign against the plain one: relative L2
# per output.  Equal ROIAlign outputs give 0; the limit admits the bf16
# rounding of the box head (a relative 2**-9 per rounding) over a few
# differently rounded inputs.
FRCNN_HEAD_REL_L2 = 1e-3

# The temporal path: yolo3_darknet53_k3_vid (VID, 30 classes) at full width,
# 416 px, bf16, batches of 8 clips of k = 3 frames, under each aggregation
# (the zoo's default, max, first).
TEMPORAL_MODEL, TEMPORAL_B, TEMPORAL_K = "yolo3_darknet53_k3_vid", 8, 3
TEMPORAL_AGGREGATIONS = ("max", "stack", "mean", "conv")
# The SSD path: SSD-512 ResNet-50 / COCO at full width, 512 px, bf16, batch
# 32, SSDNMSConfig() defaults; N anchors = 64^2*4 + 32^2*6 + 16^2*6 + 8^2*6 +
# 4^2*6 + 2^2*4 + 1*4.
SSD_MODEL, SSD_SIZE, SSD_B, SSD_N = "ssd_512_resnet50_coco", 512, 32, 24564
# The detector training phase: SSD_MODEL and FRCNN_MODEL trained in bf16 at
# their JAX CLIs' defaults (SSD 512 px, batch 32; Faster R-CNN
# --data-shape 800, batch 8) by cli.train_ssd / cli.train_faster_rcnn on
# --dataset synthetic (64 images: 2 and 8 steps an epoch), validated once
# (16 images: 1 and 2 batches).  Random weights diverge at the CLIs' full
# rates within a few steps (JAX's CLIs too), so SSD warms up over both its
# epochs and Faster R-CNN runs at lr 1e-3.  Then one step alone, and the
# overfit of one batch by the JAX unit tests' recipes and criteria.
SSD_TRAIN_SIZE, SSD_TRAIN_B, SSD_TRAIN_EPOCHS = 512, 32, 2
FRCNN_TRAIN_SIZE, FRCNN_TRAIN_B, FRCNN_TRAIN_EPOCHS = 800, 8, 1
TRAIN_VAL_IMAGES = 16  # --dataset synthetic's val split
SSD_OVERFIT_STEPS, SSD_OVERFIT_LR = 25, 5e-3  # tests/unit/test_ssd.py:91
FRCNN_OVERFIT_STEPS, FRCNN_OVERFIT_LR = 12, 2e-3  # tests/unit/test_faster_rcnn.py:147

# The evaluate phase: cli.evaluate.evaluate on the main path's model (416
# px, bf16, NMSConfig()) over a synthetic set of 640-px images, batches of
# 32 from 4 loader threads, scored by VOC07 mAP over the 80 COCO names.
EVAL_IMAGES, EVAL_IMAGE_SIZE, EVAL_CLASSES, EVAL_SEED = 256, 640, 8, 1
EVAL_B, EVAL_WORKERS = 32, 4

# The image codec and the image surfaces (phases 11-15): seeded 640x480
# images; evaluate over 256 of them on disk as VOC with the VOC model; HTTP
# at the serve CLI's defaults (batch 8, flush 5 ms) from 8 client threads
# for about 5 s; stream_detect over 128 frames at batch 8 and
# stream_detect_multi over 2 streams of 48 frames with the temporal model;
# detect over 8 JPEG and 8 PNG files.
CODEC_IMAGES, CODEC_W, CODEC_H, CODEC_SEED = 64, 640, 480, 5
ENCODE_WORKERS = 8  # threads that write the phases' image files (the machine's cores)
VOC_MODEL = "yolo3_darknet53_voc"
HTTP_THREADS, HTTP_SECONDS, HTTP_UPLOADS, HTTP_SEED = 8, 5.0, 16, 6
STREAM_FRAMES, STREAM_B, STREAM_SEED = 128, 8, 7
MULTI_STREAMS, MULTI_FRAMES = 2, 48
DETECT_FILES, DETECT_SEED = 16, 8
# The still images cv2 reads beside JPEG and PNG (tests/fixtures/make_image_fixtures.py):
# WebP, GIF, BMP, PNG with eXIf, 16-bit PPM, TIFF (LZW tiles, JPEG strips, 16-bit
# alpha, palette turned by orientation 6, CCITT Group 4 and Group 3 2-D, CIELab),
# Sun raster, PFM, Radiance HDR and JPEG 2000 (5/3 tiles, 9/7, a 16-bit raw
# codestream) files with their OpenCV digests.  The codec phase decodes each to its digest and
# times STILL_RATES over STILL_COPIES copies; the HTTP phase uploads
# STILL_UPLOADS beside its JPEGs and PNGs; the detect phase reads DETECT_STILL
# in its directory and each of DETECT_SINGLES given alone as --input.
STILLS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures",
                          "stills")
STILLS_DIGESTS = STILLS_DIR + ".json"
STILL_COPIES = 32
STILL_RATES = {"webp_lossy": "webp_lossy_640x480.webp",
               "webp_lossless": "webp_lossless_320x240.webp",
               "gif": "gif_animated_interlaced_320x240.gif",
               "tiff_lzw_tiles": "tiff_lzw_tiles_640x480.tif",
               "tiff_jpeg": "tiff_jpeg_ycbcr_320x240.tif",
               "sun_raster": "sun_raster_palette_320x240.ras",
               "pfm": "pfm_160x120.pfm",
               "hdr_rle": "hdr_rle_320x240.hdr",
               "tiff_ccitt_g4": "tiff_ccitt_g4_640x480.tif",
               "jp2_reversible": "jp2_reversible_tiles_640x480.jp2",
               "jp2_irreversible": "jp2_irreversible_640x480.jp2"}
STILL_UPLOADS = ("webp_lossy_640x480.webp", "webp_lossless_320x240.webp",
                 "gif_animated_interlaced_320x240.gif", "ppm16_160x120.ppm",
                 "bmp8_320x240.bmp", "png_exif_320x240.png", "tiff_lzw_tiles_640x480.tif",
                 "tiff_jpeg_ycbcr_320x240.tif", "tiff_palette_orientation6_160x120.tif",
                 "sun_raster_palette_320x240.ras", "pfm_160x120.pfm", "hdr_rle_320x240.hdr",
                 "tiff_ccitt_g4_640x480.tif", "jp2_irreversible_640x480.jp2")
DETECT_STILL = "bmp8_320x240.bmp"
DETECT_SINGLES = ("webp_lossy_640x480.webp", "tiff_lzw_tiles_640x480.tif",
                  "jp2_irreversible_640x480.jp2")
# The video phase: two Motion-JPEG AVIs of seeded 640x480 frames at 25 fps,
# detected at batch 8; extract_frames takes every 4th frame.
# Random weights score ~100 boxes a frame above 0.5; the threshold is the
# median over the first batch of each frame's VIDEO_BOXES-th score, so a
# drawn frame holds about as many boxes as a trained model's would.
VIDEO_FRAMES, VIDEO_FPS, VIDEO_B, VIDEO_EVERY, VIDEO_SEED = 128, 25, 8, 4, 9
VIDEO_BOXES, VIDEO_IDLE_FRAMES = 8, 64
# The MP4 phase: the committed mp4v fixture (tests/fixtures/make_mp4_fixture.py)
# and its OpenCV digests; an AVI of its frames split every MP4_SEGMENT_BYTES
# (a few segments); cli.visualise over MP4_VIS_FRAMES synthetic images.
MP4_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures",
                           "mp4v_640x480.mp4")
MP4_DIGESTS = MP4_FIXTURE[:-len(".mp4")] + ".json"
MP4_FRAMES, MP4_SEGMENT_BYTES, MP4_VIS_FRAMES = 48, 1 << 18, 12
# The MPEG-4 B-VOP phase: the committed XVID AVI with two B-VOPs between
# references (tests/fixtures/make_mp4_fixture.py) and its OpenCV digests.
BVOP_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures",
                            "xvid_bf2_640x480.avi")
BVOP_DIGESTS = BVOP_FIXTURE[:-len(".avi")] + ".json"
BVOP_FRAMES = 48
# ... and in the same phase the quarter-sample XviD AVI (XviD's user data,
# so the XviD IDCT; tests/fixtures/make_mp4_fixture.py xvid_qpel).
QPEL_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures",
                            "xvid_qpel_640x480.avi")
QPEL_DIGESTS = QPEL_FIXTURE[:-len(".avi")] + ".json"
QPEL_FRAMES, QPEL_USER_DATA = 48, b"\x00\x00\x01\xb2XviD0050"
# The WebM phase: the committed VP8 WebM (tests/fixtures/make_mp4_fixture.py)
# and its OpenCV digests.
WEBM_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures",
                            "vp8_640x480.webm")
WEBM_DIGESTS = WEBM_FIXTURE[:-len(".webm")] + ".json"
WEBM_FRAMES = 48
# ... and in the same phase the VP9 WebM: two passes with alt-ref frames
# (superframes of hidden frames, compound prediction), 2 tile columns,
# backward adaptation (tests/fixtures/make_mp4_fixture.py vp9).
VP9_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures",
                           "vp9_640x480.webm")
VP9_DIGESTS = VP9_FIXTURE[:-len(".webm")] + ".json"
VP9_FRAMES = 48
# ... and the H.264 MP4: CAVLC I and P pictures from the tests' own encoder,
# an IDR every 12 frames, two slices a picture, the loop filter on
# (tests/fixtures/make_h264_fixture.py).
H264_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures",
                            "h264_640x480.mp4")
H264_DIGESTS = H264_FIXTURE[:-len(".mp4")] + ".json"
H264_FRAMES = 48
# ... and the High profile H.264 Matroska file: CABAC, the 8x8 transform
# (intra 8x8 and 8x8 inter residuals) and PPS scaling lists, from the same
# encoder, two slices a picture (tests/fixtures/make_h264_cabac_fixture.py).
H264_CABAC_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                                  "fixtures", "h264_cabac_640x480.mkv")
H264_CABAC_DIGESTS = H264_CABAC_FIXTURE[:-len(".mkv")] + ".json"
# ... and the B-frame H.264 MP4: a High profile CABAC B pyramid with spatial
# and temporal direct prediction, explicit weights (P and B) in the first IDR
# period and implicit ones in the second, bitstream_restriction, ctts and the
# shifted edit list (tests/fixtures/make_h264_bframes_fixture.py).
H264_BFRAMES_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                                    "fixtures", "h264_bframes_640x480.mp4")
H264_BFRAMES_DIGESTS = H264_BFRAMES_FIXTURE[:-len(".mp4")] + ".json"
# Every drawn _det.mp4 (MPEG-4 Part 2 from the port's encoder): each frame's
# PSNR against the drawn frame is at least this, a floor that a wrong colour
# conversion or a broken decode falls far below.  tests/test_torch_mpeg4_enc.py
# holds the encoder to it on the phases' kinds of frame with 32 labelled boxes
# each on the CPU (23.0 dB at worst there; fewer boxes, higher).
DRAWN_PSNR_DB = 20.0

# Launches per main-path batch of each path; a kernel missing from a path
# must not launch there.
HIER_LAUNCHES = {"anchor_scores": 1, "topk_indices": 2, "gather_decode_top_m": 1,
                 "finalize_candidates": 1, "nms_keep_mask": 1, "compact_and_pad": 1}
DET_LAUNCHES = {"anchor_scores": 1, "topk_indices": 2, "gather_decode_pairs": 1,
                "nms_keep_mask": 1, "compact_and_pad": 1}
CONV_LAUNCHES = dict(HIER_LAUNCHES, conv_down2_bn_leaky=3)
FRCNN_LAUNCHES = {"multilevel_roi_align": 1, "nms_keep_mask": 2, "topk_indices": 1,
                  "compact_and_pad": 1}
SSD_LAUNCHES = {"topk_indices": 2, "nms_keep_mask": 1, "compact_and_pad": 1}
# K8's kernels on each route (``conv_cuda.route``), the convolution first:
# a window times the ones its shape takes.
K8_ROUTE_KERNELS = {"tma": ("conv_bf16_tma_kernel", "pack_weights_kernel"),
                    "scalar": ("conv_bf16_scalar_kernel",), "f32": ("conv_f32_kernel",)}
# The CUDA kernels each wrapper launches (substrings of the names the
# profiler gives them): a profiler window of a call must hold them all.
KERNEL_NAMES = {
    "anchor_scores": ("anchor_scores_kernel",),
    "topk_indices": ("topk_radix_select_kernel",),
    "gather_decode_pairs": ("gather_decode_kernel",),
    "gather_decode_top_m": ("gather_decode_top_m_kernel",),
    "finalize_candidates": ("finalize_kernel",),
    "nms_keep_mask": ("nms_mask_kernel", "nms_scan_kernel"),
    "compact_and_pad": ("compact_kernel",),
    "conv_down2_bn_leaky": K8_ROUTE_KERNELS["tma"],  # the route of the path's three layers
    "multilevel_roi_align": ("roi_align_kernel",),
}
# torch.profiler windows a timing may take before the run fails; a window
# that misses a kernel launch is logged here and taken again after a pause.
# Whole windows are lost in bursts: three in a row once failed a run (SSD's
# K2 timing), so a timing takes up to eight.
PROFILER_WINDOWS = 8
PROFILER_RETRY_PAUSE_S = 0.5
INCOMPLETE_WINDOWS: list = []
# The spin kernel (``torch.cuda._sleep``) runs about this many cycles a ms
# (the H100's 1.98 GHz boost clock; a lower clock only spins longer).
SPIN_CYCLES_PER_MS = 2_000_000
# Short spin kernels that open each profiler window (``profile_kernels``),
# and the spins of each window the profiler lost.
WINDOW_OPENERS = 16
SPINS_LOST: list = []


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of CUDA-event timings of ``fn`` over ``reps`` runs."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profile_kernels(fn, reps: int = 10, names=()) -> dict:
    """The device activity of ``reps`` calls of ``fn`` under torch.profiler:
    {kernel name: (device ms in all, times run)}.

    A window is complete when each kernel in it ran a whole multiple of
    ``reps`` times and each of ``names`` (substrings of the names of the
    kernels ``fn`` must launch) is among them.  After some 30 windows in
    one process the profiler drops the first one or two kernel records of
    a window, whatever their length, and now and then every record of a
    window.  So a window opens with WINDOW_OPENERS short spin kernels and
    a synchronisation, and closes with one spin; spins the profiler lost
    are counted in SPINS_LOST.  An incomplete window is logged in
    INCOMPLETE_WINDOWS and taken again after PROFILER_RETRY_PAUSE_S, and
    the run fails after PROFILER_WINDOWS of them in one timing.
    """
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILER_WINDOWS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(WINDOW_OPENERS):
                torch.cuda._sleep(SPIN_CYCLES_PER_MS // 1000)
            torch.cuda.synchronize()
            for _ in range(reps):
                fn()
            torch.cuda._sleep(SPIN_CYCLES_PER_MS // 1000)
            torch.cuda.synchronize()
        device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        lost = WINDOW_OPENERS + 1 - sum(e.count for e in device if "spin_kernel" in e.key)
        if lost:
            SPINS_LOST.append(lost)
        events = {e.key: (e.self_device_time_total / 1e3, e.count) for e in device
                  if "spin_kernel" not in e.key}
        missing = [n for n in names if not any(n in key for key in events)]
        partial = [[key[:120], count] for key, (_, count) in events.items() if count % reps]
        if events and not missing and not partial:
            return events
        INCOMPLETE_WINDOWS.append(dict(names=list(names), reps=reps, kernels=len(events),
                                       missing=missing, partial=partial, spins_lost=lost))
        time.sleep(PROFILER_RETRY_PAUSE_S)
    raise RuntimeError(f"check failed: {PROFILER_WINDOWS} incomplete profiler windows: "
                       f"{INCOMPLETE_WINDOWS[-PROFILER_WINDOWS:]}")


def device_ms(fn, reps: int = 10, names=()) -> float:
    """Device time per call of ``fn``: the time of the kernels it runs as
    torch.profiler records them (see ``profile_kernels``)."""
    return sum(ms for ms, _ in profile_kernels(fn, reps, names).values()) / reps


def queued_ms(fn, reps: int = 20):
    """Device time per call of ``fn`` on CUDA events, without the profiler:
    ``reps`` calls queued behind a spin kernel that outlasts twice the
    host's time to queue them, so that they run back to back once it ends
    (the gaps between kernels included).  None where the host still took
    longer than the spin, as it does where ``fn`` synchronises."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    host_one_ms = (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize()
    spin_ms = min(2 * reps * host_one_ms + 1.0, 500.0)
    spin, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    spin.record()
    torch.cuda._sleep(int(spin_ms * SPIN_CYCLES_PER_MS))
    start.record()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t) * 1e3
    end.record()
    end.synchronize()
    if host_ms >= spin.elapsed_time(start):
        return None
    return start.elapsed_time(end) / reps


def timings(kernel, plain, library=None, plain_reps: int = 10, names=()) -> dict:
    """``ms`` / ``plain_ms`` / ``library_ms``: device time per call from the
    profiler, each window holding every kernel in ``names`` that ``kernel``
    launches; ``queued_ms`` / ``library_queued_ms`` the same time from CUDA
    events around calls queued back to back (``queued_ms``);
    ``*call_ms``: CUDA-event time per call, launch overhead included.
    Where ``names`` holds more than one kernel, ``parts_ms`` gives each
    one's device time per call from the same window."""
    out = {"library_ms": None}
    for key, fn, reps, want in (("", kernel, 20, names), ("plain_", plain, plain_reps, ()),
                                ("library_", library, 20, ())):
        if fn is None:
            continue
        out[f"{key}call_ms"] = median_ms(fn, reps=reps)
        reps = min(reps, 10)
        events = profile_kernels(fn, reps, want)
        out[f"{key}ms"] = sum(ms for ms, _ in events.values()) / reps
        if len(want) > 1:
            out["parts_ms"] = {n: sum(ms for kname, (ms, _) in events.items() if n in kname)
                                   / reps for n in want}
        if key != "plain_":  # the plain versions synchronise
            out[f"{key}queued_ms"] = queued_ms(fn)
    return out


def bound_ms(nbytes: float, ops: float, peak: str = "f32"):
    """(least ms, what bounds it, the operation peak used)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAKS[peak] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), peak


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def equal(a, b) -> bool:
    import torch

    return a.shape == b.shape and bool(torch.equal(a, b))


def normalized(batch):
    """uint8 frames or clips normalized on the card, as make_predictor does."""
    import torch

    from viddet_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD

    mean, std = (torch.as_tensor(v, device=batch.device) for v in (IMAGENET_MEAN, IMAGENET_STD))
    return (batch.float() / 255.0 - mean) / std


def set_launches(kernels, value: int = 0) -> None:
    for fn in kernels.values():
        fn.launches = value


def read_launches(kernels, want: dict, what: str) -> dict:
    """The counts since ``set_launches``; each must equal ``want`` (0 for a
    kernel not in it)."""
    got = {name: fn.launches for name, fn in kernels.items()}
    check(got == {name: want.get(name, 0) for name in kernels},
          f"{what} launches {got}, expected {want}")
    return got


def k8_compare(got, want, x, weight, a) -> dict:
    """K8 against its plain version, elementwise.

    Both sides sum the same 9*Cin exact products (bf16 products are exact
    in float32) in float32 in another order, then apply the same affine
    and leaky ReLU and round once.  So an element is held within one bf16
    ulp (float32: ``K8_F32_RTOL`` relative) of the plain version, except
    where the sum nearly cancels: there the two orders may differ by up to
    the float32 summation bound, 2 * K * 2**-24 * sum|x*w| * |a|, which is
    then more than an ulp of the small result.  Such elements must lie
    within that bound plus one rounding of the result.
    """
    import torch
    import torch.nn.functional as F

    k = 9 * x.shape[1]
    sums = F.conv2d(F.pad(x.float().abs(), (0, 1, 0, 1)),
                    weight.to(x.dtype).float().abs(), stride=2)
    acc_bound = 2 * k * 2.0 ** -24 * sums * a.abs()[:, None, None]
    g, w = got.float(), want.float()
    d = (g - w).abs()
    if got.dtype == torch.bfloat16:
        def key(t):  # bf16 bit patterns on a line: adjacent values differ by 1
            v = t.view(torch.int16).int()
            return torch.where(v < 0, -(v & 0x7FFF), v)

        ulp = (key(got) - key(want)).abs()
        near = ulp <= 1
        rounding = 2.0 ** -7 * torch.maximum(g.abs(), w.abs())
        out = {"max_ulp": int(ulp.max().item())}
    else:
        near = d <= K8_F32_RTOL * w.abs()
        rounding = 2.0 ** -22 * torch.maximum(g.abs(), w.abs())
        out = {"max_rel": float((d / w.abs().clamp_min(1e-30)).max().item())}
    far = ~near
    ratio = d[far] / (acc_bound[far] + rounding[far])
    out.update(max_abs_err=float(d.max().item()), share_differ=float((d > 0).float().mean().item()),
               beyond_tolerance=int(far.sum().item()),
               beyond_max_of_sum_bound=float(ratio.max().item()) if ratio.numel() else 0.0)
    check(bool((ratio <= 1).all()),
          f"K8 {got.dtype} within tolerance or the float32 summation bound: {out}")
    return out


# ---------------------------------------------------------------------------
# Phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------


def kernel_phase(dev):
    import torch

    from viddet_tpu_torch.kernels import build
    from viddet_tpu_torch.models.yolo3 import ANCHORS_DARKNET53, STRIDES_DARKNET53
    from viddet_tpu_torch.ops import nms_cuda, nms_gather_cuda, topk_cuda
    from viddet_tpu_torch.ops.nms import _class_offset, _pair_top_k_det

    g = torch.Generator(device="cpu").manual_seed(0)
    rows = {}

    def k1_row(cells):
        """K1 on bf16 cells and their float32 copy against its plain
        version, and its times on the bf16 cells."""
        b = cells[0].shape[0]
        worst_ulp, worst_abs = 0, 0.0
        for xs in (cells, [c.float() for c in cells]):
            got = nms_gather_cuda.anchor_scores(xs, NA)
            want = nms_gather_cuda.anchor_scores_plain(xs, NA)
            check(got.shape == (b, N), "K1 shape")
            ulp = (got.view(torch.int32).long() - want.view(torch.int32).long()).abs().max().item()
            worst_ulp = max(worst_ulp, int(ulp))
            worst_abs = max(worst_abs, float((got - want).abs().max().item()))
        check(worst_ulp <= K1_MAX_ULP, f"K1 at batch {b} within {K1_MAX_ULP} ulp (max {worst_ulp})")
        k1_bytes = sum(c.numel() * 2 for c in cells) + b * N * 4
        return dict(
            batch=b, max_abs_err=worst_abs, max_ulp=worst_ulp,
            bound=bound_ms(k1_bytes, b * N * (NUM_PRED - 5 + 8)),
            **timings(lambda: nms_gather_cuda.anchor_scores(cells, NA),
                      lambda: nms_gather_cuda.anchor_scores_plain(cells, NA),
                      lambda: [torch.sigmoid(c.view(b, -1, NA, NUM_PRED)[..., 5:].amax(-1))
                               for c in cells], names=KERNEL_NAMES["anchor_scores"]),
        )

    # K1: per-scale bf16 cell tensors of the 416-px head at batch 32 and at
    # bench.py's 128 (its own generator, so later rows see the same data).
    cells = [torch.randn((B, c, NA * NUM_PRED), generator=g).mul_(3).to(dev, torch.bfloat16)
             for c in CELLS]
    rows["anchor_scores"] = k1_row(cells)
    g128 = torch.Generator(device="cpu").manual_seed(128)
    cells128 = [torch.randn((4 * B, c, NA * NUM_PRED), generator=g128).mul_(3)
                .to(dev, torch.bfloat16) for c in CELLS]
    rows["anchor_scores_b128"] = k1_row(cells128)
    stage1 = nms_gather_cuda.anchor_scores(cells, NA)

    # K2: stage-1 scores (bf16 logits: many exact ties) and stage-2 pair
    # scores, plus tie-heavy, -1-padded and zero/subnormal rows.
    def hard_rows(x):
        x = x.clone()
        n = x.shape[1]
        x[1] = torch.randint(0, 4, (n,), generator=g).float().div(4).to(dev)  # 4 levels
        x[2] = 0.25  # all equal
        x[3, ::7] = -1.0  # padding
        x[4] = 0.0
        x[4, :20] = torch.rand(20, generator=g).mul(1e-38).to(dev)  # subnormals
        return x.contiguous()

    # pair scores as the tail makes them: sigmoid(obj_k) * sigmoid(cls_k)
    obj_k = torch.sigmoid(torch.randn((B, K, 1), generator=g))
    pair = (obj_k * torch.sigmoid(torch.randn((B, K, PAIRS // K), generator=g))).view(B, PAIRS)
    pair = pair.to(dev)
    k2 = {}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def k2_case(name, x):
        got = topk_cuda.topk_indices(x, K)
        want = topk_cuda.topk_indices_plain(x, K)
        check(equal(got, want), f"K2 {name} equal to plain")
        check(bool((got[:, 1:] > got[:, :-1]).all()), f"K2 {name} ascending")
        k2[name] = dict(
            width=x.shape[1], cluster=topk_cuda.cluster_size(B, x.shape[1], sms),
            bound=bound_ms(x.numel() * 4 + B * K * 8, x.numel() * 34),  # 31 + 3 passes
            **timings(lambda: topk_cuda.topk_indices(x, K),
                      lambda: topk_cuda.topk_indices_plain(x, K),
                      lambda: torch.topk(x, K, dim=1, sorted=False),
                      names=KERNEL_NAMES["topk_indices"]),
        )

    k2_case("stage1", hard_rows(stage1))
    k2_case("stage2_det", hard_rows(pair))
    # K3: the stage-1 winners of those heads in lax.top_k order, as the tail
    # ranks them, plus repeats and the first and last flat index.
    meta = tuple((c, int(round(c ** 0.5)), s, a)
                 for c, s, a in zip(CELLS, STRIDES_DARKNET53, ANCHORS_DARKNET53))
    def k3m0_row(cells, stage1):
        """K3-m0 on bf16 cells and their float32 copy against its plain
        version, and its times on the bf16 cells."""
        b = cells[0].shape[0]
        a_idx = _pair_top_k_det(stage1, K)[1].contiguous()
        a_idx[1, :K // 2] = a_idx[1, K // 2:]
        a_idx[2, 0], a_idx[2, 1] = 0, N - 1
        worst_abs = 0.0
        for xs in (cells, [c.float() for c in cells]):
            got3 = nms_gather_cuda.gather_decode_pairs(xs, a_idx, meta)
            want3 = nms_gather_cuda.gather_decode_pairs_plain(xs, a_idx, meta)
            check(got3[0].shape == (b, K, 4) and got3[1].shape == (b, K, C), "K3 shape")
            check(all(equal(x, y) for x, y in zip(got3, want3)),
                  f"K3 at batch {b}, {xs[0].dtype}, equal to plain")
            worst_abs = max(worst_abs, max(float((x - y).abs().max().item())
                                           for x, y in zip(got3, want3)))
        del xs, got3, want3
        return dict(
            batch=b, max_abs_err=worst_abs,
            # each winner's 5+C bf16 lanes and its index read, boxes and pairs
            # written; 4 operations per class lane, about 30 for the box
            bound=bound_ms(b * K * (NUM_PRED * 2 + 8) + b * K * (4 + C) * 4,
                           b * K * (C * 4 + 30)),
            **timings(lambda: nms_gather_cuda.gather_decode_pairs(cells, a_idx, meta),
                      lambda: nms_gather_cuda.gather_decode_pairs_plain(cells, a_idx, meta),
                      names=KERNEL_NAMES["gather_decode_pairs"]),
        )

    rows["gather_decode_pairs"] = k3m0_row(cells, stage1)
    rows["gather_decode_pairs_b128"] = k3m0_row(cells128, nms_gather_cuda.anchor_scores(cells128,
                                                                                        NA))

    # K3, extract_m=9 (the hierarchical form): winners in K2's ascending
    # order, as the hierarchical tail passes them, with the repeat and
    # first/last-index rows above, and image 3 made so that its boxes tie on
    # their 9th value (objectness all equal, class logits on three levels);
    # timed on the main path's winners, at batch 32 and 128.
    def k3m9_row(cells):
        b = cells[0].shape[0]
        tie_cells = [c.clone() for c in cells]
        for x in tie_cells:
            v = x[3].view(x.shape[1], NA, NUM_PRED)
            v[..., 4] = 1.0
            v[..., 5:] = v[..., 5:].float().round().clamp(-1, 1).to(x.dtype)
        h_idx = topk_cuda.topk_indices(nms_gather_cuda.anchor_scores(tie_cells, NA), K)
        h_idx[1, :K // 2] = h_idx[1, K // 2:]
        h_idx[2, 0], h_idx[2, 1] = 0, N - 1
        worst_abs, ninth_ties = 0.0, 0
        for xs in (tie_cells, [c.float() for c in tie_cells]):
            got9 = nms_gather_cuda.gather_decode_top_m(xs, h_idx, meta, TOP_M, HOT_J)
            want9 = nms_gather_cuda.gather_decode_pairs_plain(xs, h_idx, meta, TOP_M, HOT_J)
            check([tuple(t.shape) for t in got9] == [(b, K, 4), (b, K, TOP_M), (b, K, TOP_M),
                                                     (b, HOT_J, C), (b, 1, HOT_J)], "K3-m9 shapes")
            check(all(equal(x, y) for x, y in zip(got9, want9)),
                  f"K3-m9 at batch {b} equal to plain")
            worst_abs = max(worst_abs, max(float((x - y).abs().max().item())
                                           for x, y in zip(got9, want9)))
            ninth = got9[1][3, :, TOP_M - 1]
            ninth_ties = max(ninth_ties, int((ninth == ninth[got9[4][3, 0, -1]]).sum().item()))
        check(ninth_ties > HOT_J, f"K3-m9: image 3 ties on the 9th value ({ninth_ties} boxes)")
        del tie_cells, xs, got9, want9
        a_hier = topk_cuda.topk_indices(nms_gather_cuda.anchor_scores(cells, NA), K)
        return a_hier, dict(
            batch=b, max_abs_err=worst_abs, ninth_value_ties=ninth_ties,
            # each winner's 5+C bf16 lanes and its index read; boxes, v_m, i_m
            # and the hot rows and ids written; per winner 4 operations a class
            # lane, about 30 for the box, 2 a class lane per top-m step, and 3
            # a pair of the per-image rank
            bound=bound_ms(b * K * (NUM_PRED * 2 + 8) + b * K * (16 + TOP_M * 12)
                           + b * HOT_J * (C * 4 + 8),
                           b * K * (C * 4 + 30 + TOP_M * C * 2) + b * K * K * 3),
            **timings(lambda: nms_gather_cuda.gather_decode_top_m(cells, a_hier, meta, TOP_M,
                                                                  HOT_J),
                      lambda: nms_gather_cuda.gather_decode_pairs_plain(cells, a_hier, meta,
                                                                        TOP_M, HOT_J),
                      names=KERNEL_NAMES["gather_decode_top_m"]),
        )

    a_hier, rows["gather_decode_top_m"] = k3m9_row(cells)
    a_hier128, rows["gather_decode_top_m_b128"] = k3m9_row(cells128)

    # K4: the main path's merged stage-2 ranking of those heads (bf16, and
    # their float32 copy), with winners forced into both sections (the
    # first and last of each); timed on the bf16 heads' ranking.
    def k4_row(cells, a_hier):
        b = cells[0].shape[0]
        width = K * (TOP_M - 1)
        worst_abs, timed = 0.0, None
        for xs in (cells, [c.float() for c in cells]):
            boxes_k, v_m, i_m, hot_flat, hot_idx = nms_gather_cuda.gather_decode_top_m(
                xs, a_hier, meta, TOP_M, HOT_J)
            merged = torch.cat([v_m[..., : TOP_M - 1].reshape(b, width),
                                hot_flat.reshape(b, -1)], 1)
            q = _pair_top_k_det(merged, TOPK)[1].contiguous()
            from_repair = int((q >= width).sum().item())
            q[0, :4] = torch.tensor([0, width - 1, width, width + HOT_J * C - 1], device=dev)
            args = (i_m, hot_idx, q, boxes_k, C)
            got4 = nms_gather_cuda.finalize_candidates(*args)
            want4 = nms_gather_cuda.finalize_candidates_plain(*args)
            check(all(equal(x, y) for x, y in zip(got4, want4)),
                  f"K4 at batch {b}, {xs[0].dtype} heads, equal to plain")
            worst_abs = max(worst_abs, max(float((x - y).abs().max().item())
                                           for x, y in zip(got4, want4)))
            if timed is None:
                timed, timed_merged, timed_from_repair = args, merged, from_repair
        del xs
        return timed_merged, dict(
            batch=b, max_abs_err=worst_abs, main_path_winners_from_repair=timed_from_repair,
            # per winner: q, one class id or hot id, one box read; class, box written
            bound=bound_ms(b * TOPK * (8 + 8 + 16 + 4 + 16), b * TOPK * 10),
            **timings(lambda: nms_gather_cuda.finalize_candidates(*timed),
                      lambda: nms_gather_cuda.finalize_candidates_plain(*timed),
                      names=KERNEL_NAMES["finalize_candidates"]),
        )

    merged, rows["finalize_candidates"] = k4_row(cells, a_hier)
    rows["finalize_candidates_b128"] = k4_row(cells128, a_hier128)[1]
    del cells128, a_hier128
    k2_case("stage2_hier", hard_rows(merged))  # its -1.0 sentinels kept

    main_calls = [k2[name] for name in ("stage1", "stage2_hier")]
    rows["topk_indices"] = dict(  # per main-path (hierarchical) batch: both calls
        max_abs_err=0.0, per_call=k2,
        **{key: None if any(v[key] is None for v in main_calls)
           else sum(v[key] for v in main_calls)
           for key in ("ms", "plain_ms", "library_ms", "call_ms", "plain_call_ms",
                       "library_call_ms", "queued_ms", "library_queued_ms")},
        bound=bound_ms(sum(x.numel() * 4 + B * K * 8 for x in (stage1, merged)),
                       sum(x.numel() * 34 for x in (stage1, merged))),
    )

    # K5: class-offset candidate boxes with duplicates, nested boxes, and
    # all-invalid / all-valid rows.
    pts = torch.rand((B, K, 2, 2), generator=g) * 416
    boxes = torch.cat([pts.amin(2), pts.amax(2)], dim=-1)
    boxes[1, 1::2] = boxes[1, 0::2]  # exact duplicates
    centre = boxes[2, :1, :2].add(boxes[2, :1, 2:]).div(2)
    half = torch.linspace(200, 1, K)[:, None]
    boxes[2] = torch.cat([centre - half, centre + half], dim=-1)  # nested
    boxes[5] = boxes[5, :1]  # one box, repeated
    cls = torch.randint(0, 80, (B, K), generator=g).float()
    cls[1:3] = 0.0
    cls[5] = 3.0
    valid = torch.rand((B, K), generator=g) > 0.2
    valid[3] = False
    valid[4:6] = True
    boxes, cls, valid = boxes.to(dev), cls.to(dev), valid.to(dev)
    offset = _class_offset(boxes, cls).contiguous()
    got = nms_cuda.nms_keep_mask(offset, valid, 0.45)
    want = nms_cuda.nms_keep_mask_plain(offset, valid, 0.45)
    check(equal(got, want), "K5 equal to plain")
    check(got[3].sum().item() == 0 and got[5].sum().item() == 1, "K5 edge rows")
    pairs = K * (K - 1) // 2
    rows["nms_keep_mask"] = dict(
        max_abs_err=0.0, **k5_serial_bound(dev, build, K),
        bound=bound_ms(B * K * (16 + 1 + 4), B * pairs * 24),
        **timings(lambda: nms_cuda.nms_keep_mask(offset, valid, 0.45),
                  lambda: nms_cuda.nms_keep_mask_plain(offset, valid, 0.45), plain_reps=5,
                  names=KERNEL_NAMES["nms_keep_mask"]),
    )

    # K6: the keep mask above, with an all-kept and a none-kept row.
    keep = got.clone()
    keep[0] = 1.0
    keep[3] = 0.0
    scores = torch.sort(torch.rand((B, K), generator=g), dim=1, descending=True).values.to(dev)
    got6 = nms_cuda.compact_and_pad(keep, scores, cls, boxes, POST)
    want6 = nms_cuda.compact_and_pad_plain(keep, scores, cls, boxes, POST)
    check(all(equal(a, b) for a, b in zip(got6, want6)), "K6 equal to plain")
    check(bool((got6[0][3] == -1).all()) and bool((got6[0][0] >= 0).all()), "K6 edge rows")
    rows["compact_and_pad"] = dict(
        max_abs_err=0.0,
        bound=bound_ms(B * K * (4 * 3 + 16) + B * POST * 24, B * K * 4),
        **timings(lambda: nms_cuda.compact_and_pad(keep, scores, cls, boxes, POST),
                  lambda: nms_cuda.compact_and_pad_plain(keep, scores, cls, boxes, POST),
                  names=KERNEL_NAMES["compact_and_pad"]),
    )
    return rows


def scan_round_ns(dev, build, k: int) -> float:
    """Latency of one tile round of K5's greedy scan at ``k`` boxes, in ns:
    the probe (csrc/latency_probe.cu) timed at 1 and 101 passes of
    ceil(k/64) rounds, the difference over 100 passes' rounds."""
    import torch

    lib = build.library()
    out = torch.empty(32, dtype=torch.int64, device=dev)

    def run(passes):
        build.check(lib.viddet_scan_round_probe(k, passes, out.data_ptr(), build.stream_of(out)),
                    "scan_round_probe")

    one, many = median_ms(lambda: run(1)), median_ms(lambda: run(101))
    return (many - one) / (100 * -(-k // 64)) * 1e6


def k5_serial_bound(dev, build, k: int) -> dict:
    """K5's chain bound, which ``bound`` (bytes and operations) leaves out:
    the scan's ceil(k/64) dependent tile rounds (64 register steps and two
    barriers each) times one round's latency."""
    words = -(-k // 64)
    round_ns = scan_round_ns(dev, build, k)
    return dict(serial_steps=words, scan_round_ns=round_ns,
                serial_bound_ms=words * round_ns * 1e-6)


def floor_grids(b: int) -> dict:
    """(blocks, threads, dynamic shared bytes) at batch ``b`` of the launches
    whose times are set beside an empty kernel of their own grid: K3-m0, K4
    and K6 as their C entry points launch them (K3-m0: 16 winners a block of
    128 threads, ``kPairRun``; K4: a block per image of ceil(topk / 32) warps
    staging k boxes and the hot ids; K6: a block per image of ceil(k / 32)
    warps), and as their first designs did (``_first``: K3-m0 a warp per
    winner, K4 a thread per winner in blocks of 128, K6 blocks of 256)."""
    return {
        "gather_decode_pairs": (-(-b * K // 16), 128, 0),
        "gather_decode_pairs_first": (-(-b * K // 4), 128, 0),
        "finalize_candidates": (b, min(1024, -(-TOPK // 32) * 32), K * 16 + HOT_J * 8),
        "finalize_candidates_first": (-(-b * TOPK // 128), 128, 0),
        "compact_and_pad": (b, min(1024, -(-K // 32) * 32), 0),
        "compact_and_pad_first": (b, 256, 0),
    }


def launch_floor_ms(dev, build) -> dict:
    """The least device time a launch shows on this card: an empty kernel
    (csrc/latency_probe.cu) through the same C interface as the port's
    kernels, of one block of one warp, under the profiler (``device``) and
    on CUDA events behind a spin kernel (``queued``); and at each grid of
    ``floor_grids`` at batch 32 and 128 (``grids``), the empty kernel and
    the probe's round trip (each thread loads a word and stores it)."""
    import torch

    lib = build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def floor(blocks, threads, smem, copy=False):
        words = torch.zeros(2 * blocks * threads if copy else 2, dtype=torch.int32, device=dev)
        src, dst = (words.data_ptr(), words.data_ptr() + 4 * blocks * threads) if copy \
            else (None, None)
        names = ("round_trip_kernel",) if copy else ("launch_floor_kernel",)

        def run():
            build.check(lib.viddet_launch_floor_probe(blocks, threads, smem, src, dst, stream),
                        "launch_floor_probe")

        return dict(device=device_ms(run, 10, names), queued=queued_ms(run))

    grids = {str(b): {name: dict(grid=list(shape), **floor(*shape),
                                 round_trip=floor(*shape, copy=True))
                      for name, shape in floor_grids(b).items()} for b in (B, 4 * B)}
    return dict(floor(1, 32, 0), grids=grids)


def k8_l2_bytes(b: int, cin: int, cout: int, hw: int) -> dict:
    """Bytes the TMA kernel's tiles fetch from L2 on one call: each chunk's
    input box (its cells inside the tensor map; the rest are zero-filled,
    not read) and weight box (N rows of 128 bytes), for every tile."""
    from viddet_tpu_torch.ops import conv_cuda

    h2 = w2 = hw // 2
    r, c = conv_cuda.tile_shape(h2, w2)
    n = conv_cuda.tile_n(cout)
    tiles_y, tiles_x, tiles_n = -(-h2 // r), -(-w2 // c), -(-cout // n)
    x_bytes = 0
    for row, _, col, c0, _, _ in conv_cuda.k_schedule(cin):
        rows = sum(min(r, max(0, h2 - (ty * r + row))) for ty in range(tiles_y))
        cols = sum(min(c, max(0, w2 - (tx * c + col))) for tx in range(tiles_x))
        chans = min(conv_cuda.CHUNK, (cin if col else 2 * cin) - c0)
        x_bytes += rows * cols * chans * 2
    chunks = len(conv_cuda.k_schedule(cin))
    w_bytes = tiles_y * tiles_x * sum(min(n, cout - n0) for n0 in range(0, cout, n)) \
        * chunks * conv_cuda.CHUNK * 2
    return dict(input=b * tiles_n * x_bytes, weights=b * w_bytes,
                tiles=b * tiles_y * tiles_x * tiles_n, tile=[r, c],
                tile_waste=conv_cuda.tile_waste(h2, w2, r, c))


def conv_kernel_phase(dev) -> dict:
    """K8 at the three Darknet-53 layers it takes at batch 32 and 416 px and
    at one narrow edge shape, in bf16 and float32, against its plain
    version, with the route each shape took; times summed over the three
    layers and per layer, with the present ``ConvBNLeaky`` path (cuDNN
    convolution, BatchNorm, leaky ReLU) as the library call.  Per layer
    also: its bound, TB/s and TFLOP/s, the route's kernel alone
    (``kernel_only_ms``; ``ms`` holds the wrapper's weight packing too), the
    bytes its tiles read from L2, and cuDNN's ``F.conv2d`` alone on the
    padded bf16 input (``conv_only_ms``, a yardstick for the GEMM part)."""
    import torch
    import torch.nn.functional as F

    from viddet_tpu_torch.models.common import ConvBNLeaky
    from viddet_tpu_torch.ops import conv_cuda

    g = torch.Generator(device=dev).manual_seed(8)

    def case(b, cin, cout, hw):
        x = F.leaky_relu(torch.randn((b, cin, hw, hw), generator=g, device=dev), 0.1)
        x = x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        w = torch.randn((cout, cin, 3, 3), generator=g, device=dev) * (2.0 / (9 * cin)) ** 0.5
        scale = torch.rand(cout, generator=g, device=dev) + 0.5
        bias = torch.randn(cout, generator=g, device=dev)
        mean = torch.randn(cout, generator=g, device=dev) * 0.1
        var = torch.rand(cout, generator=g, device=dev) * 1.5 + 0.5
        return x, w, scale, bias, mean, var

    checks, per_layer, kernel_fns, plain_fns, library_fns = [], [], [], [], []
    nbytes = ops = 0
    for b, cin, cout, hw in [(B,) + layer for layer in K8_LAYERS] + [K8_EDGE]:
        args = case(b, cin, cout, hw)
        a = conv_cuda.fold_bn(*args[2:], 1e-5)[0]
        for x in (args[0], args[0].float().contiguous(memory_format=torch.channels_last)):
            xa = (x,) + args[1:]
            got = conv_cuda.conv_down2_bn_leaky(*xa)
            check(tuple(got.shape) == (b, cout, hw // 2, hw // 2) and got.dtype == x.dtype
                  and got.is_contiguous(memory_format=torch.channels_last), "K8 output")
            checks.append(dict(shape=[b, cin, cout, hw], dtype=str(x.dtype).split(".")[-1],
                               route=conv_cuda.route(x, cout),
                               **k8_compare(got, conv_cuda.conv_down2_bn_leaky_plain(*xa),
                                            x, args[1], a)))
        if b != B:
            continue
        route = conv_cuda.route(args[0], cout)
        names = K8_ROUTE_KERNELS[route]
        check(names == KERNEL_NAMES["conv_down2_bn_leaky"], f"K8 path layer route {route}")
        layer = ConvBNLeaky(cin, cout, 3, stride=2).to(dev).eval()
        layer.conv.weight.copy_(args[1])
        for p, v in zip((layer.bn.weight, layer.bn.bias, layer.bn.running_mean,
                         layer.bn.running_var), args[2:]):
            p.copy_(v)
        kernel_fns.append(lambda args=args: conv_cuda.conv_down2_bn_leaky(*args))
        plain_fns.append(lambda args=args: conv_cuda.conv_down2_bn_leaky_plain(*args))
        library_fns.append(lambda layer=layer, x=args[0]: layer(x))
        m = b * (hw // 2) ** 2
        layer_bytes = b * hw * hw * cin * 2 + 9 * cin * cout * 2 + cout * 8 + m * cout * 2
        layer_ops = 2 * m * cout * 9 * cin
        nbytes += layer_bytes
        ops += layer_ops
        row = dict(shape=[b, cin, cout, hw], route=route,
                   bound=bound_ms(layer_bytes, layer_ops, "bf16_tensor"),
                   **timings(kernel_fns[-1], None, library_fns[-1], names=names))
        events = profile_kernels(kernel_fns[-1], 10, names)
        row["kernel_only_ms"] = sum(ms for key, (ms, _) in events.items() if names[0] in key) / 10
        xpad = F.pad(args[0], (0, 1, 0, 1)).contiguous(memory_format=torch.channels_last)
        wconv = args[1].to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        conv_only = lambda xpad=xpad, wconv=wconv: F.conv2d(xpad, wconv, stride=2)
        row["conv_only_ms"] = device_ms(conv_only, 10)
        row["conv_only_queued_ms"] = queued_ms(conv_only)
        l2 = k8_l2_bytes(b, cin, cout, hw)
        row.update(tb_per_s=layer_bytes / row["kernel_only_ms"] / 1e9,
                   tflop_per_s=layer_ops / row["kernel_only_ms"] / 1e9,
                   l2_bytes=l2, hbm_bytes=layer_bytes,
                   persistent_blocks=min(l2["tiles"], torch.cuda.get_device_properties(dev)
                                         .multi_processor_count))
        per_layer.append(row)
    worst = max(checks, key=lambda r: r["max_abs_err"])
    total = dict(
        max_abs_err=worst["max_abs_err"], checks=checks, per_layer=per_layer,
        bound=bound_ms(nbytes, ops, "bf16_tensor"),
        **timings(lambda: [f() for f in kernel_fns], lambda: [f() for f in plain_fns],
                  lambda: [f() for f in library_fns], plain_reps=5,
                  names=KERNEL_NAMES["conv_down2_bn_leaky"]),
        library="ConvBNLeaky default path: F.pad, cuDNN F.conv2d, F.batch_norm, F.leaky_relu",
    )
    for key in ("kernel_only_ms", "conv_only_ms"):
        total[key] = sum(r[key] for r in per_layer)
    return total


def roi_align_traffic(pyramid, rois, strides) -> dict:
    """What K7 reads for these rois, counted from the same sample indices:
    ``taps`` (valid samples x 4 neighbours), ``cells_per_roi`` (each roi's
    distinct cells, summed), ``cells_batch`` (the batch's distinct cells,
    (image, level, row, column): what the bound counts), and the bytes that
    reach the SMs from L2 when every tap is a load of its own channel row
    (``l2_bytes_per_tap``) and when L1 serves every repeat of a cell within
    its roi's block, as the kernel's design intends (``l2_bytes_design``,
    csrc/roi_align.cu)."""
    import torch

    from viddet_tpu_torch.ops.roi_align import fpn_roi_level, sample_grid

    dev = rois.device
    b = rois.shape[0]
    lvl = (fpn_roi_level(rois, k_max=len(pyramid) + 1) - 2).long()
    ys, xs = sample_grid(rois, lvl, strides, 7, 2)
    hs = torch.tensor([p.shape[1] for p in pyramid], device=dev)[lvl][..., None]
    ws = torch.tensor([p.shape[2] for p in pyramid], device=dev)[lvl][..., None]
    sizes = [p.shape[1] * p.shape[2] for p in pyramid]
    offsets = torch.tensor([sum(sizes[:i]) for i in range(len(sizes))], device=dev)
    row_bytes = pyramid[0].shape[-1] * pyramid[0].element_size()

    def taps(coord, ext):
        ok = (coord > -1.0) & (coord < ext.float())
        c0 = torch.minimum(coord.clamp_min(0.0), ext.float() - 1.0).floor().long()
        return ok, c0, torch.minimum(c0 + 1, ext - 1)

    def distinct(vals, ok):
        """Distinct values among the valid ones, along the last axis."""
        v = torch.where(ok, vals, -1).sort(-1).values
        new = torch.ones_like(v, dtype=torch.bool)
        new[..., 1:] = v[..., 1:] != v[..., :-1]
        return (new & (v >= 0)).sum(-1)

    oky, y0, y1 = taps(ys, hs)
    okx, x0, x1 = taps(xs, ws)
    base = (torch.arange(b, device=dev)[:, None] * sum(sizes) + offsets[lvl])[..., None, None]
    ok = oky[..., :, None] & okx[..., None, :]
    cells = [(base + (yi * ws)[..., :, None] + xi[..., None, :])[ok]
             for yi in (y0, y1) for xi in (x0, x1)]
    rows = distinct(torch.cat([y0, y1], -1), torch.cat([oky, oky], -1))
    cols = distinct(torch.cat([x0, x1], -1), torch.cat([okx, okx], -1))
    n_taps = int((4 * oky.sum(-1) * okx.sum(-1)).sum().item())
    per_roi = int((rows * cols).sum().item())
    return dict(taps=n_taps, cells_per_roi=per_roi,
                cells_batch=int(torch.unique(torch.cat(cells)).numel()),
                l2_bytes_per_tap=n_taps * row_bytes, l2_bytes_design=per_roi * row_bytes)


def frcnn_rois(g, dev):
    """(FRCNN_B, FRCNN_R, 4) rois over the 512-px image: sizes 8 to 700 px,
    aspects 1:4 to 4:1, centres up to 20 px outside; image 0 starts with
    edge rois: wholly and partly outside, 1e-3 wide, exactly on each level
    boundary (square and 4:1), clamped to levels 2 and 5, and 8:1 / 1:8
    rois at the top of the level-2 and level-4 bands, wider than the TPU
    kernel's 48-cell window.  Returns (rois, the boundary rois' indices)."""
    import torch

    shape = (FRCNN_B, FRCNN_R)
    size = torch.exp(torch.rand(shape, generator=g) * np.log(700 / 8)) * 8
    aspect = torch.exp((torch.rand(shape, generator=g) * 2 - 1) * np.log(4))
    cx, cy = (torch.rand((2,) + shape, generator=g) * (FRCNN_SIZE + 40) - 20)
    w, h = size * aspect.sqrt(), size / aspect.sqrt()
    rois = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)
    r8 = 8 ** 0.5
    edge = [[-90.0, -60.0, -10.0, -5.0], [480.0, -30.0, 560.0, 40.0],
            [200.0, 200.0, 200.001, 200.001]]
    boundary = []
    for side in (56.0, 112.0, 224.0, 448.0):
        boundary += [len(edge), len(edge) + 1]
        edge += [[10.0, 20.0, 10.0 + side, 20.0 + side],
                 [30.0, 5.0, 30.0 + 2 * side, 5.0 + side / 2]]
    edge += [[100.0, 100.0, 104.0, 104.0], [-200.0, -200.0, 800.0, 800.0],
             [4.0, 40.0, 4.0 + 111.0 * r8, 40.0 + 111.0 / r8],
             [40.0, 4.0, 40.0 + 111.0 / r8, 4.0 + 111.0 * r8],
             [2.0, 300.0, 2.0 + 447.0 * r8, 300.0 + 447.0 / r8]]
    rois[0, : len(edge)] = torch.tensor(edge)
    return rois.to(dev).contiguous(), boundary


def frcnn_kernel_phase(dev) -> dict:
    """K7 at the Faster R-CNN path's shapes (P2..P5 of batch 8 at 512 px,
    300 rois an image, C = 256) on unit-scale features in bf16 and float32;
    K5 at K = 1000 (class-agnostic proposal NMS, IoU 0.7) and at K = 400
    (the detections' NMS, IoU 0.5); K2 at the detection ranking's N =
    24,000, k = 400."""
    import torch

    from viddet_tpu_torch.kernels import build
    from viddet_tpu_torch.ops import nms_cuda, roi_align_cuda, topk_cuda
    from viddet_tpu_torch.ops.roi_align import fpn_roi_level, multilevel_roi_align_packed

    g = torch.Generator(device="cpu").manual_seed(7)
    strides = (4, 8, 16, 32)
    pyr32 = [torch.randn((FRCNN_B, s, s, FPN_C), generator=g).to(dev) for s in FRCNN_LEVELS]
    pyr16 = [p.to(torch.bfloat16) for p in pyr32]
    rois, boundary = frcnn_rois(g, dev)
    levels = fpn_roi_level(rois)
    check(levels[0, boundary].tolist() == [2, 2, 3, 3, 4, 4, 5, 5],
          f"K7 level boundaries: {levels[0, boundary].tolist()}")
    checks = []
    for pyr in (pyr16, pyr32):
        got = roi_align_cuda.multilevel_roi_align(pyr, rois, strides)
        want = multilevel_roi_align_packed(pyr, rois, strides)
        check(got.shape == (FRCNN_B, FRCNN_R, 7, 7, FPN_C), "K7 shape")
        checks.append(dict(dtype=str(pyr[0].dtype).split(".")[-1],
                           max_abs_err=float((got - want).abs().max().item()),
                           bit_equal=equal(got, want)))
        check(checks[-1]["bit_equal"], f"K7 equal to plain: {checks[-1]}")
    traffic = roi_align_traffic(pyr16, rois, strides)
    out_bytes = FRCNN_B * FRCNN_R * 49 * FPN_C * 4
    pyramid_bytes = sum(p.numel() * 2 for p in pyr16)
    rows = {"multilevel_roi_align": dict(
        max_abs_err=max(c["max_abs_err"] for c in checks), checks=checks,
        levels=torch.bincount(levels.flatten(), minlength=6)[2:].tolist(),
        **traffic,
        # the output, the cells the valid samples read (bf16) and the rois
        # once; about 36 operations an output element (4 samples of 4
        # products and 3 sums, 3 sums and a scale)
        bound=bound_ms(out_bytes + traffic["cells_batch"] * FPN_C * 2 + rois.numel() * 4,
                       out_bytes / 4 * 36),
        bound_output_only_ms=out_bytes / HBM_BYTES_PER_S * 1e3,
        bound_whole_pyramid_ms=(out_bytes + pyramid_bytes) / HBM_BYTES_PER_S * 1e3,
        **timings(lambda: roi_align_cuda.multilevel_roi_align(pyr16, rois, strides),
                  lambda: multilevel_roi_align_packed(pyr16, rois, strides), plain_reps=5,
                  names=KERNEL_NAMES["multilevel_roi_align"]),
    )}

    # K5 at K = 1000: proposal boxes (8 to 400 px) in rank order, a few
    # degenerate, image 1 with duplicated runs, image 2 all invalid.
    k = FRCNN_NMS_K
    size = torch.exp(torch.rand((FRCNN_B, k, 2), generator=g) * np.log(50)) * 8
    lo = torch.rand((FRCNN_B, k, 2), generator=g) * FRCNN_SIZE
    boxes = torch.cat([lo, (lo + size).clamp_max(FRCNN_SIZE)], dim=-1)
    boxes[1, 1::4] = boxes[1, 0::4]
    valid = ((boxes[..., 2] - boxes[..., 0] > 1.0) & (boxes[..., 3] - boxes[..., 1] > 1.0)
             & (torch.rand((FRCNN_B, k), generator=g) > 0.05))
    valid[2] = False
    boxes, valid = boxes.to(dev).contiguous(), valid.to(dev)
    got = nms_cuda.nms_keep_mask(boxes, valid, 0.7)
    want = nms_cuda.nms_keep_mask_plain(boxes, valid, 0.7)
    check(equal(got, want), "K5 at K = 1000 equal to plain")
    rows["nms_keep_mask_k1000"] = dict(
        max_abs_err=0.0, k=k, kept_per_image=got.sum(1).int().tolist(),
        **k5_serial_bound(dev, build, k),
        bound=bound_ms(FRCNN_B * k * (16 + 1 + 4), FRCNN_B * k * (k - 1) // 2 * 24),
        **timings(lambda: nms_cuda.nms_keep_mask(boxes, valid, 0.7),
                  lambda: nms_cuda.nms_keep_mask_plain(boxes, valid, 0.7), plain_reps=3,
                  names=KERNEL_NAMES["nms_keep_mask"]),
    )
    # K5 at K = 400, batch 8, IoU 0.5 (the detections' NMS): the first 400
    # of those boxes, with image 1's duplicates and image 2 all invalid.
    b400, v400 = boxes[:, :FRCNN_TOPK].contiguous(), valid[:, :FRCNN_TOPK].contiguous()
    got = nms_cuda.nms_keep_mask(b400, v400, 0.5)
    check(equal(got, nms_cuda.nms_keep_mask_plain(b400, v400, 0.5)),
          "K5 at K = 400, batch 8 equal to plain")
    rows["nms_keep_mask_k400_b8"] = dict(
        max_abs_err=0.0, k=FRCNN_TOPK, **k5_serial_bound(dev, build, FRCNN_TOPK),
        bound=bound_ms(FRCNN_B * FRCNN_TOPK * (16 + 1 + 4),
                       FRCNN_B * FRCNN_TOPK * (FRCNN_TOPK - 1) // 2 * 24),
        **timings(lambda: nms_cuda.nms_keep_mask(b400, v400, 0.5),
                  lambda: nms_cuda.nms_keep_mask_plain(b400, v400, 0.5), plain_reps=3,
                  names=KERNEL_NAMES["nms_keep_mask"]),
    )

    # K2 at the detection ranking: softmax probabilities of 300 rois x 81
    # classes, background dropped; image 1 with tied rows, image 2 all equal.
    logits = torch.randn((FRCNN_B, FRCNN_R, C + 1), generator=g) * 2
    logits[1] = logits[1].round()
    logits[2] = 0.0
    probs = torch.softmax(logits, -1)[..., 1:].reshape(FRCNN_B, FRCNN_PAIRS).to(dev)
    got = topk_cuda.topk_indices(probs, FRCNN_TOPK)
    check(equal(got, topk_cuda.topk_indices_plain(probs, FRCNN_TOPK)),
          "K2 at N = 24,000 equal to plain")
    rows["topk_indices_frcnn"] = dict(
        max_abs_err=0.0, width=FRCNN_PAIRS,
        cluster=topk_cuda.cluster_size(FRCNN_B, FRCNN_PAIRS,
                                       torch.cuda.get_device_properties(dev).multi_processor_count),
        bound=bound_ms(probs.numel() * 4 + FRCNN_B * FRCNN_TOPK * 8, probs.numel() * 34),
        **timings(lambda: topk_cuda.topk_indices(probs, FRCNN_TOPK),
                  lambda: topk_cuda.topk_indices_plain(probs, FRCNN_TOPK),
                  lambda: torch.topk(probs, FRCNN_TOPK, dim=1, sorted=False),
                  names=KERNEL_NAMES["topk_indices"]),
    )
    return rows


# ---------------------------------------------------------------------------
# Phase 4: the main path
# ---------------------------------------------------------------------------

# Kernel-name substrings per group, for the main path's device-time breakdown.
KERNEL_GROUPS = (
    ("port kernels", tuple(n for names in KERNEL_NAMES.values() for n in names)),
    ("convolution", ("conv", "gemm", "xmma", "cutlass", "sm90", "implicit", "winograd")),
    ("batch_norm", ("batch_norm",)),
    ("sort", ("Sort", "sort")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "leaky", "pad", "copy",
                     "cat", "upsample", "CatArray")),
)


def path_kernel_names(launches: dict) -> tuple:
    """The CUDA kernels that a path with this launch table must run."""
    return tuple(n for name in launches for n in KERNEL_NAMES[name])


def kernel_breakdown(fn, names, top: int = 12) -> dict:
    """Device time of one call of ``fn``, by kernel group and top kernels;
    the profiler's window must hold every kernel in ``names``."""
    return grouped(profile_kernels(fn, 1, names), top)


def grouped(events: dict, top: int = 12) -> dict:
    """``profile_kernels``' events of one call by kernel group, and the top
    kernels."""
    groups: dict = {}
    for key, (ms, _) in events.items():
        group = next((g for g, subs in KERNEL_GROUPS if any(x in key for x in subs)), "other")
        groups[group] = groups.get(group, 0.0) + ms
    ranked = sorted(events.items(), key=lambda item: -item[1][0])[:top]
    return {"device_ms": sum(groups.values()), "groups": groups,
            "top": [[key[:90], count, ms] for key, (ms, count) in ranked]}


def check_detections(ids, scores, boxes, batch, num_classes, valid_thresh) -> int:
    import torch

    check(ids.shape == (batch, POST) and scores.shape == (batch, POST)
          and boxes.shape == (batch, POST, 4), "detection shapes")
    check(bool(torch.isfinite(scores).all()) and bool(torch.isfinite(boxes).all()), "finite")
    kept = ids >= 0
    check(bool(((ids == ids.round()) & (ids >= -1) & (ids < num_classes)).all()), "class ids")
    check(bool((scores[kept] > valid_thresh).all()), "kept scores above the threshold")
    check(bool((scores[~kept] == -1).all()) and bool((boxes[~kept] == -1).all()), "padding")
    # kept rows come first, in descending score order
    check(bool((kept[:, 1:] <= kept[:, :-1]).all()), "kept rows first")
    both = kept[:, 1:] & kept[:, :-1]
    check(bool((scores[:, 1:][both] <= scores[:, :-1][both]).all()), "descending scores")
    return int(kept.sum().item())


def main_path_phase(dev, kernels):
    import torch

    from viddet_tpu_torch.cli.common import make_predictor
    from viddet_tpu_torch.models.yolo3 import NMSConfig
    from viddet_tpu_torch.models.zoo import get_model
    from viddet_tpu_torch.ops import nms_gather_cuda, topk_cuda
    from viddet_tpu_torch.ops.nms import multiclass_nms_late_decode_cells
    from viddet_tpu_torch.weights import init_flat, load_flat

    t0 = time.perf_counter()
    model, classes = get_model(MODEL)
    load_flat(model, init_flat(MODEL, seed=0))
    setup_s = time.perf_counter() - t0
    predictor = make_predictor(model)
    rng = np.random.default_rng(0)
    shape = (max(E2E_BATCHES), IMAGE_SIZE, IMAGE_SIZE, 3)
    images = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8))
    images = images.pin_memory()
    main_b = E2E_BATCHES[0]
    batch = images[:main_b].to(dev)
    predictor(batch)  # warm-up: cuDNN heuristics, caching allocator
    torch.cuda.synchronize()

    set_launches(kernels)
    ids, scores, boxes = predictor(batch)
    torch.cuda.synchronize()
    launches = {"hier": read_launches(kernels, HIER_LAUNCHES, "main path (hier)")}
    kept = check_detections(ids, scores, boxes, main_b, len(classes), NMSConfig().valid_thresh)

    # The head once; its outputs through the kernel tail and the plain tail,
    # under the default ranking and then under VIDDET_PAIR_TOPK=det.
    with torch.inference_mode():
        x = normalized(batch)
        out = model(x)

        def tail(backend):
            return multiclass_nms_late_decode_cells(out["raws_cells"], out["meta"],
                                                    backend=backend)

        tails = {b: tail(b) for b in ("auto", "plain")}
        check(all(equal(a, b) for a, b in zip(tails["auto"], tails["plain"])),
              "kernel tail equal to plain tail")
        check(all(equal(a, b) for a, b in zip(tails["auto"], (ids, scores, boxes))),
              "predictor equal to head + kernel tail")
        head_ms = median_ms(lambda: model(x), reps=10)
        tail_ms = median_ms(lambda: tail("auto"), reps=10)
        plain_tail_ms = median_ms(lambda: tail("plain"), reps=5)
        tail_device_ms = device_ms(lambda: tail("auto"), names=path_kernel_names(HIER_LAUNCHES))

        os.environ["VIDDET_PAIR_TOPK"] = "det"
        try:
            set_launches(kernels)
            det = tail("auto")
            torch.cuda.synchronize()
            launches["det"] = read_launches(kernels, DET_LAUNCHES, "det tail")
            check(all(equal(a, b) for a, b in zip(det, tail("plain"))),
                  "det kernel tail equal to det plain tail")
            check_detections(*det, main_b, len(classes), NMSConfig().valid_thresh)
            det_tail_ms = median_ms(lambda: tail("auto"), reps=10)
            det_plain_tail_ms = median_ms(lambda: tail("plain"), reps=5)
            det_tail_device_ms = device_ms(lambda: tail("auto"),
                                           names=path_kernel_names(DET_LAUNCHES))
        finally:
            del os.environ["VIDDET_PAIR_TOPK"]
        same_ids = bool(torch.equal(det[0], ids))

        # The largest batch runs K2 at another cluster size
        # (topk_cuda.cluster_size): its two hier calls and the whole tail
        # against their plain versions there too.
        big_b = max(E2E_BATCHES)
        big = images[:big_b].to(dev)
        big_out = model(normalized(big))
        cells, meta = big_out["raws_cells"], big_out["meta"]
        stage1 = nms_gather_cuda.anchor_scores(cells, NA)
        a_hier = topk_cuda.topk_indices(stage1, K)
        _, v_m, _, hot_flat, _ = nms_gather_cuda.gather_decode_top_m(cells, a_hier, meta, TOP_M,
                                                                     HOT_J)
        merged = torch.cat([v_m[..., : TOP_M - 1].reshape(big_b, -1),
                            hot_flat.reshape(big_b, -1)], 1)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        big_k2 = {}
        for name, x, got in (("stage1", stage1, a_hier),
                             ("stage2_hier", merged, topk_cuda.topk_indices(merged, TOPK))):
            check(equal(got, topk_cuda.topk_indices_plain(x, got.shape[1])),
                  f"K2 {name} at batch {big_b} equal to plain")
            big_k2[name] = dict(width=x.shape[1],
                                cluster=topk_cuda.cluster_size(big_b, x.shape[1], sms))
        big_tail = multiclass_nms_late_decode_cells(cells, meta)
        check(all(equal(a, b) for a, b in
                  zip(big_tail, multiclass_nms_late_decode_cells(cells, meta, backend="plain"))),
              f"kernel tail equal to plain tail at batch {big_b}")
        check(all(equal(a, b) for a, b in zip(big_tail, predictor(big))),
              f"predictor at batch {big_b} equal to head + kernel tail")
        check_detections(*big_tail, big_b, len(classes), NMSConfig().valid_thresh)
        check(all(equal(a, b) for a, b in
                  zip(multiclass_nms_late_decode_cells(cells, meta, ranking="det"),
                      multiclass_nms_late_decode_cells(cells, meta, backend="plain",
                                                       ranking="det"))),
              f"det kernel tail equal to det plain tail at batch {big_b}")
        big_tail_device_ms = {
            ranking: device_ms(lambda: multiclass_nms_late_decode_cells(cells, meta,
                                                                        ranking=ranking),
                               names=path_kernel_names(want))
            for ranking, want in (("hier", HIER_LAUNCHES), ("det", DET_LAUNCHES))}
        del big, big_out, cells, stage1, merged
    step_ms = median_ms(lambda: predictor(batch), reps=10)  # images already on the card
    breakdown = kernel_breakdown(lambda: predictor(batch), path_kernel_names(HIER_LAUNCHES))
    breakdown["step_ms"] = step_ms
    breakdown["idle_share"] = 1.0 - breakdown["device_ms"] / step_ms

    timings = {str(bs): end_to_end(dev, predictor, images, bs, 10 if bs == main_b else 5)
               for bs in E2E_BATCHES}
    emit({"phase": "main_path", "model": MODEL, "size": IMAGE_SIZE,
          "dtype": "bfloat16", "batch": main_b, "setup_s": setup_s, "ranking": "hier",
          "launches": launches, "kept_detections": kept, "tail_equal_plain": True,
          "det_tail_equal_plain": True, "det_ids_equal_hier": same_ids,
          "tail_equal_plain_at_batch": {str(big_b): True, "k2": big_k2},
          "head_ms": head_ms, "tail_ms": tail_ms, "plain_tail_ms": plain_tail_ms,
          "tail_device_ms": tail_device_ms, "det_tail_ms": det_tail_ms,
          "det_plain_tail_ms": det_plain_tail_ms, "det_tail_device_ms": det_tail_device_ms,
          "tail_device_ms_at_batch": {str(main_b): {"hier": tail_device_ms,
                                                    "det": det_tail_device_ms},
                                      str(big_b): big_tail_device_ms},
          "end_to_end": timings, "device_breakdown": breakdown})
    return model, predictor, images, launches, out


def end_to_end(dev, predictor, images, bs: int, reps: int) -> dict:
    """Median host-clock time of ``reps`` steps of uint8 frames from pinned
    host memory to detections on the host, after 2 warm-up steps."""
    import torch

    host = images[:bs]

    def step():
        return [t.cpu() for t in predictor(host.to(dev, non_blocking=True))]

    for _ in range(2):
        step()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(reps):
        t = time.perf_counter()
        step()
        walls.append((time.perf_counter() - t) * 1e3)
    ms = statistics.median(walls)
    return dict(ms_per_batch=ms, frames_per_s=bs / ms * 1e3,
                peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)


# ---------------------------------------------------------------------------
# int8 post-training quantization (quant.py) on the main path
# ---------------------------------------------------------------------------


def int8_cells(model, x):
    """(cell, its input) for every int8 cell of one forward pass on ``x``
    (forward pre-hooks)."""
    import torch

    from viddet_tpu_torch import quant

    caps = []
    hooks = [m.register_forward_pre_hook(lambda m, a: caps.append((m, a[0])))
             for m in quant.quant_cells(model)]
    try:
        with torch.inference_mode():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    return caps


def int8_accumulators(model, x, what: str) -> dict:
    """Each int8 cell's int32 accumulator on its own input, by the card route
    (im2col, ``torch._int_mm``) and the plain float64 route: equal bit for
    bit.  Returns the count and each distinct (M, K', N) GEMM shape."""
    import torch

    from viddet_tpu_torch import quant

    caps = int8_cells(model, x)
    shapes = set()
    with torch.inference_mode():
        for m, inp in caps:
            wq, _, _ = m._int8_folded[1]
            xq = quant.quantize_activations(inp, m.act_amax).permute(0, 2, 3, 1).contiguous()
            card = quant.conv_acc_card(xq, wq, m.stride)
            check(equal(card, quant.conv_acc_plain(xq, wq, m.stride)),
                  f"{what}: {m.scope} accumulator, card route equal to plain")
            a = quant.im2col(xq, wq.shape[1], wq.shape[2], m.stride)
            shapes.add((a.shape[0], a.shape[1], wq.shape[0], wq.shape[1], m.stride))
    return {"cells": len(caps), "equal": True,
            "gemm_shapes_m_k_n_kernel_stride": sorted(shapes)}


def int8_stage_ms(model, x) -> dict:
    """ms of one batch's int8 cells by stage on CUDA events (not the
    profiler: its windows degrade after some 30 in a process), each stage
    timed alone over every cell on the cell's own input: quantize (codes
    of x), im2col, the int8 GEMM (``torch._int_mm``) and the epilogue
    (dequantize, bias, activation, cast).  Each stage queues far less host
    time than it runs on the card (tens of launches a ms)."""
    import torch

    from viddet_tpu_torch import quant

    caps = int8_cells(model, x)
    with torch.inference_mode():
        rows = []
        for m, inp in caps:
            wq, w_amax, b = m._int8_folded[1]
            xq = quant.quantize_activations(inp, m.act_amax).permute(0, 2, 3, 1).contiguous()
            a = quant.im2col(xq, wq.shape[1], wq.shape[2], m.stride)
            acc = torch._int_mm(a, quant.weight_matrix(wq))
            act = "leaky" if hasattr(m, "fused_down2") else ("relu" if m.act else "none")
            rows.append((m, inp, xq, wq, a, acc, w_amax, b, act))
        del caps
        stages = {
            "quantize": lambda: [quant.quantize_activations(r[1], r[0].act_amax) for r in rows],
            "im2col": lambda: [quant.im2col(r[2], r[3].shape[1], r[3].shape[2], r[0].stride)
                               for r in rows],
            "int8_gemm": lambda: [torch._int_mm(r[4], quant.weight_matrix(r[3])) for r in rows],
            "epilogue": lambda: [quant.epilogue(r[5], r[6], r[0].act_amax, r[7], r[8],
                                                torch.bfloat16) for r in rows],
        }
        out = {name: median_ms(fn, reps=5, warmup=1) for name, fn in stages.items()}
    # the GEMMs' work and bytes (each operand read once, the int32 result
    # written once), and the bytes the im2col writes
    macs = sum(r[4].shape[0] * r[4].shape[1] * r[3].shape[0] for r in rows)
    gemm_bytes = sum(r[4].numel() + r[3].numel() + r[5].numel() * 4 for r in rows)
    out.update(cells=len(rows), int8_gemm_macs=macs,
               int8_gemm_bound=bound_ms(gemm_bytes, 2 * macs, "int8_tensor"),
               im2col_bytes=sum(r[4].numel() for r in rows if r[4].data_ptr() != r[2].data_ptr()))
    return out


def match_share(ref, got, iou: float = 0.5) -> float:
    """Share of ``ref``'s kept detections that ``got`` has too: the same
    class and image, IoU >= ``iou``."""
    import torch

    from viddet_tpu_torch.ops.boxes import box_iou

    r_ids, _, r_boxes = ref
    g_ids, _, g_boxes = got
    same = (r_ids[:, :, None] == g_ids[:, None, :]) & (g_ids[:, None, :] >= 0)
    hit = ((box_iou(r_boxes, g_boxes) >= iou) & same).any(dim=2) & (r_ids >= 0)
    return float(hit.sum() / (r_ids >= 0).sum().clamp_min(1))


def int8_phase(dev, kernels, bf16_model, bf16_predictor, images) -> dict:
    """YOLOv3-416 / Darknet-53 / COCO under INT8_POLICY (bf16 compute, int8
    conv cells), seeded weights, calibrated on one batch of the seeded
    frames as ``bench.py``'s int8 variant does; then SSD-512 at batch 32."""
    import torch

    from viddet_tpu_torch import quant
    from viddet_tpu_torch.cli.common import make_predictor
    from viddet_tpu_torch.core.precision import INT8_POLICY
    from viddet_tpu_torch.models.ssd import SSDNMSConfig, ssd_postprocess
    from viddet_tpu_torch.models.yolo3 import NMSConfig, flatten_outputs
    from viddet_tpu_torch.models.zoo import get_model
    from viddet_tpu_torch.ops.nms import multiclass_nms_late_decode_cells
    from viddet_tpu_torch.weights import init_flat, load_flat

    model, classes = get_model(MODEL, policy=INT8_POLICY)
    load_flat(model, init_flat(MODEL, seed=0))
    main_b = E2E_BATCHES[0]
    batch = images[:main_b].to(dev)
    x = normalized(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    quant.calibrate(model, [x])
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    predictor = make_predictor(model)
    launches = {}
    for bs in E2E_BATCHES:
        frames = images[:bs].to(dev)
        predictor(frames)  # warm-up
        torch.cuda.synchronize()
        set_launches(kernels)
        dets = predictor(frames)
        torch.cuda.synchronize()
        launches[f"int8_b{bs}"] = read_launches(kernels, HIER_LAUNCHES, f"int8 batch {bs}")
        check_detections(*dets, bs, len(classes), NMSConfig().valid_thresh)
        del frames
    os.environ["VIDDET_CONV_BACKEND"] = "pallas"
    try:
        set_launches(kernels)
        pallas = predictor(batch)
        torch.cuda.synchronize()
        launches["int8_pallas"] = read_launches(kernels, HIER_LAUNCHES,
                                                "int8 under VIDDET_CONV_BACKEND=pallas")
    finally:
        del os.environ["VIDDET_CONV_BACKEND"]
    acc = int8_accumulators(model, x[:8], "int8 YOLOv3")
    with torch.inference_mode():
        out = model(x)
        auto = multiclass_nms_late_decode_cells(out["raws_cells"], out["meta"])
        check(all(equal(a, b) for a, b in zip(
            auto, multiclass_nms_late_decode_cells(out["raws_cells"], out["meta"],
                                                   backend="plain"))),
              "int8 heads: kernel tail equal to plain tail")
        dets = predictor(batch)
        check(all(equal(a, b) for a, b in zip(auto, dets)), "int8 predictor = head + tail")
        check(all(equal(a, b) for a, b in zip(pallas, dets)), "int8 under pallas unchanged")
        head_ms = median_ms(lambda: model(x), reps=10)
        q_flat = flatten_outputs(out)
        f_flat = flatten_outputs(bf16_model(x))
        corr = {key: float(np.corrcoef(q_flat[key].double().flatten().cpu().numpy(),
                                       f_flat[key].double().flatten().cpu().numpy())[0, 1])
                for key in ("raw_obj", "cls_max")}
        matched = match_share(bf16_predictor(batch), dets)
    events = profile_kernels(lambda: predictor(batch), 1, path_kernel_names(HIER_LAUNCHES))
    int8_gemm = [k[:100] for k in events if "gemm" in k and ("s8" in k or "i8" in k)]
    float64_conv = [k[:100] for k in events if "dgemm" in k or ("conv" in k and "double" in k)]
    check(bool(int8_gemm), f"an int8 GEMM on the int8 path's profile: {list(events)[:40]}")
    check(not float64_conv, f"no float64 convolution on the int8 path: {float64_conv}")
    breakdown = grouped(events)
    stage_ms = int8_stage_ms(model, x)
    step_ms = median_ms(lambda: predictor(batch), reps=10)
    breakdown.update(step_ms=step_ms, idle_share=1.0 - breakdown["device_ms"] / step_ms)
    timings = {}
    for bs in E2E_BATCHES:
        timings[str(bs)] = {"int8": end_to_end(dev, predictor, images, bs, 10 if bs == main_b
                                               else 5),
                            "bf16": end_to_end(dev, bf16_predictor, images, bs, 10 if bs == main_b
                                               else 5)}
    del out, q_flat, f_flat, x, batch, model, predictor
    torch.cuda.empty_cache()

    # SSD-512's ResNet cells: a 7x7 stride-2 stem, relu and none, 1x1 stride-2 projections
    ssd, ssd_classes = get_model(SSD_MODEL, policy=INT8_POLICY)
    load_flat(ssd, init_flat(SSD_MODEL, seed=0))
    rng = np.random.default_rng(4)
    frames = torch.from_numpy(rng.integers(0, 256, (SSD_B, SSD_SIZE, SSD_SIZE, 3),
                                           dtype=np.uint8)).to(dev)
    sx = normalized(frames)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    quant.calibrate(ssd, [sx])
    torch.cuda.synchronize()
    ssd_calib_s = time.perf_counter() - t0
    ssd_predictor = make_predictor(ssd)
    ssd_predictor(frames)
    torch.cuda.synchronize()
    set_launches(kernels)
    ssd_dets = ssd_predictor(frames)
    torch.cuda.synchronize()
    launches["int8_ssd"] = read_launches(kernels, SSD_LAUNCHES, "int8 SSD")
    check_detections(*ssd_dets, SSD_B, len(ssd_classes), SSDNMSConfig().valid_thresh)
    ssd_acc = int8_accumulators(ssd, sx[:8], "int8 SSD")
    with torch.inference_mode():
        sout = ssd(sx)
        check(all(equal(a, b) for a, b in zip(ssd_postprocess(sout, SSDNMSConfig()),
                                              ssd_postprocess(sout, SSDNMSConfig(
                                                  backend="plain")))),
              "int8 SSD heads: kernel tail equal to plain tail")
        check(all(equal(a, b) for a, b in zip(ssd_postprocess(sout, SSDNMSConfig()), ssd_dets)),
              "int8 SSD predictor = head + tail")
    ssd_ms = median_ms(lambda: ssd_predictor(frames), reps=5)
    del ssd, ssd_predictor, sout, sx, frames
    torch.cuda.empty_cache()
    emit({"phase": "int8", "model": MODEL, "size": IMAGE_SIZE, "policy": "int8 (bf16 compute)",
          "calibration_s": calib_s, "launches": launches, "k8_launches_under_pallas": 0,
          "accumulators": acc, "tail_equal_plain": True, "head_ms": head_ms,
          "int8_gemm_kernels": sorted(set(int8_gemm)), "float64_conv_kernels": float64_conv,
          "stage_ms": stage_ms, "device_breakdown": breakdown,
          "end_to_end": timings, "corr_with_bf16": corr, "bf16_detections_matched": matched,
          "ssd": {"model": SSD_MODEL, "size": SSD_SIZE, "batch": SSD_B,
                  "calibration_s": ssd_calib_s, "accumulators": ssd_acc,
                  "tail_equal_plain": True, "ms_per_batch": ssd_ms,
                  "frames_per_s": SSD_B / ssd_ms * 1e3}})
    return launches


# ---------------------------------------------------------------------------
# Deployment export (infer/export.py)
# ---------------------------------------------------------------------------

# The plain artifact in a process without the port: torch alone loads and runs it.
EXPORT_CHILD = """
import sys, numpy as np, torch
m = torch.export.load(sys.argv[1]).module()
x = torch.from_numpy(np.load(sys.argv[2])).cuda()
with torch.no_grad():
    out = m(x)
assert not [k for k in sys.modules if k.startswith("viddet")], "the port was imported"
np.savez(sys.argv[3], *[t.cpu().numpy() for t in out])
"""


def export_run(dev, kernels, model, spec, batches, want_launches, tmp: str, name: str) -> dict:
    """Export ``model`` for ``spec``, save, load, and hold the loaded
    artifact's detections to the direct predictor's at each batch size
    (ids, scores and boxes bit for bit), and its kernel launches to
    ``want_launches`` a batch."""
    import torch

    from viddet_tpu_torch.infer.export import (
        build_infer_fn,
        export_predictor,
        kernel_ops,
        load_artifact,
        save_artifact,
    )

    t0 = time.perf_counter()
    program = export_predictor(model, spec)
    trace_s = time.perf_counter() - t0
    path = os.path.join(tmp, f"{name}.pt2")
    save_artifact(program, path, {"model": name})
    t0 = time.perf_counter()
    art = load_artifact(path)
    load_s = time.perf_counter() - t0
    direct = build_infer_fn(model, spec)
    size = spec.image_size
    rng = np.random.default_rng(17)
    k = getattr(model, "k", None)
    out = {"trace_s": trace_s, "load_s": load_s, "bytes": os.path.getsize(path),
           "kernel_ops": sorted(set(kernel_ops(program))), "batches": {}}
    for bs in batches:
        shape = (bs, size, size, 3) if k is None else (bs, k, size, size, 3)
        frames = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)
        with torch.inference_mode():
            want = direct(frames)
            art(frames)  # warm-up
            torch.cuda.synchronize()
            set_launches(kernels)
            got = art(frames)
            torch.cuda.synchronize()
            got_launches = read_launches(kernels, want_launches, f"{name} artifact batch {bs}")
            check(all(equal(a, b) for a, b in zip(got, want)),
                  f"{name} artifact at batch {bs} equal to the direct predictor")
            art_ms = median_ms(lambda: art(frames), reps=5)
            direct_ms = median_ms(lambda: direct(frames), reps=5)
        out["batches"][str(bs)] = {"equal": True, "launches": got_launches,
                                   "kept": int((got[0] >= 0).sum()),
                                   "artifact_frames_per_s": bs / art_ms * 1e3,
                                   "direct_frames_per_s": bs / direct_ms * 1e3}
    out["path"] = path
    return out


def export_phase(dev, kernels, yolo_model) -> dict:
    """YOLOv3-416 exported from the card with a dynamic batch by the plain
    and the cuda route; SSD-512 (batch 32) and Faster R-CNN (512 px, batch
    8) by the cuda route; the plain artifact also in a process without the
    port."""
    import dataclasses
    import tempfile

    import torch

    from viddet_tpu_torch.infer.export import ExportSpec
    from viddet_tpu_torch.models.zoo import get_model
    from viddet_tpu_torch.weights import init_flat, load_flat

    main_b = E2E_BATCHES[0]
    rows, launches = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for route, want in (("plain", {}), ("cuda", HIER_LAUNCHES)):
            spec = ExportSpec(image_size=IMAGE_SIZE, platforms=("cuda",), nms_backend=route)
            rows[f"yolo_{route}"] = export_run(dev, kernels, yolo_model, spec, (main_b, 8), want,
                                               tmp, f"yolo_{route}")
            launches[f"export_yolo_{route}"] = rows[f"yolo_{route}"]["batches"][str(main_b)][
                "launches"]
        # under VIDDET_CONV_BACKEND=pallas the cuda route carries K8 too
        os.environ["VIDDET_CONV_BACKEND"] = "pallas"
        try:
            spec = ExportSpec(image_size=IMAGE_SIZE, platforms=("cuda",), nms_backend="cuda")
            rows["yolo_cuda_pallas"] = export_run(dev, kernels, yolo_model, spec, (main_b,),
                                                  CONV_LAUNCHES, tmp, "yolo_cuda_pallas")
        finally:
            del os.environ["VIDDET_CONV_BACKEND"]
        launches["export_yolo_cuda_pallas"] = rows["yolo_cuda_pallas"]["batches"][str(main_b)][
            "launches"]
        # the plain artifact in a child process that imports no viddet_tpu_torch
        rng = np.random.default_rng(18)
        frames = rng.integers(0, 256, (8, IMAGE_SIZE, IMAGE_SIZE, 3), dtype=np.uint8)
        np.save(os.path.join(tmp, "frames.npy"), frames)
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-c", EXPORT_CHILD, rows["yolo_plain"]["path"],
                        os.path.join(tmp, "frames.npy"), os.path.join(tmp, "child.npz")],
                       check=True, timeout=600, cwd=tmp,
                       env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
        child_s = time.perf_counter() - t0
        from viddet_tpu_torch.infer.export import load_artifact

        with torch.inference_mode():
            want = load_artifact(rows["yolo_plain"]["path"])(torch.from_numpy(frames).to(dev))
        with np.load(os.path.join(tmp, "child.npz")) as child:
            got = [child[f"arr_{i}"] for i in range(3)]
        check(all(np.array_equal(g, w.cpu().numpy()) for g, w in zip(got, want)),
              "the plain artifact in a process without the port equals it in this one")
        rows["yolo_plain"]["child_process"] = {"equal": True, "seconds": child_s}
        for family, name, size, batch, want in (
                ("ssd", SSD_MODEL, SSD_SIZE, SSD_B, SSD_LAUNCHES),
                ("frcnn", FRCNN_MODEL, FRCNN_SIZE, FRCNN_B, FRCNN_LAUNCHES)):
            model, _ = get_model(name)
            load_flat(model, init_flat(name, seed=0))
            spec = ExportSpec(image_size=size, platforms=("cuda",), nms_backend="cuda")
            rows[family] = export_run(dev, kernels, model, spec, (batch,), want, tmp, family)
            launches[f"export_{family}"] = rows[family]["batches"][str(batch)]["launches"]
            del model
            torch.cuda.empty_cache()
        for row in rows.values():
            row.pop("path")
    emit({"phase": "export", "rows": rows})
    return launches

# ---------------------------------------------------------------------------
# Phase 7: evaluate
# ---------------------------------------------------------------------------


def same_values(a, b) -> bool:
    """Metric tables equal name for name and float for float, NaN equal to
    NaN (a class with no ground truth has a NaN AP)."""
    return a[0] == b[0] and len(a[1]) == len(b[1]) and all(
        x == y or (x != x and y != y) for x, y in zip(a[1], b[1]))


def evaluate_phase(dev, kernels, model) -> dict:
    """``cli.evaluate.evaluate`` on the main path's model: the YOLOv3 tail's
    kernels launched once a batch (K2 twice), every saved detection equal
    to the direct ``make_predictor`` call on the same loader batch rescaled
    to the original image, the metric reproduced from the saved file by
    ``rescore_from_detections``, and on each loader batch the kernel tail
    equal to the plain tail on the same head outputs; images/s with the
    wall-time split, the predictor's own frames/s on the same numpy batches
    (through ``to_device_batch``, as ``evaluate`` calls it, and from
    batches already pinned), the pin-and-copy alone and peak memory.  Frames
    cross as uint8 (``--device-normalize``); a second run normalizes on the
    host, the CLI's default."""
    import argparse
    import logging
    import tempfile

    import torch

    from viddet_tpu_torch.cli.common import make_predictor
    from viddet_tpu_torch.cli.evaluate import detection_line, evaluate, rescore_from_detections
    from viddet_tpu_torch.data.loader import DetectionLoader
    from viddet_tpu_torch.data.names import COCO_CLASSES
    from viddet_tpu_torch.data.synthetic import SyntheticDetection
    from viddet_tpu_torch.data.transforms import ValTransform, invert_affine_to_boxes
    from viddet_tpu_torch.eval.voc_map import VOC07MApMetric
    from viddet_tpu_torch.infer.service import to_device_batch
    from viddet_tpu_torch.ops.nms import multiclass_nms_late_decode_cells

    dataset = SyntheticDetection(num_images=EVAL_IMAGES, size=EVAL_IMAGE_SIZE,
                                 num_classes=EVAL_CLASSES, seed=EVAL_SEED)
    batches = EVAL_IMAGES // EVAL_B
    want = {name: n * batches for name, n in HIER_LAUNCHES.items()}
    logger = logging.getLogger("chip_smoke.evaluate")
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "detections.jsonl")
        for device_normalize in (True, False):
            args = argparse.Namespace(
                data_shape=IMAGE_SIZE, batch_size=EVAL_B, num_workers=EVAL_WORKERS,
                letterbox=False, max_images=0, device_normalize=device_normalize, temporal_k=1,
                save_detections=path if device_normalize else "")
            metric = VOC07MApMetric(iou_thresh=0.5, class_names=COCO_CLASSES)
            stats = {}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            set_launches(kernels)
            values = evaluate(model, dataset, metric, args, logger, stats)
            torch.cuda.synchronize()
            launches = read_launches(kernels, want, "evaluate")
            stats.update(images_per_s=stats["images"] / stats["seconds"],
                         peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
                         launches=launches)
            runs["device_normalize" if device_normalize else "host_normalize"] = stats
            if device_normalize:
                check(stats["images"] == EVAL_IMAGES, "evaluate saw every image")
                with open(path) as f:
                    saved = f.readlines()
                rescored = rescore_from_detections(
                    dataset, VOC07MApMetric(iou_thresh=0.5, class_names=COCO_CLASSES), path,
                    logger)
                check(same_values(rescored, values), "rescoring the saved file reproduces the metric")
                metric_values = values
            else:
                stats["mAP"] = values[1][-1]

    # The direct call: the same loader batches through a predictor of its
    # own, rescaled as evaluate does, line for line equal to the file; on
    # each batch the head's outputs through the kernel tail and the plain tail.
    predictor = make_predictor(model)
    loader = DetectionLoader(dataset, ValTransform((IMAGE_SIZE, IMAGE_SIZE), normalize=False),
                             batch_size=EVAL_B, train=False, num_workers=EVAL_WORKERS)
    direct, frames = [], []
    for images, _, _, _, affines, idxs in loader:
        frames.append(images)
        batch = to_device_batch(images, EVAL_B, dev)
        det = predictor(batch)
        with torch.inference_mode():
            out = model(normalized(batch))
            tails = [multiclass_nms_late_decode_cells(out["raws_cells"], out["meta"],
                                                      backend=backend)
                     for backend in ("auto", "plain")]
        check(all(equal(a, b) for a, b in zip(*tails)),
              f"kernel tail equal to plain tail on evaluate batch {len(frames) - 1}")
        check(all(equal(a, b) for a, b in zip(tails[0], det)),
              f"predictor equal to head + kernel tail on evaluate batch {len(frames) - 1}")
        ids, scores, boxes = (t.cpu().numpy() for t in det)
        direct += [detection_line(idx, ids[i], scores[i], invert_affine_to_boxes(boxes[i], affine))
                   for i, (idx, affine) in enumerate(zip(idxs, affines))]
    check(len(direct) == len(saved) == EVAL_IMAGES, "one saved line per image")
    differ = [i for i, (a, b) in enumerate(zip(saved, direct)) if a != b]
    check(not differ, f"saved detections equal the direct predictor call (lines {differ[:8]})")
    kept = sum(len(json.loads(line)["ids"]) for line in saved)

    # Host-clock medians over the phase's batches: the step as evaluate takes
    # it (numpy batch -> pinned copy -> detections on the host), the pin and
    # copy alone, and the step from batches pinned beforehand.
    def copy(images):
        to_device_batch(images, EVAL_B, dev)
        torch.cuda.synchronize()

    def step(images):
        return [t.cpu() for t in predictor(to_device_batch(images, EVAL_B, dev))]

    def step_pinned(host):
        return [t.cpu() for t in predictor(host.to(dev, non_blocking=True))]

    pinned = [torch.from_numpy(images).pin_memory() for images in frames]

    def median_wall_ms(fn, inputs):
        for x in inputs[:2]:
            fn(x)
        walls = []
        for x in inputs:
            t = time.perf_counter()
            fn(x)
            walls.append((time.perf_counter() - t) * 1e3)
        return statistics.median(walls)

    predictor_ms = median_wall_ms(step, frames)
    copy_ms = median_wall_ms(copy, frames)
    pinned_ms = median_wall_ms(step_pinned, pinned)
    result = {"phase": "evaluate", "model": MODEL, "size": IMAGE_SIZE, "dtype": "bfloat16",
              "images": EVAL_IMAGES, "image_size": EVAL_IMAGE_SIZE, "batch": EVAL_B,
              "workers": EVAL_WORKERS, "metric": "VOC07MApMetric", "mAP": metric_values[1][-1],
              "kept_detections": kept, "saved_equal_direct": True, "rescore_equal": True,
              "tail_equal_plain_each_batch": True,
              "runs": runs, "predictor_ms_per_batch": predictor_ms,
              "predictor_frames_per_s": EVAL_B / predictor_ms * 1e3,
              "pin_copy_ms_per_batch": copy_ms, "predictor_pinned_ms_per_batch": pinned_ms,
              "predictor_pinned_frames_per_s": EVAL_B / pinned_ms * 1e3}
    emit(result)
    return runs["device_normalize"]["launches"]


# ---------------------------------------------------------------------------
# Phase 5: the conv-kernel configuration
# ---------------------------------------------------------------------------


def conv_path_phase(dev, kernels, model, predictor, images, head_out) -> dict:
    """``VIDDET_CONV_BACKEND=pallas`` through ``set_conv_backend``: the same
    model and frames at batch 32, its launches (K8 three times), its
    detections, its head outputs against the default path's, frames/s."""
    import torch

    from viddet_tpu_torch.core.platform import set_conv_backend
    from viddet_tpu_torch.models.yolo3 import NMSConfig

    bs = E2E_BATCHES[0]
    batch = images[:bs].to(dev)
    set_conv_backend("pallas")
    try:
        predictor(batch)
        torch.cuda.synchronize()
        set_launches(kernels)
        ids, scores, boxes = predictor(batch)
        torch.cuda.synchronize()
        launches = read_launches(kernels, CONV_LAUNCHES, "conv configuration")
        kept = check_detections(ids, scores, boxes, bs, C, NMSConfig().valid_thresh)
        with torch.inference_mode():
            out = model(normalized(batch))
        heads = []
        for got, want in zip(out["raws_cells"], head_out["raws_cells"]):
            g, w = got.float(), want.float()
            heads.append(dict(rel_l2=float(((g - w).norm() / w.norm()).item()),
                              max_abs_diff=float((g - w).abs().max().item()),
                              max_abs=float(w.abs().max().item()),
                              share_differ=float((g != w).float().mean().item())))
        check(all(h["rel_l2"] <= CONV_HEAD_REL_L2 for h in heads),
              f"K8 heads within {CONV_HEAD_REL_L2} relative L2 of the default path: {heads}")
        step_ms = median_ms(lambda: predictor(batch), reps=10)
        timing = end_to_end(dev, predictor, images, bs, 10)
    finally:
        set_conv_backend("auto")
    # the default path again, right after, for a comparison within one run
    default_step_ms = median_ms(lambda: predictor(batch), reps=10)
    default_timing = end_to_end(dev, predictor, images, bs, 10)
    result = {"phase": "conv_configuration", "conv_backend": "pallas", "batch": bs,
              "frames_per_s": timing["frames_per_s"],
              "default_frames_per_s": default_timing["frames_per_s"],
              "launches": launches, "kept_detections": kept, "heads_vs_default": heads,
              "head_rel_l2_limit": CONV_HEAD_REL_L2, "step_ms": step_ms, "end_to_end": timing,
              "default_step_ms_after": default_step_ms, "default_end_to_end_after": default_timing}
    emit(result)
    return launches


# ---------------------------------------------------------------------------
# Phases 8 and 9: temporal YOLOv3 and SSD
# ---------------------------------------------------------------------------


def hier_tail_rows(cells, meta, num_classes: int, what: str, timed: bool) -> dict:
    """The hierarchical tail (NMSConfig() defaults) taken step by step on a
    path's own head outputs: each kernel's wrapper against its plain
    version on the same inputs, bit for bit, and the last step's result
    equal to the whole tail's.  With ``timed``, each kernel's row at these
    shapes: its times, its plain version's, the library call's where there
    is one, and its bound."""
    import torch

    from viddet_tpu_torch.ops import nms_cuda, nms_gather_cuda, topk_cuda
    from viddet_tpu_torch.ops.nms import (
        _class_offset, _pair_top_k_det, multiclass_nms_late_decode_cells,
    )

    b, c, iou, valid_thresh = cells[0].shape[0], num_classes, 0.45, 0.01
    pred = 5 + c

    def held(name, got, want):
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        check(all(equal(x, y) for x, y in zip(got, want)),
              f"{what}: {name} on the path's inputs equal to plain")

    stage1 = nms_gather_cuda.anchor_scores(cells, NA)
    held("K1", stage1, nms_gather_cuda.anchor_scores_plain(cells, NA))
    n = stage1.shape[1]
    a_hier = topk_cuda.topk_indices(stage1, K)
    held("K2 stage 1", a_hier, topk_cuda.topk_indices_plain(stage1, K))
    outs = nms_gather_cuda.gather_decode_top_m(cells, a_hier, meta, TOP_M, HOT_J)
    held("K3-m9", outs,
         nms_gather_cuda.gather_decode_pairs_plain(cells, a_hier, meta, TOP_M, HOT_J))
    boxes_k, v_m, i_m, hot_flat, hot_idx = outs
    merged = torch.cat([v_m[..., : TOP_M - 1].reshape(b, -1), hot_flat.reshape(b, -1)], 1)
    held("K2 stage 2", topk_cuda.topk_indices(merged, TOPK),
         topk_cuda.topk_indices_plain(merged, TOPK))
    top, q = _pair_top_k_det(merged, TOPK)
    k4 = (i_m, hot_idx, q, boxes_k, c)
    cls_idx, cand = nms_gather_cuda.finalize_candidates(*k4)
    held("K4", (cls_idx, cand), nms_gather_cuda.finalize_candidates_plain(*k4))
    offset, valid = _class_offset(cand, cls_idx), top > valid_thresh
    keep = nms_cuda.nms_keep_mask(offset, valid, iou)
    held("K5", keep, nms_cuda.nms_keep_mask_plain(offset, valid, iou))
    k6 = (keep, top, cls_idx, cand, POST)
    dets = nms_cuda.compact_and_pad(*k6)
    held("K6", dets, nms_cuda.compact_and_pad_plain(*k6))
    check(all(equal(x, y) for x, y in
              zip(dets, multiclass_nms_late_decode_cells(cells, meta, ranking="hier"))),
          f"{what}: the kernels step by step equal the whole tail")
    if not timed:
        return {}

    k2_rows = {}  # the path's two calls of K2
    for name, x in (("stage1", stage1), ("stage2_hier", merged)):
        k2_rows[name] = dict(
            shape=list(x.shape), max_abs_err=0.0,
            bound=bound_ms(x.numel() * 4 + b * K * 8, x.numel() * 34),
            **timings(lambda x=x: topk_cuda.topk_indices(x, K),
                      lambda x=x: topk_cuda.topk_indices_plain(x, K),
                      lambda x=x: torch.topk(x, K, dim=1, sorted=False),
                      names=KERNEL_NAMES["topk_indices"]))
    pairs = TOPK * (TOPK - 1) // 2
    return {
        "anchor_scores": dict(
            batch=b, row_width=NA * pred, max_abs_err=0.0,
            bound=bound_ms(sum(x.numel() * 2 for x in cells) + b * n * 4, b * n * (c + 8)),
            **timings(lambda: nms_gather_cuda.anchor_scores(cells, NA),
                      lambda: nms_gather_cuda.anchor_scores_plain(cells, NA),
                      lambda: [torch.sigmoid(x.view(b, -1, NA, pred)[..., 5:].amax(-1))
                               for x in cells], names=KERNEL_NAMES["anchor_scores"])),
        "topk_indices": dict(
            per_call=k2_rows, max_abs_err=0.0,
            bound=bound_ms(sum(x.numel() * 4 + b * K * 8 for x in (stage1, merged)),
                           sum(x.numel() * 34 for x in (stage1, merged))),
            **{key: sum(r[key] for r in k2_rows.values())
               for key in ("ms", "plain_ms", "library_ms")}),
        "gather_decode_top_m": dict(
            batch=b, classes=c, max_abs_err=0.0,
            bound=bound_ms(b * K * (pred * 2 + 8) + b * K * (16 + TOP_M * 12)
                           + b * HOT_J * (c * 4 + 8),
                           b * K * (c * 4 + 30 + TOP_M * c * 2) + b * K * K * 3),
            **timings(lambda: nms_gather_cuda.gather_decode_top_m(cells, a_hier, meta, TOP_M,
                                                                  HOT_J),
                      lambda: nms_gather_cuda.gather_decode_pairs_plain(cells, a_hier, meta,
                                                                        TOP_M, HOT_J),
                      names=KERNEL_NAMES["gather_decode_top_m"])),
        "finalize_candidates": dict(
            batch=b, max_abs_err=0.0,
            bound=bound_ms(b * TOPK * (8 + 8 + 16 + 4 + 16), b * TOPK * 10),
            **timings(lambda: nms_gather_cuda.finalize_candidates(*k4),
                      lambda: nms_gather_cuda.finalize_candidates_plain(*k4),
                      names=KERNEL_NAMES["finalize_candidates"])),
        "nms_keep_mask": nms_row(offset, valid, iou),
        "compact_and_pad": compact_row(k6),
    }


def nms_row(offset, valid, iou: float) -> dict:
    """K5 on a path's class-offset candidates: times and bound."""
    from viddet_tpu_torch.ops import nms_cuda

    b, k = valid.shape
    return dict(batch=b, k=k, valid=int(valid.sum().item()), max_abs_err=0.0,
                bound=bound_ms(b * k * (16 + 1 + 4), b * (k * (k - 1) // 2) * 24),
                **timings(lambda: nms_cuda.nms_keep_mask(offset, valid, iou),
                          lambda: nms_cuda.nms_keep_mask_plain(offset, valid, iou),
                          plain_reps=3, names=KERNEL_NAMES["nms_keep_mask"]))


def compact_row(args) -> dict:
    """K6 on a path's keep mask and candidates: times and bound."""
    from viddet_tpu_torch.ops import nms_cuda

    keep = args[0]
    b, k = keep.shape
    return dict(batch=b, k=k, kept=int(keep.sum().item()), max_abs_err=0.0,
                bound=bound_ms(b * k * (4 * 3 + 16) + b * POST * 24, b * k * 4),
                **timings(lambda: nms_cuda.compact_and_pad(*args),
                          lambda: nms_cuda.compact_and_pad_plain(*args),
                          names=KERNEL_NAMES["compact_and_pad"]))


def temporal_phase(dev, kernels) -> dict:
    """yolo3_darknet53_k3_vid on uint8 clips under each aggregation: the
    launches of one predictor call (the hierarchical tail), the kernel tail
    equal to the plain tail on the same head outputs, each of K1-K6 equal
    to its plain version on the path's own intermediates, well-formed
    detections; under max, each kernel's row at the path's shapes (C = 30,
    batch 8), time per batch and clips/s."""
    import torch

    from viddet_tpu_torch.cli.common import make_predictor
    from viddet_tpu_torch.models.yolo3 import NMSConfig
    from viddet_tpu_torch.models.zoo import get_model
    from viddet_tpu_torch.ops.nms import multiclass_nms_late_decode_cells
    from viddet_tpu_torch.weights import init_flat, load_flat

    rng = np.random.default_rng(3)
    shape = (TEMPORAL_B, TEMPORAL_K, IMAGE_SIZE, IMAGE_SIZE, 3)
    clips = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).pin_memory()
    batch = clips.to(dev)
    rows, launches = {}, {}
    for agg in TEMPORAL_AGGREGATIONS:
        t0 = time.perf_counter()
        model, classes = get_model(TEMPORAL_MODEL, aggregation=agg)
        load_flat(model, init_flat(TEMPORAL_MODEL, seed=0, aggregation=agg))
        setup_s = time.perf_counter() - t0
        predictor = make_predictor(model)
        predictor(batch)  # warm-up
        torch.cuda.synchronize()
        set_launches(kernels)
        ids, scores, boxes = predictor(batch)
        torch.cuda.synchronize()
        launches[agg] = read_launches(kernels, HIER_LAUNCHES, f"temporal path ({agg})")
        kept = check_detections(ids, scores, boxes, TEMPORAL_B, len(classes),
                                NMSConfig().valid_thresh)
        with torch.inference_mode():
            out = model(normalized(batch))

            def tail(backend):
                return multiclass_nms_late_decode_cells(out["raws_cells"], out["meta"],
                                                        backend=backend)

            got = tail("auto")
            check(all(equal(a, b) for a, b in zip(got, tail("plain"))),
                  f"temporal ({agg}) kernel tail equal to plain tail")
            check(all(equal(a, b) for a, b in zip(got, (ids, scores, boxes))),
                  f"temporal ({agg}) predictor equal to head + kernel tail")
            check([tuple(x.shape) for x in out["raws_cells"]]
                  == [(TEMPORAL_B, c, NA * (5 + len(classes))) for c in CELLS],
                  f"temporal ({agg}) head shapes")
            kernel_rows = hier_tail_rows(out["raws_cells"], out["meta"], len(classes),
                                         f"temporal ({agg})",
                                         timed=agg == TEMPORAL_AGGREGATIONS[0])
        row = dict(setup_s=setup_s, launches=launches[agg], kept_detections=kept,
                   tail_equal_plain=True, kernels_equal_plain_on_path=True)
        if kernel_rows:
            row["kernels"] = kernel_rows
        if agg == TEMPORAL_AGGREGATIONS[0]:
            with torch.inference_mode():
                x = normalized(batch)
                row["head_ms"] = median_ms(lambda: model(x), reps=10)
                row["tail_ms"] = median_ms(lambda: tail("auto"), reps=10)
                row["tail_device_ms"] = device_ms(lambda: tail("auto"),
                                                  names=path_kernel_names(HIER_LAUNCHES))
            row["step_ms"] = median_ms(lambda: predictor(batch), reps=10)
            timing = end_to_end(dev, predictor, clips, TEMPORAL_B, 10)
            row["end_to_end"] = dict(timing, clips_per_s=timing.pop("frames_per_s"))
        rows[agg] = row
        del model, predictor, out, got
    emit({"phase": "temporal", "model": TEMPORAL_MODEL, "size": IMAGE_SIZE,
          "dtype": "bfloat16", "batch_clips": TEMPORAL_B, "k": TEMPORAL_K,
          "frames_through_backbone": TEMPORAL_B * TEMPORAL_K, "aggregations": rows})
    return launches[TEMPORAL_AGGREGATIONS[0]], rows[TEMPORAL_AGGREGATIONS[0]]["kernels"]


def ssd_phase(dev, kernels) -> dict:
    """SSD-512 ResNet-50 / COCO at 512 px, batch 32, bf16, seeded weights,
    through ``make_predictor``: its launches (K2 twice, K5 and K6 once), the
    kernel tail equal to the plain tail on the same head outputs, K2 at the
    path's two shapes (stage 1 over the N anchors, stage 2 over the k*C
    pairs), K5 on the path's candidates and K6 on its keep mask against
    their plain versions (K2 also against torch.topk), the steps' result
    equal to the predictor's, time per batch, frames/s, peak memory,
    device breakdown."""
    import torch

    from viddet_tpu_torch.cli.common import make_predictor
    from viddet_tpu_torch.models.ssd import SSDNMSConfig, ssd_postprocess
    from viddet_tpu_torch.models.zoo import get_model
    from viddet_tpu_torch.ops import nms_cuda, topk_cuda
    from viddet_tpu_torch.ops.nms import _class_offset, _pair_top_k_det
    from viddet_tpu_torch.weights import init_flat, load_flat

    t0 = time.perf_counter()
    model, classes = get_model(SSD_MODEL)
    load_flat(model, init_flat(SSD_MODEL, seed=0))
    setup_s = time.perf_counter() - t0
    cfg = SSDNMSConfig()
    predictor = make_predictor(model)
    rng = np.random.default_rng(4)
    images = torch.from_numpy(rng.integers(0, 256, (SSD_B, SSD_SIZE, SSD_SIZE, 3),
                                           dtype=np.uint8)).pin_memory()
    batch = images.to(dev)
    predictor(batch)  # warm-up: cuDNN heuristics, caching allocator
    torch.cuda.synchronize()

    set_launches(kernels)
    ids, scores, boxes = predictor(batch)
    torch.cuda.synchronize()
    launches = read_launches(kernels, SSD_LAUNCHES, "SSD path")
    kept = check_detections(ids, scores, boxes, SSD_B, len(classes), cfg.valid_thresh)

    with torch.inference_mode():
        out = model(normalized(batch))
        check(out["cls_logits"].shape == (SSD_B, SSD_N, C + 1) and out["anchors"].shape
              == (SSD_N, 4), f"SSD head shapes {tuple(out['cls_logits'].shape)}")

        def tail(backend, valid=cfg.valid_thresh):
            return ssd_postprocess(out, SSDNMSConfig(valid_thresh=valid, backend=backend))

        check(all(equal(a, b) for a, b in zip(tail("auto"), (ids, scores, boxes))),
              "SSD predictor equal to head + kernel tail")
        tails_equal = {}
        for valid in (cfg.valid_thresh, 0.05):
            got = tail("auto", valid)
            check(all(equal(a, b) for a, b in zip(got, tail("plain", valid))),
                  f"SSD kernel tail equal to plain tail at valid {valid}")
            tails_equal[str(valid)] = dict(
                equal=True, kept=check_detections(*got, SSD_B, len(classes), valid))

        # K2 at the path's two shapes, on the path's own probabilities
        probs = torch.softmax(out["cls_logits"].float(), dim=-1)[..., 1:]
        stage1 = probs.amax(dim=-1).contiguous()
        _, a_idx = _pair_top_k_det(stage1, TOPK)
        pairs = probs.gather(1, a_idx[..., None].expand(-1, -1, C)).reshape(SSD_B, -1)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        k2 = {}
        for name, x in (("stage1", stage1), ("stage2", pairs)):
            got = topk_cuda.topk_indices(x, TOPK)
            check(equal(got, topk_cuda.topk_indices_plain(x, TOPK)),
                  f"K2 SSD {name} equal to plain")
            k2[name] = dict(
                shape=list(x.shape), cluster=topk_cuda.cluster_size(SSD_B, x.shape[1], sms),
                bound=bound_ms(x.numel() * 4 + SSD_B * TOPK * 8, x.numel() * 34),
                **timings(lambda: topk_cuda.topk_indices(x, TOPK),
                          lambda: topk_cuda.topk_indices_plain(x, TOPK),
                          lambda: torch.topk(x, TOPK, dim=1, sorted=False),
                          names=KERNEL_NAMES["topk_indices"]))

        # K5 at K = 400 on the path's class-offset candidates
        top, p_idx = _pair_top_k_det(pairs, TOPK)
        boxes_k = out["boxes"].gather(1, a_idx[..., None].expand(-1, -1, 4))
        cand = boxes_k.gather(1, (p_idx // C)[..., None].expand(-1, -1, 4))
        offset = _class_offset(cand, (p_idx % C).float())
        valid = top > cfg.valid_thresh
        keep = nms_cuda.nms_keep_mask(offset, valid, cfg.iou_thresh)
        check(equal(keep, nms_cuda.nms_keep_mask_plain(offset, valid, cfg.iou_thresh)),
              "K5 on the SSD path's candidates equal to plain")
        k5 = nms_row(offset, valid, cfg.iou_thresh)
        # K6 on the path's keep mask and candidates; its result is the tail's
        k6_args = (keep, top, (p_idx % C).float(), cand, cfg.post_nms)
        dets = nms_cuda.compact_and_pad(*k6_args)
        check(all(equal(a, b) for a, b in zip(dets, nms_cuda.compact_and_pad_plain(*k6_args))),
              "K6 on the SSD path's keep mask and candidates equal to plain")
        check(all(equal(a, b) for a, b in zip(dets, (ids, scores, boxes))),
              "SSD kernels step by step equal the predictor")
        k6 = compact_row(k6_args)

        x = normalized(batch)
        head_ms = median_ms(lambda: model(x), reps=10)
        tail_ms = median_ms(lambda: tail("auto"), reps=10)
        plain_tail_ms = median_ms(lambda: tail("plain"), reps=3)
        tail_device_ms = device_ms(lambda: tail("auto"), names=path_kernel_names(SSD_LAUNCHES))
        del out, probs, pairs, x
    step_ms = median_ms(lambda: predictor(batch), reps=10)  # images already on the card
    breakdown = kernel_breakdown(lambda: predictor(batch), path_kernel_names(SSD_LAUNCHES))
    breakdown["step_ms"] = step_ms
    breakdown["idle_share"] = 1.0 - breakdown["device_ms"] / step_ms
    emit({"phase": "ssd_path", "model": SSD_MODEL, "size": SSD_SIZE, "dtype": "bfloat16",
          "batch": SSD_B, "anchors": SSD_N, "setup_s": setup_s, "launches": launches,
          "kept_detections": kept, "tails_equal_plain": tails_equal, "k2": k2,
          "k5_on_path": k5, "k6_on_path": k6, "head_ms": head_ms, "tail_ms": tail_ms,
          "plain_tail_ms": plain_tail_ms, "tail_device_ms": tail_device_ms,
          "end_to_end": {str(SSD_B): end_to_end(dev, predictor, images, SSD_B, 10)},
          "device_breakdown": breakdown})
    return launches, dict(k2, nms_keep_mask=k5, compact_and_pad=k6)


# ---------------------------------------------------------------------------
# Phase 10: Faster R-CNN
# ---------------------------------------------------------------------------


def rel_l2(got, want) -> float:
    return float(((got.float() - want.float()).norm() / want.float().norm()).item())


def frcnn_path_phase(dev, kernels):
    """Faster R-CNN ResNet-50 FPN / COCO at 512 px, batch 8, bf16, seeded
    weights, through ``make_predictor``."""
    import dataclasses

    import torch

    from viddet_tpu_torch.cli.common import make_predictor
    from viddet_tpu_torch.models.faster_rcnn import FPN_STRIDES, frcnn_postprocess
    from viddet_tpu_torch.models.zoo import get_model
    from viddet_tpu_torch.ops import roi_align_cuda
    from viddet_tpu_torch.ops.roi_align import fpn_roi_level, multilevel_roi_align_packed
    from viddet_tpu_torch.weights import init_flat, load_flat

    t0 = time.perf_counter()
    model, classes = get_model(FRCNN_MODEL)
    load_flat(model, init_flat(FRCNN_MODEL, seed=0))
    setup_s = time.perf_counter() - t0
    predictor = make_predictor(model)
    rng = np.random.default_rng(2)
    images = torch.from_numpy(rng.integers(0, 256, (FRCNN_B, FRCNN_SIZE, FRCNN_SIZE, 3),
                                           dtype=np.uint8)).pin_memory()
    batch = images.to(dev)
    predictor(batch)  # warm-up: cuDNN heuristics, caching allocator
    torch.cuda.synchronize()

    set_launches(kernels)
    ids, scores, boxes = predictor(batch)
    torch.cuda.synchronize()
    launches = read_launches(kernels, FRCNN_LAUNCHES, "Faster R-CNN path")
    kept = check_detections(ids, scores, boxes, FRCNN_B, len(classes), 0.05)
    kept_per_image = (ids >= 0).sum(1).tolist()

    with torch.inference_mode():
        x = normalized(batch)
        out = model(x)

        def tail(backend, valid=0.05):
            return frcnn_postprocess(out["proposals"], out["roi_cls_logits"],
                                     out["roi_box_deltas"], (FRCNN_SIZE, FRCNN_SIZE),
                                     valid_thresh=valid, backend=backend)

        check(all(equal(a, b) for a, b in zip(tail("auto"), (ids, scores, boxes))),
              "predictor equal to head + kernel tail")
        tails_equal = {}
        for valid in (0.05, 0.001):  # 0.001 also, in case 0.05 keeps nothing
            got = tail("auto", valid)
            check(all(equal(a, b) for a, b in zip(got, tail("plain", valid))),
                  f"Faster R-CNN kernel tail equal to plain tail at valid {valid}")
            tails_equal[str(valid)] = dict(
                equal=True, kept=check_detections(*got, FRCNN_B, len(classes), valid))

        # K7 on the path's own pyramid and proposals
        feats = model.backbone(x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last))
        maps = [p.permute(0, 2, 3, 1).contiguous() for p in model.fpn(feats)[:4]]
        props = out["proposals"]
        strides = FPN_STRIDES[:4]
        got = roi_align_cuda.multilevel_roi_align(maps, props, strides)
        want = multilevel_roi_align_packed(maps, props, strides)
        err = float((got - want).abs().max().item())
        check(equal(got, want), f"K7 on the path's proposals equal to plain: {err}")
        traffic = roi_align_traffic(maps, props, strides)
        out_bytes = got.numel() * 4
        k7_path = dict(
            max_abs_err=err, bit_equal=True, **traffic,
            levels=torch.bincount(fpn_roi_level(props).flatten(), minlength=6)[2:].tolist(),
            proposals_valid=int(out["proposal_valid"].sum().item()),
            bound=bound_ms(out_bytes + traffic["cells_batch"] * FPN_C * 2 + props.numel() * 4,
                           out_bytes / 4 * 36),
            **timings(lambda: roi_align_cuda.multilevel_roi_align(maps, props, strides),
                      lambda: multilevel_roi_align_packed(maps, props, strides), plain_reps=5,
                      names=KERNEL_NAMES["multilevel_roi_align"]))

        # the head under the plain ROIAlign against the kernel's
        cfg = model.config
        model.config = dataclasses.replace(cfg, roi_backend="plain")
        try:
            plain_out = model(x)
        finally:
            model.config = cfg
        check(equal(plain_out["proposals"], out["proposals"]), "same proposals under both ROIAligns")
        heads = {k: rel_l2(out[k], plain_out[k]) for k in ("roi_cls_logits", "roi_box_deltas")}
        check(all(v <= FRCNN_HEAD_REL_L2 for v in heads.values()),
              f"head outputs under the kernel ROIAlign within {FRCNN_HEAD_REL_L2} relative L2 "
              f"of the plain one: {heads}")
        head_ms = median_ms(lambda: model(x), reps=10)
        tail_ms = median_ms(lambda: tail("auto"), reps=10)
        plain_tail_ms = median_ms(lambda: tail("plain"), reps=3)
        tail_names = path_kernel_names({n: 1 for n in FRCNN_LAUNCHES
                                        if n != "multilevel_roi_align"})
        tail_device_ms = device_ms(lambda: tail("auto"), names=tail_names)
    step_ms = median_ms(lambda: predictor(batch), reps=10)  # images already on the card
    breakdown = kernel_breakdown(lambda: predictor(batch), path_kernel_names(FRCNN_LAUNCHES))
    breakdown["step_ms"] = step_ms
    breakdown["idle_share"] = 1.0 - breakdown["device_ms"] / step_ms
    emit({"phase": "frcnn_path", "model": FRCNN_MODEL, "size": FRCNN_SIZE, "dtype": "bfloat16",
          "batch": FRCNN_B, "setup_s": setup_s, "launches": launches,
          "kept_detections": kept, "kept_per_image": kept_per_image,
          "tails_equal_plain": tails_equal, "k7_on_path": k7_path,
          "heads_plain_roi_align_rel_l2": heads, "head_rel_l2_limit": FRCNN_HEAD_REL_L2,
          "head_ms": head_ms, "tail_ms": tail_ms, "plain_tail_ms": plain_tail_ms,
          "tail_device_ms": tail_device_ms,
          "end_to_end": {str(FRCNN_B): end_to_end(dev, predictor, images, FRCNN_B, 10)},
          "device_breakdown": breakdown})
    return predictor, launches


# ---------------------------------------------------------------------------
# Phase 6: serving
# ---------------------------------------------------------------------------


def serving_phase(dev, predictor, model: str = MODEL, size: int = IMAGE_SIZE,
                  requests: int = 16):
    """``requests`` frames of four sizes from 4 client threads through a
    ``DetectionService`` of batch 8, each answer equal to the direct
    batched call on the same transformed frames."""
    import torch

    from viddet_tpu_torch.data.transforms import ValTransform, invert_affine_to_boxes
    from viddet_tpu_torch.infer.service import DetectionService

    bs = 8
    rng = np.random.default_rng(1)
    sizes = [(480, 640), (360, 500), (416, 416), (600, 400)]
    frames = [rng.integers(0, 256, sizes[i % 4] + (3,), dtype=np.uint8)
              for i in range(requests)]
    transform = ValTransform((size, size), normalize=False)

    answers = [None] * len(frames)
    errors = []
    t0 = time.perf_counter()
    with DetectionService(predictor, transform, batch_size=bs, flush_ms=5.0) as svc:
        def client(offset):
            try:
                for i in range(offset, len(frames), 4):
                    answers[i] = svc.detect(frames[i], timeout=120)
            except Exception as exc:  # noqa: BLE001 -- reported below
                errors.append(repr(exc))

        threads = [threading.Thread(target=client, args=(o,)) for o in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        check(not any(t.is_alive() for t in threads), "client threads finished")
        stats = svc.stats()
    wall = time.perf_counter() - t0
    check(not errors, f"no request failed: {errors}")

    # The direct batched call: the same transform, batches of the same size.
    prepared = [transform(f) for f in frames]
    for start in range(0, len(frames), bs):
        chunk = prepared[start : start + bs]
        x = torch.from_numpy(np.stack([p[0] for p in chunk])).to(dev)
        ids, scores, boxes = (t.cpu().numpy() for t in predictor(x))
        for j, (_, _, affine) in enumerate(chunk):
            want = (ids[j], scores[j], invert_affine_to_boxes(boxes[j], affine))
            got = answers[start + j]
            check(all(np.array_equal(a, b) for a, b in zip(got, want)),
                  f"request {start + j} equal to the direct batched call")
    emit({"phase": "serving", "model": model, "size": size, "requests": len(frames),
          "threads": 4, "batch_size": bs, "wall_s": wall, "stats": stats,
          "all_equal_direct": True})


# ---------------------------------------------------------------------------
# Phases 8-12: the image codec, evaluate over files, HTTP, streams, detect
# ---------------------------------------------------------------------------


def photo_like(rng, h: int = CODEC_H, w: int = CODEC_W) -> np.ndarray:
    """A seeded RGB image that compresses like a photograph: a random
    colour every 16 pixels, bilinearly blended, with a little noise."""
    grid = rng.uniform(0, 255, (h // 16 + 2, w // 16 + 2, 3)).astype(np.float32)
    gy, gx = np.arange(h, dtype=np.float32) / 16, np.arange(w, dtype=np.float32) / 16
    y0, x0 = gy.astype(int), gx.astype(int)
    fy, fx = (gy - y0)[:, None, None], (gx - x0)[None, :, None]
    rows = grid[:, x0] * (1 - fx) + grid[:, x0 + 1] * fx  # blended along x, grid rows only
    img = rows[y0] * (1 - fy) + rows[y0 + 1] * fy
    img += rng.integers(-4, 5, (h, w, 3), dtype=np.int8)
    return img.clip(0, 255).astype(np.uint8)


def timed(fn) -> float:
    t = time.perf_counter()
    fn()
    return time.perf_counter() - t


def in_threads(fn, items, workers: int):
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(workers) as pool:
        return list(pool.map(fn, items))


def codec_phase() -> dict:
    """64 seeded 640x480 images written by the port's JPEG (q 95) and PNG
    encoders and read back by its decoder: PNGs exactly, each JPEG equal to
    its decode in a second thread; decode rates on one thread and on the
    loader's 4, encode rates on ENCODE_WORKERS (host CPU figures); then the
    still fixtures (``stills_check``)."""
    import tempfile

    from viddet_tpu_torch.data.base import decode_rgb, imread_rgb
    from viddet_tpu_torch.native import build, encode_jpeg, encode_png

    t0 = time.perf_counter()
    build()
    build_s = time.perf_counter() - t0
    images = [photo_like(np.random.default_rng((CODEC_SEED, i))) for i in range(CODEC_IMAGES)]
    out = {"phase": "codec", "images": CODEC_IMAGES, "size": [CODEC_W, CODEC_H],
           "build_s": build_s, "rates": {}}
    with tempfile.TemporaryDirectory() as tmp:
        for kind, encode in (("jpeg", lambda im: encode_jpeg(im, 95)), ("png", encode_png)):
            t = time.perf_counter()
            blobs = in_threads(encode, images, ENCODE_WORKERS)
            encode_s = time.perf_counter() - t
            paths = [os.path.join(tmp, f"{i}.{kind}") for i in range(CODEC_IMAGES)]
            for path, blob in zip(paths, blobs):
                with open(path, "wb") as f:
                    f.write(blob)
            decoded = [imread_rgb(p) for p in paths]
            if kind == "png":
                check(all(np.array_equal(a, b) for a, b in zip(decoded, images)),
                      "PNGs round-trip exactly")
            else:
                again = in_threads(lambda b: decode_rgb(b, "thread"), blobs, 1)
                check(all(np.array_equal(a, b) for a, b in zip(decoded, again)),
                      "each JPEG decodes the same in a second thread")
                mse = max(float(np.mean((a.astype(np.float64) - b) ** 2))
                          for a, b in zip(decoded, images))
                psnr = 10 * np.log10(255.0**2 / mse)
                check(psnr > 30, f"JPEG q95 round trip above 30 dB PSNR ({psnr:.1f})")
                out["jpeg_min_psnr_db"] = psnr
            mb = sum(len(b) for b in blobs) / 1e6
            rates = {"bytes_mb": mb,
                     f"encode_{ENCODE_WORKERS}_threads_images_per_s": CODEC_IMAGES / encode_s}
            for workers in (1, EVAL_WORKERS):
                decode_rgb(blobs[0], "warm")
                t = time.perf_counter()
                in_threads(lambda b: decode_rgb(b, kind), blobs, workers)
                dt = time.perf_counter() - t
                rates[f"decode_{workers}_threads"] = {"mb_per_s": mb / dt,
                                                      "images_per_s": CODEC_IMAGES / dt}
            out["rates"][kind] = rates
    out["stills"] = stills_check()
    out["phase_s"] = time.perf_counter() - t0
    emit(out)
    return out


def still(name: str) -> bytes:
    with open(os.path.join(STILLS_DIR, name), "rb") as f:
        return f.read()


def stills_check() -> dict:
    """Every still fixture decoded by ``decode_rgb`` to the shape and RGB
    digest OpenCV gave it; decode rates of STILL_RATES (lossy and lossless
    WebP, GIF, TIFF, Sun raster, PFM, HDR, CCITT Group 4, JPEG 2000 5/3 and
    9/7) over STILL_COPIES copies on one
    thread and on the loader's 4 (host CPU figures, MB/s of the files'
    bytes)."""
    import hashlib

    from viddet_tpu_torch.data.base import decode_rgb

    with open(STILLS_DIGESTS) as f:
        digests = json.load(f)
    for name, want in sorted(digests.items()):
        rgb = decode_rgb(still(name), name)
        check(list(rgb.shape) == want["shape"]
              and hashlib.sha256(rgb.tobytes()).hexdigest() == want["rgb_sha256"],
              f"{name} decodes to OpenCV's digest")
    out = {"files": len(digests), "all_equal_cv2": True, "rates": {}}
    for kind, name in STILL_RATES.items():
        blobs = [still(name)] * STILL_COPIES
        mb = len(blobs[0]) * STILL_COPIES / 1e6
        rates = {"file": name, "bytes_mb": mb}
        for workers in (1, EVAL_WORKERS):
            decode_rgb(blobs[0], "warm")
            t = time.perf_counter()
            in_threads(lambda b: decode_rgb(b, kind), blobs, workers)
            dt = time.perf_counter() - t
            rates[f"decode_{workers}_threads"] = {"mb_per_s": mb / dt,
                                                  "images_per_s": STILL_COPIES / dt}
        out["rates"][kind] = rates
    return out


def voc_xml(image_id: str, label: np.ndarray, names) -> str:
    objects = "".join(
        f"<object><name>{names[int(c)]}</name><difficult>{int(d)}</difficult><bndbox>"
        f"<xmin>{x1 + 1:.0f}</xmin><ymin>{y1 + 1:.0f}</ymin><xmax>{x2 + 1:.0f}</xmax>"
        f"<ymax>{y2 + 1:.0f}</ymax></bndbox></object>"
        for x1, y1, x2, y2, c, d in label)
    return (f"<annotation><filename>{image_id}.jpg</filename><size><width>{CODEC_W}</width>"
            f"<height>{CODEC_H}</height><depth>3</depth></size>{objects}</annotation>")


def evaluate_files_phase(dev, kernels) -> dict:
    """``cli.evaluate.evaluate`` over 256 JPEGs on disk in the VOC layout
    (written by the port's encoder, boxes from a seeded generator), with
    YOLOv3-416 Darknet-53 over VOC's 20 classes as ``--dataset voc`` builds
    it (bf16, ``init_flat(seed=0)``), batch 32, 4 loader threads: its
    launches, images/s and the wall-time split, and every image's saved
    detections equal to the direct predictor on that image, decoded by
    ``imread_rgb`` apart from the loader."""
    import argparse
    import logging
    import tempfile

    from viddet_tpu_torch.cli.common import make_predictor
    from viddet_tpu_torch.cli.evaluate import detection_line, evaluate
    from viddet_tpu_torch.data.base import imread_rgb
    from viddet_tpu_torch.data.names import VOC_CLASSES
    from viddet_tpu_torch.data.transforms import ValTransform, invert_affine_to_boxes
    from viddet_tpu_torch.data.voc import VOCDetection
    from viddet_tpu_torch.eval.voc_map import VOC07MApMetric
    from viddet_tpu_torch.infer.service import to_device_batch
    from viddet_tpu_torch.models.zoo import get_model
    from viddet_tpu_torch.native import encode_jpeg
    from viddet_tpu_torch.weights import init_flat, load_flat

    t_phase = time.perf_counter()
    model, classes = get_model(VOC_MODEL)
    load_flat(model, init_flat(VOC_MODEL, seed=0))
    rng = np.random.default_rng(EVAL_SEED)
    labels = []
    for _ in range(EVAL_IMAGES):
        n = int(rng.integers(1, 6))
        xy = rng.uniform(0, 1, (n, 2)) * (CODEC_W - 64, CODEC_H - 64)
        wh = rng.uniform(24, 200, (n, 2))
        x2y2 = np.minimum(xy + wh, (CODEC_W - 1, CODEC_H - 1))
        labels.append(np.column_stack([xy, x2y2, rng.integers(0, len(VOC_CLASSES), n),
                                       rng.random(n) < 0.1]))
    batches = -(-EVAL_IMAGES // EVAL_B)
    want = {name: n * batches for name, n in HIER_LAUNCHES.items()}
    with tempfile.TemporaryDirectory() as root:
        year = os.path.join(root, "VOC2007")
        for sub in ("JPEGImages", "Annotations", os.path.join("ImageSets", "Main")):
            os.makedirs(os.path.join(year, sub))
        ids = [f"{i:06d}" for i in range(EVAL_IMAGES)]

        def write(i):
            with open(os.path.join(year, "JPEGImages", f"{ids[i]}.jpg"), "wb") as f:
                f.write(encode_jpeg(photo_like(np.random.default_rng((EVAL_SEED, i))), 95))
            with open(os.path.join(year, "Annotations", f"{ids[i]}.xml"), "w") as f:
                f.write(voc_xml(ids[i], labels[i], VOC_CLASSES))

        t0 = time.perf_counter()
        in_threads(write, range(EVAL_IMAGES), ENCODE_WORKERS)
        with open(os.path.join(year, "ImageSets", "Main", "test.txt"), "w") as f:
            f.write("".join(f"{i}\n" for i in ids))
        write_s = time.perf_counter() - t0
        dataset = VOCDetection(root, splits=(("2007", "test"),))
        path = os.path.join(root, "detections.jsonl")
        args = argparse.Namespace(data_shape=IMAGE_SIZE, batch_size=EVAL_B,
                                  num_workers=EVAL_WORKERS, letterbox=False, max_images=0,
                                  device_normalize=True, temporal_k=1, save_detections=path)
        metric = VOC07MApMetric(iou_thresh=0.5, class_names=VOC_CLASSES)
        stats = {}
        torch_sync()
        set_launches(kernels)
        values = evaluate(model, dataset, metric, args, logging.getLogger("chip_smoke"), stats)
        torch_sync()
        launches = read_launches(kernels, want, "evaluate over files")
        check(stats["images"] == EVAL_IMAGES, "evaluate over files saw every image")
        with open(path) as f:
            saved = {json.loads(line)["index"]: line for line in f}

        # the direct predictor, on each image decoded apart from the loader
        predictor = make_predictor(model)
        transform = ValTransform((IMAGE_SIZE, IMAGE_SIZE), normalize=False)
        differ = []
        for start in range(0, EVAL_IMAGES, EVAL_B):
            idxs = range(start, min(start + EVAL_B, EVAL_IMAGES))
            prepared = in_threads(lambda i: transform(imread_rgb(dataset.image_path(i))), idxs,
                                  EVAL_WORKERS)
            det = predictor(to_device_batch(np.stack([p[0] for p in prepared]), EVAL_B, dev))
            d_ids, d_scores, d_boxes = (t.cpu().numpy() for t in det)
            for j, (i, (_, _, affine)) in enumerate(zip(idxs, prepared)):
                line = detection_line(i, d_ids[j], d_scores[j],
                                      invert_affine_to_boxes(d_boxes[j], affine))
                if saved.get(i) != line:
                    differ.append(i)
        check(len(saved) == EVAL_IMAGES and not differ,
              f"saved detections equal the direct predictor on each decoded file {differ[:8]}")
    out = {"phase": "evaluate_files", "model": VOC_MODEL, "size": IMAGE_SIZE,
           "dtype": "bfloat16", "images": EVAL_IMAGES, "image_size": [CODEC_W, CODEC_H],
           "batch": EVAL_B, "workers": EVAL_WORKERS, "write_s": write_s,
           "mAP": values[1][-1], "images_per_s": stats["images"] / stats["seconds"],
           "split_s": {k: stats[k] for k in ("loader_s", "device_s", "metric_s")},
           "seconds": stats["seconds"], "launches": launches, "saved_equal_direct": True,
           "phase_s": time.perf_counter() - t_phase}
    emit(out)
    del model
    return launches


def torch_sync() -> None:
    import torch

    torch.cuda.synchronize()


def hier_batches(kernels, what: str) -> int:
    """Batches through the hierarchical tail since ``set_launches``: every
    kernel of it launched that many times its per-batch count, no other."""
    b = kernels["anchor_scores"].launches
    check(b > 0, f"{what}: the tail's kernels launched")
    read_launches(kernels, {name: n * b for name, n in HIER_LAUNCHES.items()}, what)
    return b


def http_phase(dev, kernels, model, classes, predictor) -> dict:
    """``cli.serve.serve_forever`` on 127.0.0.1, port 0, with the main
    path's model at the CLI's defaults (batch 8, flush 5 ms): ``/healthz``
    answers, then 8 client threads post JPEG and PNG uploads and the still
    fixtures of STILL_UPLOADS (WebP, GIF, PPM, 8-bit BMP, PNG with eXIf,
    TIFF, Sun raster, PFM, HDR, CCITT Group 4 TIFF, 9/7 JPEG 2000) for
    about HTTP_SECONDS; every reply equal to ``detections_to_json`` of the
    direct predictor on the same decoded image; requests/s, latency p50 /
    p95 and the batch fill."""
    import logging
    import urllib.request

    from viddet_tpu_torch.cli.serve import (
        decode_image_bytes, detections_to_json, parse_args, serve_forever,
    )
    from viddet_tpu_torch.data.transforms import ValTransform, invert_affine_to_boxes
    from viddet_tpu_torch.infer.service import to_device_batch
    from viddet_tpu_torch.native import encode_jpeg, encode_png

    t_phase = time.perf_counter()
    args = parse_args(["--network", "yolo3_darknet53", "--dataset", "coco", "--port", "0",
                       "--data-shape", str(IMAGE_SIZE), "--thresh", "0.0"])
    rng = np.random.default_rng(HTTP_SEED)
    uploads = []
    for i in range(HTTP_UPLOADS):
        h, w = ((480, 640), (360, 500), (600, 400), (416, 416))[i % 4]
        image = photo_like(rng, h, w)
        uploads.append(encode_jpeg(image, 95) if i % 2 == 0 else encode_png(image))
    uploads += [still(name) for name in STILL_UPLOADS]
    transform = ValTransform((IMAGE_SIZE, IMAGE_SIZE), letterbox_resize=True, normalize=False)
    expected = []
    for data in uploads:
        rgb = decode_image_bytes(data)
        x, _, affine = transform(rgb)
        d_ids, d_scores, d_boxes = (t.cpu().numpy()[0] for t in predictor(
            to_device_batch(x[None], args.batch_size, dev)))
        want = detections_to_json(d_ids, d_scores, invert_affine_to_boxes(d_boxes, affine),
                                  classes, args.thresh)
        want["width"], want["height"] = rgb.shape[1], rgb.shape[0]
        expected.append(want)

    set_launches(kernels)
    server = serve_forever(args, logging.getLogger("chip_smoke"), built=(model, classes))
    port = server.server_address[1]
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
        check(health["status"] == "ok" and health["num_classes"] == len(classes), "/healthz")
        latencies, mismatched, errors = [], [], []
        answered = [0] * len(uploads)
        deadline = time.perf_counter() + HTTP_SECONDS

        def client(offset):
            i = offset
            while time.perf_counter() < deadline:
                k = i % len(uploads)
                req = urllib.request.Request(f"http://127.0.0.1:{port}/detect",
                                             data=uploads[k], method="POST")
                t = time.perf_counter()
                try:
                    with urllib.request.urlopen(req, timeout=120) as resp:
                        got = json.loads(resp.read())
                except Exception as exc:  # noqa: BLE001 -- reported below
                    errors.append(repr(exc))
                    return
                latencies.append((time.perf_counter() - t) * 1e3)
                answered[k] += 1
                if got != expected[k]:
                    mismatched.append(k)
                i += HTTP_THREADS

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(o,)) for o in range(HTTP_THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall = time.perf_counter() - t0
        check(not any(t.is_alive() for t in threads), "HTTP clients finished")
        stats = server.viddet_service.stats()
    finally:
        server.shutdown()
        server.server_close()
        server.viddet_service.close()
    check(not errors, f"no HTTP request failed: {errors[:3]}")
    check(not mismatched, f"every reply equals the direct predictor's JSON {mismatched[:8]}")
    stills = dict(zip(STILL_UPLOADS, answered[len(uploads) - len(STILL_UPLOADS):]))
    check(all(stills.values()), f"every still upload answered {stills}")
    batches = hier_batches(kernels, "http")
    launches = {name: fn.launches for name, fn in kernels.items()}
    out = {"phase": "http", "model": MODEL, "size": IMAGE_SIZE, "batch_size": args.batch_size,
           "flush_ms": args.flush_ms, "threads": HTTP_THREADS, "uploads": len(uploads),
           "requests": len(latencies), "seconds": wall,
           "requests_per_s": len(latencies) / wall,
           "latency_ms_p50": float(np.percentile(latencies, 50)),
           "latency_ms_p95": float(np.percentile(latencies, 95)),
           "batches": batches, "service": stats, "all_equal_direct": True,
           "still_replies": stills, "phase_s": time.perf_counter() - t_phase}
    emit(out)
    return launches


def recorded(predictor, record: list):
    """``predictor`` that keeps each batch it was given and its result."""
    def infer(batch):
        out = predictor(batch)
        record.append((batch.clone(), out))
        return out

    return infer


def check_stream(predictor, record, results, k: int, what: str) -> None:
    """Every recorded batch through ``predictor`` again gives the recorded
    result, and the stream yielded those rows in order, each for the frame
    (or the clip's centre frame) that the batch holds in that row."""
    import torch

    pos = 0
    for batch, out in record:
        direct = predictor(batch)
        check(all(equal(a, b) for a, b in zip(direct, out)),
              f"{what}: the direct predictor on a recorded batch equals its result")
        real = int((batch.flatten(1) != 0).any(1).sum())  # padding rows are all zero
        rows = [t.cpu() for t in direct]
        for j in range(real):
            item = results[pos + j]
            frame = batch[j] if k == 1 else batch[j, k // 2]
            check(torch.equal(frame.cpu(), torch.from_numpy(item["rgb"])),
                  f"{what}: result {pos + j} belongs to its batch row")
            check(all(np.array_equal(a[j].numpy(), b)
                      for a, b in zip(rows, (item["ids"], item["scores"], item["boxes"]))),
                  f"{what}: result {pos + j} equal to the direct predictor")
        pos += real
    check(pos == len(results), f"{what}: every result accounted for ({pos} of {len(results)})")


def window_idle_share(fn) -> dict:
    """Wall time of one call of ``fn`` under torch.profiler, the device's
    busy time in it (kernels and copies) and the idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch_sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch_sync()
        wall_ms = (time.perf_counter() - t) * 1e3
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3
    return {"wall_ms": wall_ms, "device_busy_ms": busy, "idle_share": 1.0 - busy / wall_ms}


def returns_before_device(predictor, images, dev, what: str) -> float:
    """The host's time to call ``predictor`` while the card is still busy
    with a 50 ms spin kernel; fails unless the call returns before the card
    is done.  A predictor that waits for the card inside (an ``.item()``, a
    size read back) would return only after the spin, and then the stream
    loops would overlap nothing."""
    import torch

    from viddet_tpu_torch.infer.service import to_device_batch

    batch = to_device_batch(images, len(images), dev)
    predictor(batch)
    torch_sync()
    torch.cuda._sleep(50 * SPIN_CYCLES_PER_MS)
    t = time.perf_counter()
    predictor(batch)
    call_ms = (time.perf_counter() - t) * 1e3
    done = torch.cuda.Event()
    done.record()
    busy = not done.query()
    torch_sync()
    check(busy and call_ms < 50.0,
          f"{what} returns before the card is done ({call_ms:.1f} ms, card busy: {busy})")
    return call_ms


def stream_phase(dev, kernels, predictor) -> dict:
    """``infer.stream.stream_detect`` over 128 seeded uint8 frames at batch 8
    with the main path's predictor, and ``infer.multistream.
    stream_detect_multi`` over 2 streams of 48 frames with
    yolo3_darknet53_k3_vid (k = 3, stride 1): their launches, every
    result equal to the direct predictor on the batch that held it;
    frames/s and clips/s beside the direct step's (copy in, predictor,
    results back, one batch at a time), and the card's idle share over one
    window of each stream."""
    import torch

    from viddet_tpu_torch.cli.common import make_predictor
    from viddet_tpu_torch.infer.multistream import stream_detect_multi
    from viddet_tpu_torch.infer.service import to_device_batch
    from viddet_tpu_torch.infer.stream import stream_detect
    from viddet_tpu_torch.models.zoo import get_model
    from viddet_tpu_torch.weights import init_flat, load_flat

    t_phase = time.perf_counter()
    rng = np.random.default_rng(STREAM_SEED)
    frames = rng.integers(1, 256, (STREAM_FRAMES, IMAGE_SIZE, IMAGE_SIZE, 3), dtype=np.uint8)
    identity = np.array([1.0, 1.0, 0.0, 0.0], np.float32)

    def source(images):
        return ((i, f, f, identity) for i, f in enumerate(images))

    def collect(gen, keys=("idx", "rgb", "affine", "ids", "scores", "boxes")):
        return [dict(zip(keys, r)) for r in gen]

    def direct_step(infer, images, bs):
        for start in range(0, len(images), bs):
            [t.cpu() for t in infer(to_device_batch(images[start : start + bs], bs, dev))]

    out = {"phase": "stream", "model": MODEL, "size": IMAGE_SIZE, "batch": STREAM_B}
    launches = {}

    # one stream, single-frame model
    record = []
    set_launches(kernels)
    results = collect(stream_detect(source(frames), recorded(predictor, record), STREAM_B,
                                    (IMAGE_SIZE, IMAGE_SIZE), device=dev))
    torch_sync()
    check(hier_batches(kernels, "stream_detect") == STREAM_FRAMES // STREAM_B,
          "stream_detect: one tail a batch")
    launches["stream"] = {name: fn.launches for name, fn in kernels.items()}
    check([r["idx"] for r in results] == list(range(STREAM_FRAMES)), "frames in order")
    check_stream(predictor, record, results, 1, "stream_detect")
    out["predictor_call_ms_behind_spin"] = returns_before_device(predictor, frames[:STREAM_B],
                                                                 dev, "main predictor")
    runs = {}  # one pass each; the checked run above warmed both
    for name, fn in (("stream", lambda: collect(stream_detect(
            source(frames), predictor, STREAM_B, (IMAGE_SIZE, IMAGE_SIZE), device=dev))),
                     ("direct", lambda: direct_step(predictor, frames, STREAM_B))):
        t = time.perf_counter()
        fn()
        runs[name] = STREAM_FRAMES / (time.perf_counter() - t)
    out["frames_per_s"] = runs["stream"]
    out["direct_frames_per_s"] = runs["direct"]
    out["window"] = window_idle_share(lambda: collect(stream_detect(
        source(frames), predictor, STREAM_B, (IMAGE_SIZE, IMAGE_SIZE), device=dev)))
    out["direct_window"] = window_idle_share(lambda: direct_step(predictor, frames, STREAM_B))

    # two streams, temporal model
    model, _ = get_model(TEMPORAL_MODEL)
    load_flat(model, init_flat(TEMPORAL_MODEL, seed=0))
    temporal = make_predictor(model)
    streams = {f"s{i}": frames[i * MULTI_FRAMES : (i + 1) * MULTI_FRAMES]
               for i in range(MULTI_STREAMS)}
    record = []
    set_launches(kernels)
    multi_keys = ("stream", "idx", "rgb", "affine", "ids", "scores", "boxes")
    results = collect(stream_detect_multi(
        {n: source(f) for n, f in streams.items()}, recorded(temporal, record), STREAM_B,
        (IMAGE_SIZE, IMAGE_SIZE), k=TEMPORAL_K, stride=1, device=dev), multi_keys)
    torch_sync()
    multi_batches = hier_batches(kernels, "stream_detect_multi")
    launches["stream_multi"] = {name: fn.launches for name, fn in kernels.items()}
    check(multi_batches == len(record), "stream_detect_multi: one tail a batch")
    check_stream(temporal, record, results, TEMPORAL_K, "stream_detect_multi")
    for name in streams:  # each stream's keys in order: 1 .. n-2, then the flush's n-1
        check([r["idx"] for r in results if r["stream"] == name] == list(range(1, MULTI_FRAMES)),
              f"stream {name} in frame order")
    clips = len(results)
    check(clips == MULTI_STREAMS * (MULTI_FRAMES - 1), f"one clip a frame but the first ({clips})")

    def multi():
        return list(stream_detect_multi({n: source(f) for n, f in streams.items()},
                                        temporal, STREAM_B, (IMAGE_SIZE, IMAGE_SIZE),
                                        k=TEMPORAL_K, stride=1, device=dev))

    clip_batch = np.stack([frames[i : i + TEMPORAL_K] for i in range(STREAM_B)])
    out["temporal_call_ms_behind_spin"] = returns_before_device(temporal, clip_batch, dev,
                                                                "temporal predictor")
    t = time.perf_counter()
    multi()
    out["multi_clips_per_s"] = clips / (time.perf_counter() - t)
    reps = -(-clips // STREAM_B)
    direct_step(temporal, clip_batch, STREAM_B)
    t = time.perf_counter()
    for _ in range(reps):
        direct_step(temporal, clip_batch, STREAM_B)
    out["multi_direct_clips_per_s"] = reps * STREAM_B / (time.perf_counter() - t)
    out["multi_window"] = window_idle_share(multi)
    out.update(temporal_model=TEMPORAL_MODEL, k=TEMPORAL_K, streams=MULTI_STREAMS,
               frames_per_stream=MULTI_FRAMES, clips=clips, multi_batches=multi_batches,
               all_equal_direct=True, phase_s=time.perf_counter() - t_phase)
    emit(out)
    del model
    return launches


def detect_phase(dev, kernels, model, classes, predictor) -> dict:
    """``cli.detect.main`` over a directory of 8 JPEG and 8 PNG files and
    cv2's 8-bit palette BMP (DETECT_STILL) with the main path's model at
    batch 8: every ``{stem}.txt`` equal to the direct predictor's lines on
    the same decoded file, every ``{stem}_det.jpg`` decoding to its
    original's size; images/s.  Then a WebP, a TIFF and a 9/7 JP2
    (DETECT_SINGLES), each given alone as ``--input``: its ``.txt`` equal to
    the direct predictor's, one tail each."""
    import tempfile

    from viddet_tpu_torch.cli import detect
    from viddet_tpu_torch.data.base import imread_rgb
    from viddet_tpu_torch.data.transforms import ValTransform, invert_affine_to_boxes
    from viddet_tpu_torch.infer.service import to_device_batch
    from viddet_tpu_torch.native import encode_jpeg, encode_png

    t_phase = time.perf_counter()
    bs = 8
    rng = np.random.default_rng(DETECT_SEED)
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in"), os.path.join(tmp, "out")
        os.makedirs(src)
        for i in range(DETECT_FILES):
            h, w = ((480, 640), (375, 500), (640, 427), (300, 300))[i % 4]
            image = photo_like(rng, h, w)
            name = f"{i:02d}.jpg" if i % 2 == 0 else f"{i:02d}.png"
            with open(os.path.join(src, name), "wb") as f:
                f.write(encode_jpeg(image, 95) if i % 2 == 0 else encode_png(image))
        with open(os.path.join(src, DETECT_STILL), "wb") as f:
            f.write(still(DETECT_STILL))
        set_launches(kernels)
        t0 = time.perf_counter()
        done = detect.main(["--network", "yolo3_darknet53", "--dataset", "coco", "--input", src,
                            "--output", dst, "--data-shape", str(IMAGE_SIZE), "--batch-size",
                            str(bs), "--thresh", "0.05", "--save-detections"],
                           built=(model, classes))
        wall = time.perf_counter() - t0
        torch_sync()
        check(done == DETECT_FILES + 1, "detect did every file")
        batches = hier_batches(kernels, "detect")
        check(batches == -(-(DETECT_FILES + 1) // bs), "detect: one tail a batch")
        launches = {name: fn.launches for name, fn in kernels.items()}
        files = sorted(os.listdir(src))
        transform = ValTransform((IMAGE_SIZE, IMAGE_SIZE), letterbox_resize=True,
                                 normalize=False)
        lines = 0
        for start in range(0, len(files), bs):
            chunk = files[start : start + bs]
            origs = [imread_rgb(os.path.join(src, f)) for f in chunk]
            prepared = [transform(o) for o in origs]
            d_ids, d_scores, d_boxes = (t.cpu().numpy() for t in predictor(
                to_device_batch(np.stack([p[0] for p in prepared]), bs, dev)))
            for j, f in enumerate(chunk):
                stem = os.path.splitext(f)[0]
                want = detect.detection_lines(
                    d_ids[j], d_scores[j], invert_affine_to_boxes(d_boxes[j], prepared[j][2]),
                    classes, 0.05)
                with open(os.path.join(dst, f"{stem}.txt")) as fh:
                    got = fh.read()
                check(got == want, f"detect {stem}.txt equal to the direct predictor")
                lines += len(got.splitlines())
                drawn = imread_rgb(os.path.join(dst, f"{stem}_det.jpg"))
                check(drawn.shape == origs[j].shape, f"{stem}_det.jpg decodes")
        # each single file given alone as --input, as JAX's collect_inputs takes one
        for name in DETECT_SINGLES:
            single = os.path.join(tmp, name)
            with open(single, "wb") as f:
                f.write(still(name))
            set_launches(kernels)
            stem = os.path.splitext(name)[0]
            check(detect.main(["--network", "yolo3_darknet53", "--dataset", "coco", "--input",
                               single, "--output", os.path.join(tmp, stem), "--data-shape",
                               str(IMAGE_SIZE), "--batch-size", str(bs), "--thresh", "0.05",
                               "--save-detections", "--no-draw"], built=(model, classes)) == 1,
                  f"detect did the single {name}")
            torch_sync()
            check(hier_batches(kernels, f"detect single {name}") == 1,
                  f"detect single {name}: one tail")
            orig = imread_rgb(single)
            x, _, affine = transform(orig)
            d_ids, d_scores, d_boxes = (t.cpu().numpy()[0] for t in predictor(
                to_device_batch(x[None], bs, dev)))
            want = detect.detection_lines(d_ids, d_scores,
                                          invert_affine_to_boxes(d_boxes, affine), classes, 0.05)
            with open(os.path.join(tmp, stem, f"{stem}.txt")) as fh:
                check(fh.read() == want, f"detect {stem}.txt equal to the direct predictor")
    emit({"phase": "detect", "model": MODEL, "size": IMAGE_SIZE, "files": DETECT_FILES + 1,
          "still_in_directory": DETECT_STILL, "single_inputs": list(DETECT_SINGLES),
          "batch": bs, "seconds": wall, "images_per_s": (DETECT_FILES + 1) / wall,
          "lines": lines, "batches": batches, "all_equal_direct": True,
          "phase_s": time.perf_counter() - t_phase})
    return launches


# ---------------------------------------------------------------------------
# Phase 12: video
# ---------------------------------------------------------------------------


def video_rows(model, predictor, record, lookup: dict, frames_x: dict, k: int,
               what: str) -> dict:
    """Each recorded batch of a video path: the direct predictor on it equals
    the recorded result, and the head's outputs through the kernel tail
    equal the plain tail and that result; each real row (padding rows are
    all zero) is the transformed frame, or clip, that its centre frame's
    bytes name in ``lookup`` (stream, frame index).  Returns (stream, frame
    index) -> that row's (ids, scores, boxes) on the host."""
    import hashlib

    import torch

    from viddet_tpu_torch.ops.nms import multiclass_nms_late_decode_cells

    rows = {}
    with torch.inference_mode():
        for batch, out in record:
            check(all(equal(a, b) for a, b in zip(predictor(batch), out)),
                  f"{what}: the direct predictor on a recorded batch equals its result")
            head = model(normalized(batch))
            tails = [multiclass_nms_late_decode_cells(head["raws_cells"], head["meta"],
                                                      backend=b) for b in ("auto", "plain")]
            check(all(equal(a, b) for a, b in zip(*tails)),
                  f"{what}: kernel tail equal to plain tail on the batch's head outputs")
            check(all(equal(a, b) for a, b in zip(tails[0], out)),
                  f"{what}: head + kernel tail equal to the predictor")
            host = batch.cpu().numpy()
            result = [t.cpu().numpy() for t in out]
            for j in range(host.shape[0]):
                if not host[j].any():
                    continue  # padding
                centre = host[j] if k == 1 else host[j, k // 2]
                key = lookup.get(hashlib.sha1(centre.tobytes()).digest())
                check(key is not None and key not in rows,
                      f"{what}: batch row {j} is a frame of the video, once")
                stream, idx = key
                n = len(frames_x[stream])
                want = (frames_x[stream][idx] if k == 1 else
                        frames_x[stream][[idx - 1, idx, min(idx + 1, n - 1)]])
                check(np.array_equal(host[j], want),
                      f"{what}: row of frame {idx} equal to the decoded, transformed frame")
                rows[key] = tuple(r[j] for r in result)
    return rows


def video_lines(rows: dict, stream: str, indices, affine, classes, thresh: float) -> str:
    """The ``{stem}_det.txt`` that ``rows`` give for ``stream``'s frames."""
    from viddet_tpu_torch.data.transforms import invert_affine_to_boxes
    from viddet_tpu_torch.infer.stream import detection_line

    lines = []
    for idx in indices:
        ids, scores, boxes = rows[(stream, idx)]
        lines += [detection_line(idx, classes[int(c)], s, b)
                  for c, s, b in zip(ids, scores, invert_affine_to_boxes(boxes, affine))
                  if c >= 0 and s >= thresh]
    return "".join(lines)


def path_batches(kernels, what: str, batches: int) -> dict:
    """The launches since ``set_launches`` of a run of ``batches`` batches
    through the hierarchical tail (and nothing else)."""
    torch_sync()
    check(hier_batches(kernels, what) == batches, f"{what}: one tail a batch ({batches})")
    return {name: fn.launches for name, fn in kernels.items()}


def direct_frames_per_s(infer, xs, dev) -> float:
    """Frames (or clips) a second of ``infer`` on ``xs`` in batches of
    VIDEO_B, each result on the host: the direct step a video run is read
    beside."""
    from viddet_tpu_torch.infer.service import to_device_batch

    infer(to_device_batch(xs[:VIDEO_B], VIDEO_B, dev))
    t = time.perf_counter()
    for start in range(0, len(xs), VIDEO_B):
        [r.cpu() for r in infer(to_device_batch(xs[start : start + VIDEO_B], VIDEO_B, dev))]
    return len(xs) / (time.perf_counter() - t)


def video_phase(dev, kernels, model, classes, predictor) -> dict:
    """Two seeded 640x480 Motion-JPEG AVIs (128 frames, 25 fps) written by
    ``AviWriter``, read back by the port's reader; then with the main
    path's model at batch 8 ``stream_detect_video`` (drawn, through
    ``FrameSource``; then not drawn, through ``NativeFrameSource``),
    ``stream_detect_videos`` over both with yolo3_darknet53_k3_vid (k = 3),
    ``cli.detect.main`` over one AVI and ``cli.extract_frames.main --every
    4``.  Checks: each run's launches, each batch through ``video_rows``,
    every saved line equal to the direct predictor's, the drawn
    ``_det.mp4`` (``check_drawn_mp4``), both sources' batches equal, the
    extracted files equal to the encoder's bytes.  Frames/s of each run
    (host clock, the whole call) beside the direct step on the same
    transformed frames; the Motion-JPEG writer's (each AVI on its own
    thread), the MPEG-4 encoder's alone (one thread, 640x480), the
    reader's (demux + decode, one thread); the card's idle share over a
    native run of the first
    VIDEO_IDLE_FRAMES frames.  The threshold keeps about VIDEO_BOXES boxes
    a frame (see the constants)."""
    import contextlib
    import hashlib
    import tempfile

    import torch

    from viddet_tpu_torch.cli import detect, extract_frames
    from viddet_tpu_torch.cli.common import make_predictor
    from viddet_tpu_torch.data.transforms import ValTransform, invert_affine_to_boxes
    from viddet_tpu_torch.infer.multistream import stream_detect_videos
    from viddet_tpu_torch.infer.service import to_device_batch
    from viddet_tpu_torch.infer.stream import stream_detect_video
    from viddet_tpu_torch.models.zoo import get_model
    from viddet_tpu_torch.native import Mpeg4Encoder, decode_jpeg, encode_jpeg
    from viddet_tpu_torch.native.avi import AviReader, AviWriter, read_index
    from viddet_tpu_torch.utils.image import draw_detections
    from viddet_tpu_torch.utils.video import iterate_frames, writer_rate
    from viddet_tpu_torch.weights import init_flat, load_flat

    t_phase = time.perf_counter()
    size = (IMAGE_SIZE, IMAGE_SIZE)
    transform = ValTransform(size, letterbox_resize=True, normalize=False)
    out = {"phase": "video", "model": MODEL, "size": IMAGE_SIZE, "batch": VIDEO_B,
           "frames": VIDEO_FRAMES, "video": [CODEC_W, CODEC_H], "fps": VIDEO_FPS}
    launches = {}
    split, last = {}, [t_phase]

    def lap(name: str) -> None:  # host seconds of each step of the phase
        now = time.perf_counter()
        split[name], last[0] = now - last[0], now

    with tempfile.TemporaryDirectory() as tmp:
        paths = {name: os.path.join(tmp, f"{name}.avi") for name in ("a", "b")}
        images = {name: in_threads(
            lambda j, i=i: photo_like(np.random.default_rng((VIDEO_SEED, i, j)), CODEC_H, CODEC_W),
            range(VIDEO_FRAMES), ENCODE_WORKERS) for i, name in enumerate(paths)}

        def write(name):  # each on its own thread: the encoder releases the GIL
            t = time.perf_counter()
            with AviWriter(paths[name], CODEC_W, CODEC_H, VIDEO_FPS) as writer:
                for image in images[name]:
                    writer.write(image)
            return VIDEO_FRAMES / (time.perf_counter() - t)

        out["writer_frames_per_s"] = in_threads(write, list(paths), len(paths))[0]
        out["avi_mb"] = os.path.getsize(paths["a"]) / 1e6
        lap("generate_and_write")
        encoder = Mpeg4Encoder(CODEC_W, CODEC_H, *writer_rate(VIDEO_FPS))
        t = time.perf_counter()
        for image in images["a"]:  # the encoder alone, on one thread
            encoder.encode(image)
        out["mpeg4_writer_frames_per_s"] = VIDEO_FRAMES / (time.perf_counter() - t)
        encoder.close()
        lap("mpeg4_encode")
        t = time.perf_counter()
        decoded = {"a": [f for _, f in iterate_frames(paths["a"])]}
        out["reader_frames_per_s"] = VIDEO_FRAMES / (time.perf_counter() - t)
        with AviReader(paths["b"]) as video:
            decoded["b"] = in_threads(decode_jpeg, list(video), ENCODE_WORKERS)
        frames_x, lookup = {}, {}
        for name, path in paths.items():
            index = read_index(path)
            check((index.frame_count, index.width, index.height, index.fps)
                  == (VIDEO_FRAMES, CODEC_W, CODEC_H, VIDEO_FPS), f"{name}.avi reads back")
            for f, image in list(zip(decoded[name], images[name]))[::8]:
                check(np.array_equal(f, decode_jpeg(encode_jpeg(image, 95))),
                      f"{name}.avi frames equal their JPEG round trip")
            frames_x[name] = np.stack(in_threads(lambda f: transform(f)[0], decoded[name],
                                                 ENCODE_WORKERS))
            for idx, x in enumerate(frames_x[name]):
                lookup[hashlib.sha1(x.tobytes()).digest()] = (name, idx)
        lap("read_and_transform")
        del images
        affine = transform(decoded["a"][0])[2]
        out["direct_frames_per_s"] = direct_frames_per_s(predictor, frames_x["a"], dev)
        first = predictor(to_device_batch(frames_x["a"][:VIDEO_B], VIDEO_B, dev))[1].cpu().numpy()
        thresh = out["thresh"] = float(np.median(first[:, VIDEO_BOXES - 1]))
        lap("direct")

        # 1. one video, drawn, through FrameSource
        runs, records = {}, {}
        batches = -(-VIDEO_FRAMES // VIDEO_B)
        for run, draw in (("video", True), ("video_native", False)):
            records[run] = []
            set_launches(kernels)
            stats = stream_detect_video(paths["a"], recorded(predictor, records[run]),
                                        transform, classes, output_dir=os.path.join(tmp, run),
                                        thresh=thresh, batch_size=VIDEO_B, draw=draw,
                                        save_detections=True, device=dev)
            launches[run] = path_batches(kernels, run, batches)
            check(stats["frames"] == VIDEO_FRAMES, f"{run}: every frame")
            runs[run] = stats["fps"]
        out["frames_per_s"] = runs
        lap("runs")
        check(all(torch.equal(a[0], b[0]) for a, b in zip(records["video"],
                                                          records["video_native"])),
              "the native and thread sources give equal batches")
        rows = video_rows(model, predictor, records["video"], lookup, frames_x, 1, "video")
        check(sorted(rows) == [("a", i) for i in range(VIDEO_FRAMES)], "video: every frame once")
        want = video_lines(rows, "a", range(VIDEO_FRAMES), affine, classes, thresh)
        for run in runs:
            with open(os.path.join(tmp, run, "a_det.txt")) as f:
                check(f.read() == want, f"{run}: a_det.txt equal to the direct predictor's")
        out["lines"] = len(want.splitlines())
        out["boxes_per_frame"] = float(np.mean([(r[1] >= thresh).sum() for r in rows.values()]))
        lap("rows_check")
        vis = [draw_detections(decoded["a"][idx], invert_affine_to_boxes(rows[("a", idx)][2],
                                                                         affine),
                               rows[("a", idx)][0], rows[("a", idx)][1], classes, thresh)
               for idx in range(VIDEO_FRAMES)]
        out["drawn"] = check_drawn_mp4(os.path.join(tmp, "video", "a_det.mp4"), vis, VIDEO_FPS,
                                       "a_det.mp4")
        del vis
        lap("drawn_check")
        short = os.path.join(tmp, "short.avi")  # the first frames of a.avi, their bytes as stored
        with AviReader(paths["a"]) as video, AviWriter(short, CODEC_W, CODEC_H,
                                                       VIDEO_FPS) as writer:
            for i in range(VIDEO_IDLE_FRAMES):
                writer.write_jpeg(video.sample(i))
        out["window"] = window_idle_share(lambda: stream_detect_video(
            short, predictor, transform, classes, output_dir=os.path.join(tmp, "idle"),
            batch_size=VIDEO_B, draw=False, device=dev))
        out["window"]["frames"] = VIDEO_IDLE_FRAMES

        lap("idle_window")

        # 2. both videos through one batch, temporal model
        temporal_model, vid_classes = get_model(TEMPORAL_MODEL)
        load_flat(temporal_model, init_flat(TEMPORAL_MODEL, seed=0))
        temporal = make_predictor(temporal_model)
        lap("temporal_load")
        record = []
        set_launches(kernels)
        stats = stream_detect_videos(list(paths.values()), recorded(temporal, record), transform,
                                     vid_classes, output_dir=os.path.join(tmp, "multi"),
                                     thresh=thresh, batch_size=VIDEO_B, k=TEMPORAL_K,
                                     draw=False, save_detections=True, device=dev)
        launches["video_multi"] = path_batches(kernels, "video_multi", len(record))
        lap("multi_run")
        clips = 2 * (VIDEO_FRAMES - 1)
        check(stats["per_stream"] == {"a.avi": VIDEO_FRAMES - 1, "b.avi": VIDEO_FRAMES - 1},
              f"video_multi: one clip a frame but the first {stats['per_stream']}")
        multi_rows = video_rows(temporal_model, temporal, record, lookup, frames_x, TEMPORAL_K,
                                "video_multi")
        for name in paths:
            with open(os.path.join(tmp, "multi", f"{name}_det.txt")) as f:
                check(f.read() == video_lines(multi_rows, name, range(1, VIDEO_FRAMES), affine,
                                              vid_classes, thresh),
                      f"video_multi: {name}_det.txt equal to the direct predictor's")
        n = VIDEO_FRAMES
        clip_x = np.stack([frames_x["a"][[i - 1, i, min(i + 1, n - 1)]] for i in range(1, n)])
        out["multi"] = {"model": TEMPORAL_MODEL, "k": TEMPORAL_K, "clips": clips,
                        "batches": len(record), "clips_per_s": stats["fps"],
                        "direct_clips_per_s": direct_frames_per_s(temporal, clip_x, dev)}
        del temporal_model, temporal, record

        lap("multi_check")

        # 3. the detect CLI over one video; extract_frames
        set_launches(kernels)
        t = time.perf_counter()
        done = detect.main(["--network", "yolo3_darknet53", "--dataset", "coco", "--input",
                            paths["a"], "--output", os.path.join(tmp, "cli"), "--data-shape",
                            str(IMAGE_SIZE), "--batch-size", str(VIDEO_B), "--thresh",
                            str(thresh), "--save-detections", "--no-draw"],
                           built=(model, classes))
        out["detect_cli_frames_per_s"] = done / (time.perf_counter() - t)
        launches["video_detect"] = path_batches(kernels, "video_detect", batches)
        check(done == VIDEO_FRAMES, "detect: every frame")
        with open(os.path.join(tmp, "cli", "a_det.txt")) as f:
            check(f.read() == want, "detect: a_det.txt equal to the direct predictor's")
        lap("detect")
        t = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):  # its report lines; stdout holds JSON
            written = extract_frames.main(["--input", paths["a"], "--output",
                                           os.path.join(tmp, "frames"), "--every",
                                           str(VIDEO_EVERY)])
        out["extract_frames_per_s"] = written / (time.perf_counter() - t)
        check(written == VIDEO_FRAMES // VIDEO_EVERY, "extract_frames: every 4th frame")
        for idx in range(0, VIDEO_FRAMES, VIDEO_EVERY):
            with open(os.path.join(tmp, "frames", f"{idx:08d}.jpg"), "rb") as f:
                check(f.read() == encode_jpeg(decoded["a"][idx], 95),
                      f"extracted frame {idx} is the encoder's bytes")
    lap("extract")
    out.update(all_equal_direct=True, split_s=split, phase_s=time.perf_counter() - t_phase)
    emit(out)
    return launches


def mp4_phase(dev, kernels, model, classes, predictor) -> dict:
    """MP4 input: the committed 640x480 ``mp4v`` fixture (48 frames, 25 fps,
    written by ``cv2.VideoWriter`` as the JAX package's ``VideoWriter``
    writes, ``tests/fixtures/make_mp4_fixture.py``) decoded by the port's
    MPEG-4 Part 2 decoder to the SHA-256 of each Y plane and RGB frame that
    OpenCV's FFmpeg gave; then, with the main path's model at batch 8,
    ``stream_detect_video`` over it drawn (``FrameSource``) and not drawn
    (``NativeFrameSource``), ``stream_detect_videos`` over it and an OpenDML
    AVI of its frames (split into RIFF segments of MP4_SEGMENT_BYTES) in one
    batch, and ``cli.detect.main --input clip.mp4``.  Checks: each run's
    launches, each batch through ``video_rows``, every saved line equal to
    the direct predictor's, the drawn ``clip_det.mp4`` (``check_drawn_mp4``),
    both sources' batches equal.  Also what ran on no card before: ``NativeFrameSource``
    normalized and without letterbox against ``FrameSource`` bit for bit,
    the split AVI read back, and ``cli.visualise`` with ``--video`` and
    ``--gif`` (``utils/gif.py``).  Frames/s: the MP4 reader on one thread
    (demux + decode + RGB, decode + RGB alone, decode alone), each run
    beside the direct step; the card's idle share over a native run."""
    import contextlib
    import hashlib
    import json
    import tempfile

    import torch

    from viddet_tpu_torch.cli import detect, visualise
    from viddet_tpu_torch.cli.common import get_dataset
    from viddet_tpu_torch.data.transforms import ValTransform, invert_affine_to_boxes
    from viddet_tpu_torch.infer.multistream import stream_detect_videos
    from viddet_tpu_torch.infer.service import to_device_batch
    from viddet_tpu_torch.infer.stream import FrameSource, NativeFrameSource, stream_detect_video
    from viddet_tpu_torch.native import Mpeg4Decoder, decode_jpeg, encode_jpeg
    from viddet_tpu_torch.native.avi import AviReader, AviWriter
    from viddet_tpu_torch.native.mp4 import Mp4Reader
    from viddet_tpu_torch.utils.gif import write_gif
    from viddet_tpu_torch.utils.image import draw_detections
    from viddet_tpu_torch.utils.video import iterate_frames, probe_video

    t_phase = time.perf_counter()
    size = (IMAGE_SIZE, IMAGE_SIZE)
    transform = ValTransform(size, letterbox_resize=True, normalize=False)
    out = {"phase": "mp4", "model": MODEL, "size": IMAGE_SIZE, "batch": VIDEO_B,
           "fixture": os.path.relpath(MP4_FIXTURE, os.path.dirname(os.path.abspath(__file__)))}
    launches = {}

    def sha(a) -> str:
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()

    # 1. the fixture, decoded to OpenCV's digests
    with open(MP4_DIGESTS) as f:
        digests = json.load(f)["frames"]
    info = probe_video(MP4_FIXTURE)
    check(info == {"fps": float(VIDEO_FPS), "frame_count": MP4_FRAMES, "width": CODEC_W,
                   "height": CODEC_H}, f"the fixture probes as written: {info}")
    with Mp4Reader(MP4_FIXTURE) as reader:
        config = reader.index.config
        samples = [reader.sample(i) for i in range(len(reader))]
    check(len(samples) == len(digests) == MP4_FRAMES, "the fixture has its 48 samples")
    decoder = Mpeg4Decoder(config, MP4_FIXTURE)
    frames = []
    for i, sample in enumerate(samples):
        frames.append(decoder.decode(sample))
        check(sha(decoder.planes()[0]) == digests[i]["y"],
              f"mp4 frame {i}: the Y plane's digest is OpenCV's")
        check(sha(frames[-1]) == digests[i]["rgb"], f"mp4 frame {i}: the RGB digest is OpenCV's")
    decoder.close()
    out["digests_equal"] = MP4_FRAMES
    rates = {}
    t = time.perf_counter()
    check(sum(1 for _ in iterate_frames(MP4_FIXTURE)) == MP4_FRAMES, "iterate_frames: 48")
    rates["demux_decode_rgb"] = MP4_FRAMES / (time.perf_counter() - t)
    for what, rgb in (("decode_rgb", True), ("decode", False)):
        decoder = Mpeg4Decoder(config)
        t = time.perf_counter()
        for sample in samples:
            decoder.decode(sample, rgb=rgb)
        rates[what] = MP4_FRAMES / (time.perf_counter() - t)
        decoder.close()
    out["reader_frames_per_s"] = rates  # one host thread

    frames_x = {"clip": np.stack([transform(f)[0] for f in frames])}
    affine = transform(frames[0])[2]
    lookup = {hashlib.sha1(x.tobytes()).digest(): ("clip", i)
              for i, x in enumerate(frames_x["clip"])}
    out["direct_frames_per_s"] = direct_frames_per_s(predictor, frames_x["clip"], dev)
    first = predictor(to_device_batch(frames_x["clip"][:VIDEO_B], VIDEO_B, dev))[1].cpu().numpy()
    thresh = out["thresh"] = float(np.median(first[:, VIDEO_BOXES - 1]))

    with tempfile.TemporaryDirectory() as tmp:
        clip = os.path.join(tmp, "clip.mp4")
        shutil.copyfile(MP4_FIXTURE, clip)
        batches = -(-MP4_FRAMES // VIDEO_B)

        # 2. one MP4, drawn through FrameSource, then not drawn through NativeFrameSource
        runs, records = {}, {}
        for run, draw in (("mp4_video", True), ("mp4_video_native", False)):
            records[run] = []
            set_launches(kernels)
            stats = stream_detect_video(clip, recorded(predictor, records[run]), transform,
                                        classes, output_dir=os.path.join(tmp, run),
                                        thresh=thresh, batch_size=VIDEO_B, draw=draw,
                                        save_detections=True, device=dev)
            launches[run] = path_batches(kernels, run, batches)
            check(stats["frames"] == MP4_FRAMES, f"{run}: every frame")
            runs[run] = stats["fps"]
        check(all(torch.equal(a[0], b[0]) for a, b in zip(records["mp4_video"],
                                                          records["mp4_video_native"])),
              "mp4: the native and thread sources give equal batches")
        rows = video_rows(model, predictor, records["mp4_video"], lookup, frames_x, 1,
                          "mp4_video")
        check(sorted(rows) == [("clip", i) for i in range(MP4_FRAMES)], "mp4: every frame once")
        want = video_lines(rows, "clip", range(MP4_FRAMES), affine, classes, thresh)
        for run in runs:
            with open(os.path.join(tmp, run, "clip_det.txt")) as f:
                check(f.read() == want, f"{run}: clip_det.txt equal to the direct predictor's")
        out["lines"] = len(want.splitlines())
        vis = [draw_detections(frames[idx], invert_affine_to_boxes(rows[("clip", idx)][2],
                                                                   affine),
                               rows[("clip", idx)][0], rows[("clip", idx)][1], classes, thresh)
               for idx in range(MP4_FRAMES)]
        out["drawn"] = check_drawn_mp4(os.path.join(tmp, "mp4_video", "clip_det.mp4"), vis,
                                       VIDEO_FPS, "mp4: clip_det.mp4")
        out["window"] = window_idle_share(lambda: stream_detect_video(
            clip, predictor, transform, classes, output_dir=os.path.join(tmp, "idle"),
            batch_size=VIDEO_B, draw=False, device=dev))
        out["window"]["frames"] = MP4_FRAMES

        # 3. an OpenDML AVI of the same frames, split into RIFF segments
        split = os.path.join(tmp, "split.avi")
        with AviWriter(split, CODEC_W, CODEC_H, VIDEO_FPS,
                       segment_bytes=MP4_SEGMENT_BYTES) as writer:
            for f in frames:
                writer.write(f)
        with open(split, "rb") as f:
            data = f.read()
        segments = sum(1 for i in range(0, len(data) - 12)
                       if data[i:i + 4] == b"RIFF" and data[i + 8:i + 12] in (b"AVI ", b"AVIX"))
        check(segments >= 3, f"split.avi: {segments} RIFF segments of {MP4_SEGMENT_BYTES} bytes")
        with AviReader(split) as video:
            check(len(video) == MP4_FRAMES, "split.avi: every frame read back across segments")
        frames_x["split"] = []
        for idx, frame in iterate_frames(split):
            check(np.array_equal(frame, decode_jpeg(encode_jpeg(frames[idx], 95))),
                  f"split.avi frame {idx} is the MP4 frame at JPEG q 95")
            frames_x["split"].append(transform(frame)[0])
        frames_x["split"] = np.stack(frames_x["split"])
        for i, x in enumerate(frames_x["split"]):
            lookup[hashlib.sha1(x.tobytes()).digest()] = ("split", i)
        out["split_avi"] = {"segments": segments, "segment_bytes": MP4_SEGMENT_BYTES}

        # 4. the MP4 and the AVI through one batch
        record = []
        set_launches(kernels)
        stats = stream_detect_videos([clip, split], recorded(predictor, record), transform,
                                     classes, output_dir=os.path.join(tmp, "multi"),
                                     thresh=thresh, batch_size=VIDEO_B, draw=False,
                                     save_detections=True, device=dev)
        launches["mp4_video_multi"] = path_batches(kernels, "mp4_video_multi", len(record))
        check(stats["per_stream"] == {"clip.mp4": MP4_FRAMES, "split.avi": MP4_FRAMES},
              f"mp4_video_multi: every frame of both {stats['per_stream']}")
        multi_rows = video_rows(model, predictor, record, lookup, frames_x, 1, "mp4_video_multi")
        for name in ("clip", "split"):
            with open(os.path.join(tmp, "multi", f"{name}_det.txt")) as f:
                check(f.read() == video_lines(multi_rows, name, range(MP4_FRAMES), affine,
                                              classes, thresh),
                      f"mp4_video_multi: {name}_det.txt equal to the direct predictor's")
        runs["mp4_video_multi"] = stats["fps"]

        # 5. the detect CLI over the MP4
        set_launches(kernels)
        t = time.perf_counter()
        done = detect.main(["--network", "yolo3_darknet53", "--dataset", "coco", "--input",
                            clip, "--output", os.path.join(tmp, "cli"), "--data-shape",
                            str(IMAGE_SIZE), "--batch-size", str(VIDEO_B), "--thresh",
                            str(thresh), "--save-detections", "--no-draw"],
                           built=(model, classes))
        runs["mp4_detect_cli"] = done / (time.perf_counter() - t)
        launches["mp4_detect"] = path_batches(kernels, "mp4_detect", batches)
        check(done == MP4_FRAMES, "detect: every MP4 frame")
        with open(os.path.join(tmp, "cli", "clip_det.txt")) as f:
            check(f.read() == want, "detect: clip_det.txt equal to the direct predictor's")
        out["frames_per_s"] = runs

        # 6. NativeFrameSource normalized, and without the letterbox, against FrameSource
        for normalize, letterbox in ((True, True), (False, False)):
            native = list(NativeFrameSource(clip, size, letterbox_resize=letterbox,
                                            normalize=normalize))
            thread = list(FrameSource(clip, ValTransform(size, letterbox, normalize=normalize)))
            check(len(native) == len(thread) == MP4_FRAMES and all(
                a[0] == b[0] and np.array_equal(a[2], b[2]) and np.array_equal(a[3], b[3])
                for a, b in zip(native, thread)),
                f"NativeFrameSource (normalize {normalize}, letterbox {letterbox}) equals "
                "FrameSource bit for bit")

        # 7. cli.visualise: GT boxes of the synthetic dataset, a video and a GIF
        vis_dir = os.path.join(tmp, "vis")
        with contextlib.redirect_stdout(sys.stderr):
            n = visualise.main(["--dataset", "synthetic", "--data-root", "synthetic",
                                "--output", vis_dir, "--max-images", str(MP4_VIS_FRAMES),
                                "--video", "v.mp4", "--gif", "v.gif", "--fps", "10"])
        check(n == MP4_VIS_FRAMES, f"visualise: {MP4_VIS_FRAMES} visualisations")
        ds, _ = get_dataset("synthetic", "synthetic", split="val")
        gif_frames = []
        for i in range(MP4_VIS_FRAMES):
            img, label = ds[i]
            vis = draw_detections(img, label[:, :4], label[:, 4], np.ones(len(label)),
                                  list(ds.classes), thresh=0.0)
            with open(os.path.join(vis_dir, f"{i:06d}_vis.jpg"), "rb") as f:
                check(f.read() == encode_jpeg(vis, 95),
                      f"visualise: {i:06d}_vis.jpg is the drawn image at JPEG q 95")
            gif_frames.append(vis)
        out["visualise_video"] = check_drawn_mp4(os.path.join(vis_dir, "v.mp4"), gif_frames, 10,
                                                 "visualise: v.mp4")
        write_gif(os.path.join(tmp, "want.gif"), gif_frames, duration_ms=100, loop=0)
        with open(os.path.join(vis_dir, "v.gif"), "rb") as a, \
                open(os.path.join(tmp, "want.gif"), "rb") as b:
            check(a.read() == b.read(), "visualise: v.gif is utils.gif's encoding of the frames")
    out.update(all_equal_direct=True, phase_s=time.perf_counter() - t_phase)
    emit(out)
    return launches


def check_drawn_mp4(path: str, vis, fps, label: str) -> dict:
    """A drawn ``_det.mp4`` against the drawn frames ``vis`` (RGB, in
    order): the port's reader gives their count, size and ``fps``; the
    file is the bytes a fresh ``VideoWriter`` writes from them; each frame
    the port's decoder shows equals that encoder's reconstruction bit for
    bit; each frame's PSNR against its drawn frame is at least
    DRAWN_PSNR_DB.  Returns the file's bytes beside the JPEG bytes of the
    same frames at q 95 (what the Motion-JPEG ``_det.avi`` held before),
    the PSNR (worst, mean) and the fresh writer's frames/s (one thread,
    encode and mux)."""
    import tempfile

    from viddet_tpu_torch.native import Mpeg4Decoder, encode_jpeg
    from viddet_tpu_torch.native.mp4 import Mp4Reader
    from viddet_tpu_torch.utils.video import VideoWriter

    h, w = vis[0].shape[:2]
    with Mp4Reader(path) as reader:
        index = reader.index
        check((index.frame_count, index.width, index.height, index.fps) == (len(vis), w, h, fps),
              f"{label}: {len(vis)} frames of {w}x{h} at {fps} fps")
        samples = [reader.sample(i) for i in range(len(reader))]
        config = index.config
    planes = []
    with tempfile.TemporaryDirectory() as tmp:
        fresh = os.path.join(tmp, os.path.basename(path))
        t = time.perf_counter()
        with VideoWriter(fresh, fps, (w, h)) as writer:
            for frame in vis:
                writer.write(frame)
                planes.append(writer.planes())
        writer_fps = len(vis) / (time.perf_counter() - t)
        with open(fresh, "rb") as a, open(path, "rb") as b:
            check(a.read() == b.read(), f"{label}: the bytes a fresh VideoWriter writes")
    decoder = Mpeg4Decoder(config, path)
    psnr = []
    for i, (sample, want) in enumerate(zip(samples, planes)):
        frame = decoder.decode(sample, f"{path} frame {i}")
        check(frame is not None, f"{label}: frame {i} shown at once (low_delay)")
        check(all(np.array_equal(a, b) for a, b in zip(decoder.planes(), want)),
              f"{label}: frame {i} decodes to the encoder's reconstruction")
        mse = np.mean((frame.astype(np.float64) - vis[i].astype(np.float64)) ** 2)
        psnr.append(99.0 if mse == 0 else float(10 * np.log10(255.0**2 / mse)))
    decoder.close()
    check(min(psnr) >= DRAWN_PSNR_DB,
          f"{label}: every frame's PSNR at least {DRAWN_PSNR_DB} dB (worst {min(psnr):.2f})")
    jpeg_bytes = sum(in_threads(lambda v: len(encode_jpeg(v, 95)), vis, ENCODE_WORKERS))
    return {"mp4_bytes": os.path.getsize(path), "mjpeg_q95_bytes": jpeg_bytes,
            "psnr_min_db": min(psnr), "psnr_mean_db": float(np.mean(psnr)),
            "fresh_writer_frames_per_s": writer_fps}


def frame_digest(a) -> str:
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def fixture_runs(dev, kernels, model, classes, predictor, fixture: str, frames, prefix: str,
                 out: dict) -> dict:
    """A committed video fixture's runs at the main path's model and batch
    8, its ``frames`` (RGB, display order) already held to OpenCV's
    digests: ``stream_detect_video`` drawn (``FrameSource``) and not drawn
    (``NativeFrameSource``), then ``cli.detect.main --input`` the file.
    Checks: each run's launches (``{prefix}_video``,
    ``{prefix}_video_native``, ``{prefix}_detect``), each batch through
    ``video_rows``, every saved line equal to the direct predictor's, the
    drawn ``clip_det.mp4`` (``check_drawn_mp4``), both sources' batches
    equal.  Into ``out``: the direct step's and each run's frames/s, the
    drawn file's check, the card's idle share over a native run.  Returns
    the launches."""
    import hashlib
    import tempfile

    import torch

    from viddet_tpu_torch.cli import detect
    from viddet_tpu_torch.data.transforms import ValTransform, invert_affine_to_boxes
    from viddet_tpu_torch.infer.service import to_device_batch
    from viddet_tpu_torch.infer.stream import stream_detect_video
    from viddet_tpu_torch.utils.image import draw_detections

    count = len(frames)
    transform = ValTransform((IMAGE_SIZE, IMAGE_SIZE), letterbox_resize=True, normalize=False)
    launches = {}
    frames_x = {"clip": np.stack([transform(f)[0] for f in frames])}
    affine = transform(frames[0])[2]
    lookup = {hashlib.sha1(x.tobytes()).digest(): ("clip", i)
              for i, x in enumerate(frames_x["clip"])}
    out["direct_frames_per_s"] = direct_frames_per_s(predictor, frames_x["clip"], dev)
    first = predictor(to_device_batch(frames_x["clip"][:VIDEO_B], VIDEO_B, dev))[1].cpu().numpy()
    thresh = out["thresh"] = float(np.median(first[:, VIDEO_BOXES - 1]))

    with tempfile.TemporaryDirectory() as tmp:
        clip = os.path.join(tmp, "clip" + os.path.splitext(fixture)[1])
        shutil.copyfile(fixture, clip)
        batches = -(-count // VIDEO_B)

        # drawn through FrameSource, then not drawn through NativeFrameSource
        runs, records = {}, {}
        drawn, native = f"{prefix}_video", f"{prefix}_video_native"
        for run, draw in ((drawn, True), (native, False)):
            records[run] = []
            set_launches(kernels)
            stats = stream_detect_video(clip, recorded(predictor, records[run]), transform,
                                        classes, output_dir=os.path.join(tmp, run),
                                        thresh=thresh, batch_size=VIDEO_B, draw=draw,
                                        save_detections=True, device=dev)
            launches[run] = path_batches(kernels, run, batches)
            check(stats["frames"] == count, f"{run}: every frame")
            runs[run] = stats["fps"]
        check(all(torch.equal(a[0], b[0]) for a, b in zip(records[drawn], records[native])),
              f"{prefix}: the native and thread sources give equal batches")
        rows = video_rows(model, predictor, records[drawn], lookup, frames_x, 1, drawn)
        check(sorted(rows) == [("clip", i) for i in range(count)], f"{prefix}: every frame once")
        want = video_lines(rows, "clip", range(count), affine, classes, thresh)
        for run in runs:
            with open(os.path.join(tmp, run, "clip_det.txt")) as f:
                check(f.read() == want, f"{run}: clip_det.txt equal to the direct predictor's")
        out["lines"] = len(want.splitlines())
        vis = [draw_detections(frames[i], invert_affine_to_boxes(rows[("clip", i)][2], affine),
                               rows[("clip", i)][0], rows[("clip", i)][1], classes, thresh)
               for i in range(count)]
        out["drawn"] = check_drawn_mp4(os.path.join(tmp, drawn, "clip_det.mp4"), vis,
                                       VIDEO_FPS, f"{prefix}: clip_det.mp4")
        out["window"] = window_idle_share(lambda: stream_detect_video(
            clip, predictor, transform, classes, output_dir=os.path.join(tmp, "idle"),
            batch_size=VIDEO_B, draw=False, device=dev))
        out["window"]["frames"] = count

        # the detect CLI over the file
        set_launches(kernels)
        t = time.perf_counter()
        done = detect.main(["--network", "yolo3_darknet53", "--dataset", "coco", "--input",
                            clip, "--output", os.path.join(tmp, "cli"), "--data-shape",
                            str(IMAGE_SIZE), "--batch-size", str(VIDEO_B), "--thresh",
                            str(thresh), "--save-detections", "--no-draw"],
                           built=(model, classes))
        runs[f"{prefix}_detect_cli"] = done / (time.perf_counter() - t)
        launches[f"{prefix}_detect"] = path_batches(kernels, f"{prefix}_detect", batches)
        check(done == count, f"detect: every frame of {os.path.basename(clip)}")
        with open(os.path.join(tmp, "cli", "clip_det.txt")) as f:
            check(f.read() == want, f"detect ({prefix}): clip_det.txt equal to the direct "
                                    "predictor's")
        out["frames_per_s"] = runs
    return launches


def mpeg4_bvop_phase(dev, kernels, model, classes, predictor) -> dict:
    """MPEG-4 Part 2 with B-VOPs in an AVI: the committed 640x480 ``XVID``
    fixture (48 frames, 25 fps, two B-VOPs between references, made by the
    wheel's libavcodec, ``tests/fixtures/make_mp4_fixture.py``) decoded in
    display order to the SHA-256 of each Y plane and RGB frame that
    OpenCV's FFmpeg gave; then, with the main path's model at batch 8,
    ``stream_detect_video`` over it drawn (``FrameSource``) and not drawn
    (``NativeFrameSource``) and ``cli.detect.main --input clip.avi``.
    Checks: each run's launches, each batch through ``video_rows``, every
    saved line equal to the direct predictor's, both sources' batches
    equal.  Frames/s: the reader on one host thread (demux + decode + RGB,
    decode + RGB, decode alone), each run beside the direct step; the
    card's idle share over a native run.  Then the quarter-sample XviD
    fixture (``xvid_qpel_640x480.avi``: ``+qpel+mv4``, two B-VOPs between
    references, XviD's user data, so the XviD IDCT) decoded to its digests,
    its decoder's frames/s on one host thread, and one not-drawn
    ``stream_detect_video`` over it (``fixture_native_run``); ``qpel.extra_s``
    is what that part adds to the phase."""
    from viddet_tpu_torch.utils.video import iterate_frames, probe_video

    t_phase = time.perf_counter()
    out = {"phase": "mpeg4_bvop", "model": MODEL, "size": IMAGE_SIZE, "batch": VIDEO_B,
           "fixture": os.path.relpath(BVOP_FIXTURE, os.path.dirname(os.path.abspath(__file__))),
           "nvidia_smi": nvidia_smi_line()}  # the card of this child's rates

    # 1. the fixture, decoded in display order to OpenCV's digests
    info = probe_video(BVOP_FIXTURE)
    check(info == {"fps": float(VIDEO_FPS), "frame_count": BVOP_FRAMES, "width": CODEC_W,
                   "height": CODEC_H}, f"the B-VOP fixture probes as written: {info}")
    config, fourcc, samples, types, frames, _ = mpeg4_fixture_frames(
        BVOP_FIXTURE, BVOP_DIGESTS, BVOP_FRAMES, "bvop")
    check(types.count("B") >= 16, f"the fixture has B-VOPs: {types}")
    out.update(digests_equal=BVOP_FRAMES, types=types)
    rates = {}
    t = time.perf_counter()
    check(sum(1 for _ in iterate_frames(BVOP_FIXTURE)) == BVOP_FRAMES, "iterate_frames: 48")
    rates["demux_decode_rgb"] = BVOP_FRAMES / (time.perf_counter() - t)
    rates.update(mpeg4_decode_rates(config, fourcc, samples, BVOP_FRAMES))
    out["reader_frames_per_s"] = rates  # one host thread

    launches = fixture_runs(dev, kernels, model, classes, predictor, BVOP_FIXTURE, frames,
                            "bvop", out)

    # 2. the quarter-sample XviD fixture: its digests, and one not-drawn run
    t_qpel = time.perf_counter()
    qpel = out["qpel"] = {"fixture": os.path.relpath(
        QPEL_FIXTURE, os.path.dirname(os.path.abspath(__file__)))}
    info = probe_video(QPEL_FIXTURE)
    check(info == {"fps": float(VIDEO_FPS), "frame_count": QPEL_FRAMES, "width": CODEC_W,
                   "height": CODEC_H}, f"the qpel fixture probes as written: {info}")
    config, fourcc, samples, types, frames, stream = mpeg4_fixture_frames(
        QPEL_FIXTURE, QPEL_DIGESTS, QPEL_FRAMES, "qpel")
    check(fourcc == "XVID" and QPEL_USER_DATA in config,
          f"the qpel fixture is an XVID AVI with XviD's user data ({fourcc})")
    check(types.count("B") >= 16, f"the qpel fixture has B-VOPs: {types}")
    check(stream["quarter_sample"] and stream["xvid_build"] == 50 and stream["idct"] == "xvid"
          and stream["lavc_build"] is None,
          f"the qpel fixture decodes as XviD's quarter-sample stream: {stream}")
    qpel.update(digests_equal=QPEL_FRAMES, types=types, stream=stream,
                reader_frames_per_s=mpeg4_decode_rates(config, fourcc, samples, QPEL_FRAMES))
    launches.update(fixture_native_run(dev, kernels, model, classes, predictor, frames, qpel,
                                       QPEL_FIXTURE, "qpel_video_native"))
    qpel["extra_s"] = time.perf_counter() - t_qpel
    out.update(all_equal_direct=True, phase_s=time.perf_counter() - t_phase)
    emit(out)
    return launches


def mpeg4_fixture_frames(path: str, digests_path: str, count: int, what: str):
    """An MPEG-4 AVI fixture decoded in display order, each frame's Y plane
    and RGB held to OpenCV's digests.  Returns (config, fourcc, samples,
    VOP types, RGB frames, the decoder's ``stream_info``)."""
    import json

    from viddet_tpu_torch.native import Mpeg4Decoder
    from viddet_tpu_torch.native.avi import AviReader

    with open(digests_path) as f:
        digests = json.load(f)["frames"]
    with AviReader(path) as reader:
        check(reader.index.codec == "mpeg4", f"the {what} fixture is MPEG-4 Part 2")
        config, fourcc = reader.index.config, reader.index.fourcc
        samples = [reader.sample(i) for i in range(len(reader))]
    types = "".join("IPBS"[s[s.find(b"\x00\x00\x01\xb6") + 4] >> 6] for s in samples)
    decoder = Mpeg4Decoder(config, path, fourcc)
    frames = []
    for sample in samples + [None]:
        frame = decoder.decode(sample) if sample is not None else decoder.flush()
        if frame is None:
            continue
        i = len(frames)
        check(i < count and frame_digest(decoder.planes()[0]) == digests[i]["y"],
              f"{what} frame {i}: the Y plane's digest is OpenCV's")
        check(frame_digest(frame) == digests[i]["rgb"],
              f"{what} frame {i}: the RGB digest is OpenCV's")
        frames.append(frame)
    stream = decoder.stream_info
    decoder.close()
    check(len(frames) == count, f"the {what} fixture shows {len(frames)} frames")
    return config, fourcc, samples, types, frames, stream


def mpeg4_decode_rates(config: bytes, fourcc: str, samples, count: int) -> dict:
    """Frames a second of the decoder on one host thread over ``samples``:
    decode + RGB, and decode alone."""
    from viddet_tpu_torch.native import Mpeg4Decoder

    rates = {}
    for what, rgb in (("decode_rgb", True), ("decode", False)):
        decoder = Mpeg4Decoder(config, fourcc=fourcc)
        t = time.perf_counter()
        for sample in samples:
            decoder.decode(sample, rgb=rgb)
        decoder.flush(rgb=rgb)
        rates[what] = count / (time.perf_counter() - t)
        decoder.close()
    return rates


def fixture_native_run(dev, kernels, model, classes, predictor, frames, out: dict,
                       fixture: str, run: str, idle: bool = False) -> dict:
    """One not-drawn ``stream_detect_video`` over a committed fixture
    (``NativeFrameSource``; ``frames`` its RGB frames, already held to
    OpenCV's digests) with the main path's model at batch 8: its launches
    (one hierarchical tail a batch, as ``run``), each batch through
    ``video_rows`` and every saved line equal to the direct predictor's.
    Into ``out``: the run's frames/s and the direct step's, and with
    ``idle`` the card's idle share over another such run.  Returns the
    launches."""
    import hashlib
    import tempfile

    from viddet_tpu_torch.data.transforms import ValTransform
    from viddet_tpu_torch.infer.service import to_device_batch
    from viddet_tpu_torch.infer.stream import stream_detect_video

    count = len(frames)
    transform = ValTransform((IMAGE_SIZE, IMAGE_SIZE), letterbox_resize=True, normalize=False)
    frames_x = {"clip": np.stack([transform(f)[0] for f in frames])}
    affine = transform(frames[0])[2]
    lookup = {hashlib.sha1(x.tobytes()).digest(): ("clip", i)
              for i, x in enumerate(frames_x["clip"])}
    out["direct_frames_per_s"] = direct_frames_per_s(predictor, frames_x["clip"], dev)
    first = predictor(to_device_batch(frames_x["clip"][:VIDEO_B], VIDEO_B, dev))[1].cpu().numpy()
    thresh = out["thresh"] = float(np.median(first[:, VIDEO_BOXES - 1]))
    with tempfile.TemporaryDirectory() as tmp:
        clip = os.path.join(tmp, "clip" + os.path.splitext(fixture)[1])
        shutil.copyfile(fixture, clip)
        record = []
        set_launches(kernels)
        stats = stream_detect_video(clip, recorded(predictor, record), transform, classes,
                                    output_dir=os.path.join(tmp, run), thresh=thresh,
                                    batch_size=VIDEO_B, draw=False, save_detections=True,
                                    device=dev)
        launches = {run: path_batches(kernels, run, -(-count // VIDEO_B))}
        check(stats["frames"] == count, f"{run}: every frame")
        rows = video_rows(model, predictor, record, lookup, frames_x, 1, run)
        check(sorted(rows) == [("clip", i) for i in range(count)], f"{run}: every frame once")
        want = video_lines(rows, "clip", range(count), affine, classes, thresh)
        with open(os.path.join(tmp, run, "clip_det.txt")) as f:
            check(f.read() == want, f"{run}: clip_det.txt equal to the direct predictor's")
        out.update(lines=len(want.splitlines()), frames_per_s=stats["fps"])
        if idle:
            out["window"] = window_idle_share(lambda: stream_detect_video(
                clip, predictor, transform, classes, output_dir=os.path.join(tmp, "idle"),
                batch_size=VIDEO_B, draw=False, device=dev))
            out["window"]["frames"] = count
    return launches


def webm_phase(dev, kernels, model, classes, predictor) -> dict:
    """VP8 in WebM: the committed 640x480 fixture (48 shown frames at 25
    fps and 3 hidden alt-ref frames, key and inter frames, split vectors,
    golden and alt-ref references, four token partitions; made by the
    wheel's libavcodec, ``tests/fixtures/make_mp4_fixture.py``) decoded to
    the SHA-256 of each Y plane and RGB frame that OpenCV's FFmpeg gave;
    then ``fixture_runs`` over it (``webm_video``, ``webm_video_native``,
    ``webm_detect``).  Frames/s: the reader on one host thread (demux +
    decode + RGB, decode + RGB, decode alone), each run beside the direct
    step; the card's idle share over a native run.  Then VP9 in WebM
    (``vp9``): the committed 640x480 VP9 fixture decoded to its digests, its
    reader's rates, and one not-drawn run (``vp9_video_native``) with the
    card's idle share over another; ``vp9.extra_s`` is what it adds.  Then
    H.264 in MP4 (``h264``, CAVLC) the same way (``h264_video_native``),
    High profile H.264 in Matroska (``h264_cabac``: CABAC, the 8x8
    transform, scaling lists; ``h264_cabac_video_native``), and B-frame
    H.264 in MP4 (``h264_bframes``: a B pyramid, direct and weighted
    prediction, FFmpeg's output order; ``h264_bframes_video_native``)."""
    import json

    from viddet_tpu_torch.native import Vp8Decoder
    from viddet_tpu_torch.native.mkv import MkvReader
    from viddet_tpu_torch.utils.video import iterate_frames, probe_video

    t_phase = time.perf_counter()
    out = {"phase": "webm", "model": MODEL, "size": IMAGE_SIZE, "batch": VIDEO_B,
           "fixture": os.path.relpath(WEBM_FIXTURE, os.path.dirname(os.path.abspath(__file__))),
           "nvidia_smi": nvidia_smi_line()}  # the card of this child's rates

    # 1. the fixture, decoded to OpenCV's digests
    with open(WEBM_DIGESTS) as f:
        digests = json.load(f)["frames"]
    info = probe_video(WEBM_FIXTURE)
    check(info == {"fps": float(VIDEO_FPS), "frame_count": WEBM_FRAMES, "width": CODEC_W,
                   "height": CODEC_H}, f"the WebM fixture probes as written: {info}")
    with MkvReader(WEBM_FIXTURE) as reader:
        check(reader.index.codec == "vp8", "the WebM fixture is VP8")
        samples = [reader.sample(i) for i in range(len(reader.index.offsets))]
    decoder = Vp8Decoder(WEBM_FIXTURE)
    frames = []
    for sample in samples:
        frame = decoder.decode(sample)
        if frame is None:
            continue
        i = len(frames)
        check(i < WEBM_FRAMES and frame_digest(decoder.planes()[0]) == digests[i]["y"],
              f"webm frame {i}: the Y plane's digest is OpenCV's")
        check(frame_digest(frame) == digests[i]["rgb"], f"webm frame {i}: the RGB digest is "
                                                        "OpenCV's")
        frames.append(frame)
    features = decoder.features
    decoder.close()
    check(len(frames) == WEBM_FRAMES, f"the WebM fixture shows {len(frames)} frames")
    need = {"split vectors", "golden reference", "alt-ref reference", "hidden frame",
            "token partitions"}
    check(need <= features, f"the WebM fixture uses {sorted(need - features)}")
    out.update(digests_equal=WEBM_FRAMES, samples=len(samples), features=sorted(features))
    rates = {}
    t = time.perf_counter()
    check(sum(1 for _ in iterate_frames(WEBM_FIXTURE)) == WEBM_FRAMES, "iterate_frames: 48")
    rates["demux_decode_rgb"] = WEBM_FRAMES / (time.perf_counter() - t)
    for what, rgb in (("decode_rgb", True), ("decode", False)):
        decoder = Vp8Decoder()
        t = time.perf_counter()
        for sample in samples:
            decoder.decode(sample, rgb=rgb)
        rates[what] = WEBM_FRAMES / (time.perf_counter() - t)
        decoder.close()
    out["reader_frames_per_s"] = rates  # one host thread

    launches = fixture_runs(dev, kernels, model, classes, predictor, WEBM_FIXTURE, frames,
                            "webm", out)
    launches.update(vp9_part(dev, kernels, model, classes, predictor, out))
    for kind in ("h264", "h264_cabac", "h264_bframes"):
        launches.update(h264_part(dev, kernels, model, classes, predictor, out, kind))
    out.update(all_equal_direct=True, phase_s=time.perf_counter() - t_phase)
    emit(out)
    return launches


def vp9_part(dev, kernels, model, classes, predictor, phase_out: dict) -> dict:
    """The VP9 fixture: probed, decoded (superframes, hidden frames) to the
    SHA-256 of each Y plane and RGB frame OpenCV's FFmpeg gave, the reader's
    frames/s on one host thread (demux + decode + RGB, decode + RGB, decode
    alone), then ``fixture_native_run`` (``vp9_video_native``) with the
    card's idle share.  Into ``phase_out["vp9"]``.  Returns the launches."""
    import json

    from viddet_tpu_torch.native import Vp9Decoder
    from viddet_tpu_torch.native.mkv import MkvReader
    from viddet_tpu_torch.utils.video import iterate_frames, probe_video

    t_part = time.perf_counter()
    out = phase_out["vp9"] = {"fixture": os.path.relpath(
        VP9_FIXTURE, os.path.dirname(os.path.abspath(__file__)))}
    with open(VP9_DIGESTS) as f:
        digests = json.load(f)["frames"]
    info = probe_video(VP9_FIXTURE)
    check(info == {"fps": float(VIDEO_FPS), "frame_count": VP9_FRAMES, "width": CODEC_W,
                   "height": CODEC_H}, f"the VP9 fixture probes as written: {info}")
    with MkvReader(VP9_FIXTURE) as reader:
        check(reader.index.codec == "vp9", "the VP9 fixture is VP9")
        samples = [reader.sample(i) for i in range(len(reader.index.offsets))]
    decoder = Vp9Decoder(VP9_FIXTURE)
    frames = []
    for sample in samples:
        frame = decoder.decode(sample)
        if frame is None:
            continue
        i = len(frames)
        check(i < VP9_FRAMES and frame_digest(decoder.planes()[0]) == digests[i]["y"],
              f"vp9 frame {i}: the Y plane's digest is OpenCV's")
        check(frame_digest(frame) == digests[i]["rgb"], f"vp9 frame {i}: the RGB digest is "
                                                        "OpenCV's")
        frames.append(frame)
    features = decoder.features
    decoder.close()
    check(len(frames) == VP9_FRAMES, f"the VP9 fixture shows {len(frames)} frames")
    need = {"superframe", "hidden frame", "compound prediction", "tile columns",
            "probability adaptation"}
    check(need <= features, f"the VP9 fixture uses {sorted(need - features)}")
    out.update(digests_equal=VP9_FRAMES, samples=len(samples), features=sorted(features))
    rates = {}
    t = time.perf_counter()
    check(sum(1 for _ in iterate_frames(VP9_FIXTURE)) == VP9_FRAMES, "vp9 iterate_frames: 48")
    rates["demux_decode_rgb"] = VP9_FRAMES / (time.perf_counter() - t)
    for what, rgb in (("decode_rgb", True), ("decode", False)):
        decoder = Vp9Decoder()
        t = time.perf_counter()
        for sample in samples:
            decoder.decode(sample, rgb=rgb)
        rates[what] = VP9_FRAMES / (time.perf_counter() - t)
        decoder.close()
    out["reader_frames_per_s"] = rates  # one host thread
    launches = fixture_native_run(dev, kernels, model, classes, predictor, frames, out,
                                  VP9_FIXTURE, "vp9_video_native", idle=True)
    out["extra_s"] = time.perf_counter() - t_part
    return launches


H264_PARTS = {  # fixture, digests, what each holds beyond I / P basics
    "h264": (H264_FIXTURE, H264_DIGESTS, {"intra 4x4", "P 16x16", "skipped macroblocks"}),
    "h264_cabac": (H264_CABAC_FIXTURE, H264_CABAC_DIGESTS,
                   {"CABAC", "8x8 transform", "intra 8x8", "PPS scaling matrices",
                    "default scaling lists", "scaling fall-back", "P 16x16",
                    "skipped macroblocks"}),
    "h264_bframes": (H264_BFRAMES_FIXTURE, H264_BFRAMES_DIGESTS,
                     {"CABAC", "8x8 transform", "B slices", "spatial direct", "temporal direct",
                      "explicit weights", "implicit weights", "reference B pictures",
                      "reordered output", "bi-prediction", "B_Skip", "bitstream restriction"}),
}


def h264_part(dev, kernels, model, classes, predictor, phase_out: dict, key: str) -> dict:
    """An H.264 fixture of ``H264_PARTS``: the MP4 (CAVLC I and P pictures),
    the Matroska file (CABAC, the 8x8 transform, intra 8x8, PPS scaling
    lists) or the B-frame MP4 (a CABAC B pyramid, spatial and temporal
    direct, explicit and implicit weights, pictures reordered); two slices a
    picture, the loop filter on.  Probed, decoded (its last pictures flushed)
    to the SHA-256 of each Y plane and RGB frame OpenCV's FFmpeg gave, the
    reader's frames/s on one host thread (demux + decode + RGB, decode + RGB,
    decode alone), then ``fixture_native_run`` (``{key}_video_native``) with
    the card's idle share.  Into ``phase_out[key]``.  Returns the
    launches."""
    import json

    from viddet_tpu_torch.native import H264Decoder
    from viddet_tpu_torch.utils.video import iterate_frames, open_video, probe_video

    t_part = time.perf_counter()
    fixture, digest_file, need = H264_PARTS[key]
    out = phase_out[key] = {"fixture": os.path.relpath(
        fixture, os.path.dirname(os.path.abspath(__file__)))}
    with open(digest_file) as f:
        digests = json.load(f)["frames"]
    info = probe_video(fixture)
    check(info == {"fps": float(VIDEO_FPS), "frame_count": H264_FRAMES, "width": CODEC_W,
                   "height": CODEC_H}, f"the {key} fixture probes as written: {info}")
    with open_video(fixture) as reader:
        check(reader.index.codec == "h264", f"the {key} fixture is H.264")
        config, reorder = reader.index.config, reader.index.reorder
        samples = [reader.sample(i) for i in range(len(reader.index.offsets))]
    decoder = H264Decoder(config, fixture, reorder)
    frames = []
    for sample in samples + [None]:
        frame = decoder.decode(sample) if sample is not None else decoder.flush()
        while frame is not None:
            i = len(frames)
            check(i < H264_FRAMES and frame_digest(decoder.planes()[0]) == digests[i]["y"],
                  f"{key} frame {i}: the Y plane's digest is OpenCV's")
            check(frame_digest(frame) == digests[i]["rgb"], f"{key} frame {i}: the RGB digest "
                                                            "is OpenCV's")
            frames.append(frame)
            frame = decoder.flush() if sample is None else None
    features = decoder.features
    decoder.close()
    check(len(frames) == H264_FRAMES, f"the {key} fixture shows {len(frames)} frames")
    need = need | {"IDR picture", "P slices", "intra 16x16", "several slices"}
    check(need <= features, f"the {key} fixture uses {sorted(need - features)}")
    out.update(digests_equal=H264_FRAMES, samples=len(samples), reorder=reorder,
               features=sorted(features))
    rates = {}
    t = time.perf_counter()
    check(sum(1 for _ in iterate_frames(fixture)) == H264_FRAMES, f"{key} iterate_frames: 48")
    rates["demux_decode_rgb"] = H264_FRAMES / (time.perf_counter() - t)
    for what, rgb in (("decode_rgb", True), ("decode", False)):
        decoder = H264Decoder(config, fixture, reorder)
        t = time.perf_counter()
        for sample in samples:
            decoder.decode(sample, rgb=rgb)
        while decoder.flush(rgb=rgb) is not None:
            pass
        rates[what] = H264_FRAMES / (time.perf_counter() - t)
        decoder.close()
    out["reader_frames_per_s"] = rates  # one host thread
    launches = fixture_native_run(dev, kernels, model, classes, predictor, frames, out,
                                  fixture, f"{key}_video_native", idle=True)
    out["extra_s"] = time.perf_counter() - t_part
    return launches


# ---------------------------------------------------------------------------
# Phase 17: train
# ---------------------------------------------------------------------------

# The JAX fixture: tiny YOLOv3, 3 classes, 64 px, float32, three steps on
# one batch with two colliding boxes (tests/test_torch_train_fixture.py
# writes it on the CPU).  The card is held to its losses and to a seeded
# sample of every parameter and statistic after step 3.
TRAIN_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures",
                             "jax_train_steps.npz")
TRAIN_LOSS_NAMES = ("obj", "center", "scale", "cls", "total")
TRAIN_LOSS_RTOL, TRAIN_LEAF_REL_L2 = 1e-4, 1e-3
# Full width: the main path's model trained by cli.train_yolov3.main on
# --dataset synthetic (64 images: one batch an epoch) at the CLI's batch 64,
# multi-scale and mixup on, 4 loader workers, validated once at the end;
# then one step alone at each of TRAIN_SIZES and the overfit of one batch.
TRAIN_B, TRAIN_EPOCHS, TRAIN_PROFILE_STEPS = 64, 20, 3
TRAIN_SIZES = (320, 608)
TRAIN_OVERFIT_STEPS = 40
# Kernel-name substrings of a training step's groups, tried in order.
TRAIN_KERNEL_GROUPS = (
    ("conv_backward", ("dgrad", "wgrad", "bprop")),
    ("convolution", ("conv", "gemm", "xmma", "cutlass", "sm90", "implicit", "winograd")),
    ("batch_norm", ("batch_norm",)),
    ("optimizer", ("foreach", "multi_tensor")),
    ("reduce", ("reduce", "Reduce")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "leaky", "pad", "copy",
                     "cat", "upsample", "CatArray", "scatter", "index", "where")),
)


def leaf_digest(model) -> str:
    """SHA-256 of every parameter and statistic's bytes, in the ``.npz``
    schema's order: equal digests, bit-identical replicas."""
    import hashlib

    from viddet_tpu_torch.weights import leaves

    h = hashlib.sha256()
    for key, t, _ in leaves(model):
        h.update(key.encode())
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def train_fixture_run(dev) -> dict:
    """The fixture's case on ``dev`` in float32, with TF32 off for the
    check: targets of the batch, the five losses of each step, and each
    leaf's sampled elements after the last step against the fixture's;
    the digest of the leaves after each step.  Under a process group each
    process steps on its rows of the batch (``shard_batch``): the losses
    are then the global batch's."""
    import torch

    from viddet_tpu_torch.core.precision import FLOAT32_POLICY
    from viddet_tpu_torch.models.yolo3 import YOLOv3
    from viddet_tpu_torch.parallel.mesh import shard_batch
    from viddet_tpu_torch.train.loop import make_train_step
    from viddet_tpu_torch.train.state import TrainState, make_lr_schedule, make_optimizer
    from viddet_tpu_torch.train.targets import assign_targets
    from viddet_tpu_torch.weights import load_flat, seeded_flat, to_flat

    with np.load(TRAIN_FIXTURE) as f:
        fx = {k: f[k] for k in f.files}
    anchors = tuple(tuple((float(w), float(h)) for w, h in scale) for scale in fx["anchors"])
    strides = tuple(int(s) for s in fx["strides"])
    num_classes, size = int(fx["num_classes"]), fx["images"].shape[1]
    model = YOLOv3(num_classes=num_classes, backbone="tiny", anchors=anchors, strides=strides,
                   policy=FLOAT32_POLICY).to(dev, memory_format=torch.channels_last)
    load_flat(model, seeded_flat(model, int(fx["weights_seed"])))
    state = TrainState(model, make_optimizer(make_lr_schedule(float(fx["lr"]), 1),
                                             momentum=float(fx["momentum"]),
                                             weight_decay=float(fx["weight_decay"])))
    step = make_train_step(strides=strides, anchors=anchors, num_classes=num_classes)
    images, boxes, ids = (torch.from_numpy(fx[k]).to(dev) for k in ("images", "gt_boxes", "gt_ids"))
    targets = assign_targets(boxes, ids, None, image_size=(size, size), strides=strides,
                             anchors=anchors, num_classes=num_classes)
    targets_equal = {k: bool(np.array_equal(v.cpu().numpy(), fx[f"targets/{k}"]))
                     for k, v in targets.items()}
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        losses, digests = [], []
        for _ in range(int(fx["steps"])):
            _, out = step(state, *(shard_batch(t) for t in (images, boxes, ids)))
            losses.append([float(out[k]) for k in TRAIN_LOSS_NAMES])
            digests.append(leaf_digest(model))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    losses = np.asarray(losses)
    loss_rel = np.abs(losses - fx["losses"]) / np.abs(fx["losses"])
    flat = to_flat(model)
    leaf_rel = {}
    for key in sorted(k[len("leaf_index/"):] for k in fx if k.startswith("leaf_index/")):
        got = flat[key].reshape(-1)[fx[f"leaf_index/{key}"]].astype(np.float64)
        want = fx[f"leaf_sample/{key}"].astype(np.float64)
        leaf_rel[key] = float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))
    worst = max(leaf_rel, key=leaf_rel.get)
    return {"targets_equal": targets_equal, "losses": losses.tolist(),
            "loss_max_rel": float(loss_rel.max()), "loss_max_rel_step1": float(loss_rel[0].max()),
            "leaves": len(leaf_rel), "leaf_max_rel_l2": leaf_rel[worst], "leaf_worst": worst,
            "leaf_median_rel_l2": float(np.median(list(leaf_rel.values()))), "digests": digests}


def trace_idle_share(path: str) -> dict:
    """The card's busy time (kernels, copies, fills; overlaps counted once)
    over the span of a torch.profiler chrome trace, and the idle share."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    check(bool(spans), "the training trace holds device work")
    busy, end = 0.0, -float("inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    start = min(e["ts"] for e in events)
    stop = max(e["ts"] + e.get("dur", 0) for e in events)
    return {"window_ms": (stop - start) / 1e3, "device_busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / (stop - start), "kernels": len(spans)}


def train_batch(dev, size: int, b: int, seed: int):
    """A fixed training batch at ``size`` px: synthetic images (the CLI's
    dataset) through the validation resize, uint8, GT padded to 100."""
    import torch

    from viddet_tpu_torch.data.loader import pad_label
    from viddet_tpu_torch.data.synthetic import SyntheticDetection
    from viddet_tpu_torch.data.transforms import ValTransform

    ds = SyntheticDetection(num_images=b, size=256, num_classes=4, seed=seed)
    tf = ValTransform(size=(size, size), normalize=False)
    images, labels = [], []
    for i in range(b):
        x, label, _ = tf(*ds[i])
        images.append(x)
        labels.append(pad_label(label))
    labels = np.stack(labels)
    return (torch.from_numpy(np.stack(images)).to(dev),
            torch.from_numpy(labels[:, :, :4].copy()).to(dev),
            torch.from_numpy(labels[:, :, 4].astype(np.int32)).to(dev))


def step_phases(state, step_parts, batch) -> dict:
    """Device time of each part of one train step by kernel group: the
    step runs once under torch.profiler with a spin kernel between its parts
    (forward, loss with the targets, backward, optimizer), so each kernel
    falls between two spins on the one stream."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    names = ("forward", "loss_and_targets", "backward", "optimizer")
    for _ in range(2):  # warm
        step_parts(state, batch, lambda: None)
    torch.cuda.synchronize()

    def marker():
        torch.cuda._sleep(SPIN_CYCLES_PER_MS // 1000)

    for _ in range(PROFILER_WINDOWS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(WINDOW_OPENERS):
                marker()
            torch.cuda.synchronize()
            marker()
            step_parts(state, batch, marker)
            marker()
            torch.cuda.synchronize()
        kernels = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                         key=lambda e: e.time_range.start)
        spins = [i for i, e in enumerate(kernels) if "spin_kernel" in e.name]
        if len(spins) >= len(names) + 1:
            break
        INCOMPLETE_WINDOWS.append(dict(names=["train step parts"], spins=len(spins)))
        time.sleep(PROFILER_RETRY_PAUSE_S)
    else:
        raise RuntimeError(f"check failed: no complete profiler window of a train step in "
                           f"{PROFILER_WINDOWS}: {INCOMPLETE_WINDOWS[-PROFILER_WINDOWS:]}")
    bounds = spins[-(len(names) + 1):]
    out = {}
    for name, lo, hi in zip(names, bounds, bounds[1:]):
        groups: dict = {}
        for e in kernels[lo + 1:hi]:
            group = next((g for g, subs in TRAIN_KERNEL_GROUPS if any(x in e.name for x in subs)),
                         "other")
            groups[group] = groups.get(group, 0.0) + e.time_range.elapsed_us() / 1e3
        out[name] = {"device_ms": sum(groups.values()), "kernels": hi - lo - 1,
                     "groups": groups}
    return out


def waits_for_card(step) -> list:
    """The operations of one ``step()`` that wait for the card, as torch's
    synchronisation debug mode reports them."""
    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as waits:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return [str(w.message)[:200] for w in waits if "called a synchronizing" in str(w.message)]


def train_phase(dev, kernels) -> dict:
    """The training slice on the card (see the module docstring, phase 16)."""
    import tempfile

    import torch

    from viddet_tpu_torch.models.zoo import get_model

    from viddet_tpu_torch.cli import train_yolov3
    from viddet_tpu_torch.cli.common import get_dataset
    from viddet_tpu_torch.models.yolo3 import flatten_outputs
    from viddet_tpu_torch.ops.nms import multiclass_nms_late_decode_cells
    from viddet_tpu_torch.train.loop import _maybe_normalize, make_train_step
    from viddet_tpu_torch.train.losses import yolo_loss
    from viddet_tpu_torch.train.state import (
        TrainState, latest_checkpoint, load_weights_npz, make_lr_schedule, make_optimizer,
    )
    from viddet_tpu_torch.weights import init_flat, load_flat, to_flat

    t_phase = time.perf_counter()
    smi = nvidia_smi_line()
    fixture = train_fixture_run(dev)
    check(all(fixture["targets_equal"].values()), f"targets equal the fixture's: {fixture}")
    check(fixture["loss_max_rel"] <= TRAIN_LOSS_RTOL, f"losses within {TRAIN_LOSS_RTOL}: {fixture}")
    check(fixture["leaf_max_rel_l2"] <= TRAIN_LEAF_REL_L2,
          f"leaves within {TRAIN_LEAF_REL_L2}: {fixture}")
    emit({"phase": "train_fixture", "nvidia_smi": smi,
          "model": "yolo3_tiny_darknet (3 classes, 64 px)", "dtype": "float32", "tf32": False,
          **fixture})

    # -- full width through the CLI ----------------------------------------
    model, classes = get_model(MODEL)
    load_flat(model, init_flat(MODEL, seed=0))
    anchors, strides = model.head.anchors, model.head.strides
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "y3")
        jsonl = os.path.join(tmp, "metrics.jsonl")
        argv = ["--platform", "gpu" if dev.type == "cuda" else "cpu",
                "--dataset", "synthetic", "--data-root", "synthetic",
                "--data-shape", str(IMAGE_SIZE),
                "--batch-size", str(TRAIN_B), "--epochs", str(TRAIN_EPOCHS),
                "--mixup", "--no-mixup-epochs", str(TRAIN_EPOCHS // 4),
                "--num-workers", "4", "--log-interval", "1",
                "--val-interval", str(TRAIN_EPOCHS), "--save-interval", "0",
                "--profile", str(TRAIN_PROFILE_STEPS), "--metrics-jsonl", jsonl,
                "--save-prefix", prefix]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        set_launches(kernels)
        t0 = time.perf_counter()
        train_yolov3.main(argv, built=(model, classes))
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        val_launches = read_launches(kernels, HIER_LAUNCHES, "train CLI (its validation batch)")
        cli_peak = torch.cuda.max_memory_allocated() / 2**30
        with open(jsonl) as f:
            records = [json.loads(line) for line in f]
        steps = TRAIN_EPOCHS * (len(get_dataset("synthetic", "synthetic")[0]) // TRAIN_B)
        check(len(records) == steps, f"{steps} metric records, got {len(records)}")
        check(all(np.isfinite(r[k]) for r in records for k in TRAIN_LOSS_NAMES),
              "every logged loss finite")
        idle = trace_idle_share(os.path.join(f"{prefix}_trace", "trace.json"))
        ckpt = latest_checkpoint(f"{prefix}_ckpt")
        check(ckpt is not None and ckpt.endswith(f"step_{steps:08d}"),
              f"the last checkpoint is step {steps}: {ckpt}")
        final = load_weights_npz(f"{prefix}_final.npz")
        load_flat(model, final)  # the file loads back into the model
        check(all(np.array_equal(v, final[k]) for k, v in to_flat(model).items()),
              "_final.npz loads back through weights.load_flat")
        check(os.path.exists(f"{prefix}_best.npz"), "_best.npz written at the validation")

    # the validation batch's head outputs through the kernel and plain tails
    from viddet_tpu_torch.data.loader import DetectionLoader
    from viddet_tpu_torch.data.transforms import ValTransform
    from viddet_tpu_torch.infer.service import to_device_batch

    val_ds, _ = get_dataset("synthetic", "synthetic", split="val")
    images = next(iter(DetectionLoader(val_ds, ValTransform(size=(IMAGE_SIZE, IMAGE_SIZE)),
                                       batch_size=TRAIN_B, num_workers=0)))[0]
    model.eval()
    with torch.inference_mode():
        out = model(to_device_batch(images, TRAIN_B, dev))
        tails = [multiclass_nms_late_decode_cells(out["raws_cells"], out["meta"], backend=b)
                 for b in ("auto", "plain")]
    check(all(equal(a, b) for a, b in zip(*tails)), "validation: kernel tail equal to plain tail")
    del out, tails
    model.train()

    # -- one step alone per size; the breakdown at the CLI's 416 -----------
    load_flat(model, init_flat(MODEL, seed=0))
    state = TrainState(model, make_optimizer(make_lr_schedule(1e-3, 1)))
    step = make_train_step(strides=strides, anchors=anchors, num_classes=len(classes))
    alone = {}
    for size in TRAIN_SIZES:
        batch = train_batch(dev, size, TRAIN_B, seed=size)
        for _ in range(2):
            step(state, *batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = median_ms(lambda: step(state, *batch), reps=5, warmup=0)
        alone[str(size)] = {"ms": ms, "samples_per_s": TRAIN_B / ms * 1e3,
                            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
        del batch

    def step_parts(st, batch, mark):
        images, boxes, ids = batch
        x = _maybe_normalize(images)
        outputs = flatten_outputs(st.model.train()(x))
        mark()
        losses = yolo_loss(outputs, boxes, ids, None, image_size=x.shape[1:3], strides=strides,
                           anchors=anchors, num_classes=len(classes))
        mark()
        st.zero_grad()
        losses["total"].backward()
        mark()
        st.apply_gradients()

    batch = train_batch(dev, IMAGE_SIZE, TRAIN_B, seed=IMAGE_SIZE)
    breakdown = step_phases(state, step_parts, batch)
    step_ms = median_ms(lambda: step(state, *batch), reps=5)
    busy = sum(p["device_ms"] for p in breakdown.values())
    # no operation of the step waits for the card (a copy from pageable
    # memory, an .item(), a data-dependent shape)
    waits = waits_for_card(lambda: step(state, *batch))
    check(not waits, f"the train step waits for the card: {waits}")

    # -- overfit one batch, with K8 routable: training must not launch it --
    load_flat(model, init_flat(MODEL, seed=0))
    state = TrainState(model, make_optimizer(make_lr_schedule(1e-3, 1)))
    os.environ["VIDDET_CONV_BACKEND"] = "pallas"
    try:
        set_launches(kernels)
        totals = [float(step(state, *batch)[1]["total"]) for _ in range(TRAIN_OVERFIT_STEPS)]
        torch.cuda.synchronize()
        read_launches(kernels, {}, "training under VIDDET_CONV_BACKEND=pallas")
    finally:
        del os.environ["VIDDET_CONV_BACKEND"]
    check(all(np.isfinite(totals)), "overfit losses finite")
    check(totals[-1] < 0.5 * totals[0], f"overfit: total loss below half its first: {totals}")
    del model, state, batch
    torch.cuda.empty_cache()

    speeds = [r["samples_per_sec"] for r in records]
    emit({"phase": "train", "nvidia_smi": smi, "model": MODEL, "dtype": "bfloat16",
          "batch": TRAIN_B,
          "cli": {"epochs": TRAIN_EPOCHS, "steps": len(records), "seconds": cli_s,
                  "samples_per_s_median": statistics.median(speeds),
                  "samples_per_s": speeds, "last_losses": records[-1],
                  "peak_mem_gib": cli_peak, "validation_launches": val_launches,
                  "tail_equal_plain": True, "trace": idle, "checkpoint": os.path.basename(ckpt)},
          "step_alone": alone,
          "step_416": {"ms": step_ms, "device_busy_ms": busy, "idle_share": 1.0 - busy / step_ms,
                       "waits_for_card": 0, "parts": breakdown},
          "overfit": {"steps": TRAIN_OVERFIT_STEPS, "first": totals[0], "last": totals[-1],
                      "conv_backend": "pallas", "k8_launches": 0},
          "phase_s": time.perf_counter() - t_phase})
    return val_launches


# Phase 18: detector_train
# ---------------------------------------------------------------------------

# The JAX fixtures (tests/test_torch_detector_train_fixture.py writes them
# on the CPU): the shallow SSD (64 px) and Faster R-CNN (128 px, TINY_CFG's
# counts) of the JAX unit tests, 3 classes, one batch of two images, three
# SGD steps in float32 and in float64 compute (the models' float32 casts
# kept), the Faster R-CNN steps on JAX's recorded draws.  The card holds
# the targets bit for bit, the float32 losses of step 1 (all three for SSD)
# and, in float64, every step's losses and each leaf's sample after step 3,
# within the train phase's limits.  (In float32 the Faster R-CNN leaves
# drift past them on both sides' float32 BatchNorm sums: ROADMAP Queue 3.)
DETECTOR_FIXTURES = {
    family: os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures",
                         f"jax_{family}_train_steps.npz") for family in ("ssd", "frcnn")}
DETECTOR_LOSS_NAMES = {"ssd": ("cls", "box", "total", "npos"),
                       "frcnn": ("rpn_cls", "rpn_box", "cls", "box", "total")}
UNIFORM_SCALE = 2.0 ** 23  # jax.random.uniform's float32 draws are k / 2**23
LEAF_SAMPLES = 64


def leaf_sample_index(size: int) -> np.ndarray:
    """The elements of a leaf the fixtures keep: evenly spaced."""
    return np.unique(np.linspace(0, size - 1, min(LEAF_SAMPLES, size)).round().astype(np.int64))


def detector_fixture_model(fx: dict, dev, f64: bool):
    """The fixture's shallow model on ``dev`` with ``seeded_flat(model, 0)``,
    in train mode, in float32 or float64 compute."""
    import torch

    from viddet_tpu_torch.core.precision import FLOAT32_POLICY, Policy
    from viddet_tpu_torch.models.faster_rcnn import FasterRCNN, FRCNNConfig
    from viddet_tpu_torch.models.ssd import SSD
    from viddet_tpu_torch.weights import load_flat, seeded_flat

    policy = Policy(torch.float64) if f64 else FLOAT32_POLICY
    shallow = dict(backbone_blocks=tuple(int(v) for v in fx["backbone_blocks"]),
                   backbone_widths=tuple(int(v) for v in fx["backbone_widths"]))
    num_classes, size = int(fx["num_classes"]), fx["images"].shape[1]
    if "counts" in fx:
        counts = {str(k): int(v) for k, v in zip(fx["count_names"], fx["counts"])}
        model = FasterRCNN(num_classes, FRCNNConfig(**counts), policy, **shallow)
    else:
        model = SSD(num_classes, size, policy, **shallow)
    model = model.to(device=dev, dtype=torch.float64 if f64 else torch.float32,
                     memory_format=torch.channels_last)
    load_flat(model, seeded_flat(model, 0))
    return model.train()


def detector_fixture_steps(fx: dict, family: str, dev, f64: bool):
    """The fixture's steps on ``dev``: (losses (steps, L), the model, the
    leaves' digest after each step).  Under a process group each process
    steps on its rows of the batch and of JAX's draws (``shard_batch``, the
    draw rule)."""
    import torch

    from viddet_tpu_torch.parallel.mesh import shard_batch
    from viddet_tpu_torch.train.loop import make_frcnn_train_step, make_ssd_train_step
    from viddet_tpu_torch.train.state import TrainState, make_lr_schedule, make_optimizer

    model = detector_fixture_model(fx, dev, f64)
    state = TrainState(model, make_optimizer(make_lr_schedule(float(fx["lr"]), 1),
                                             momentum=float(fx["momentum"]),
                                             weight_decay=float(fx["weight_decay"])))
    images = torch.from_numpy(fx["images"]).to(dev, torch.float64 if f64 else torch.float32)
    boxes, ids = (torch.from_numpy(fx[k]).to(dev) for k in ("gt_boxes", "gt_ids"))
    images, boxes, ids = (shard_batch(t) for t in (images, boxes, ids))
    losses, digests = [], []
    for i in range(int(fx["steps"])):
        if family == "ssd":
            _, out = make_ssd_train_step(model)(state, images, boxes, ids)
        else:
            uniforms = tuple(
                shard_batch(torch.from_numpy(fx[f"{k}_uniform"][i] / UNIFORM_SCALE).float().to(dev))
                for k in ("roi", "rpn"))
            _, out = make_frcnn_train_step(model)(state, None, images, boxes, ids,
                                                  uniforms=uniforms)
        losses.append([float(out[k]) for k in DETECTOR_LOSS_NAMES[family]])
        digests.append(leaf_digest(model))
    return np.asarray(losses), model, digests


def detector_fixture_targets(fx: dict, family: str, dev) -> dict:
    """The batch's targets on ``dev`` against the fixture's, bit for bit:
    SSD's class and box targets; Faster R-CNN's roi sampling on JAX's own
    step-1 proposals and draws, and its RPN labels and positives' box
    targets on JAX's draws."""
    import torch

    from viddet_tpu_torch.models import faster_rcnn, ssd

    def t(key, dtype=None):
        return torch.from_numpy(fx[key]).to(dev, dtype)

    boxes, ids = t("gt_boxes"), t("gt_ids")
    size = fx["images"].shape[1]
    if family == "ssd":
        anchors = torch.from_numpy(ssd.generate_ssd_anchors(size)).to(dev)
        got = ssd.assign_ssd_targets(anchors, boxes, ids)
        return {name: bool(np.array_equal(g.cpu().numpy(), fx[f"targets/{name}"]))
                for name, g in zip(("cls", "box"), got)}
    model = detector_fixture_model(fx, dev, False)
    roi_u, rpn_u = (t(f"{k}_uniform")[0].float() / UNIFORM_SCALE for k in ("roi", "rpn"))
    got = faster_rcnn.sample_rois(roi_u, t("proposals"), t("proposal_valid"), boxes, ids,
                                  model.config)
    out = {name: bool(np.array_equal(g.cpu().numpy(), fx[f"targets/{name}"]))
           for name, g in zip(("rois", "roi_cls", "roi_box", "roi_mask"), got)}
    _, anchors = model.anchors([torch.empty(1, 1, size // s, size // s, device=dev)
                                for s in faster_rcnn.FPN_STRIDES])
    labels, box_t = faster_rcnn.assign_rpn_targets(anchors, boxes, ids, model.config, rpn_u)
    labels = labels.cpu().numpy()
    out["rpn_labels"] = bool(np.array_equal(labels, fx["targets/rpn_labels"]))
    out["rpn_box_at_positives"] = bool(np.array_equal(box_t.cpu().numpy()[labels == 1],
                                                      fx["targets/rpn_box_at_positives"]))
    return out


def detector_fixture_run(dev, family: str) -> dict:
    """The fixture's checks on ``dev`` (TF32 off): the targets, the float32
    losses, and the float64 losses and leaves against the fixture's."""
    import torch

    from viddet_tpu_torch.weights import to_flat

    with np.load(DETECTOR_FIXTURES[family]) as f:
        fx = {k: f[k] for k in f.files}
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        targets = detector_fixture_targets(fx, family, dev)
        runs = {name: detector_fixture_steps(fx, family, dev, name == "f64")
                for name in ("f32", "f64")}
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved

    def loss_rel(got, want):
        return np.abs(got - want) / np.maximum(np.abs(want), 1e-30)

    rel32 = loss_rel(runs["f32"][0], fx["losses_f32"])
    rel64 = loss_rel(runs["f64"][0], fx["losses_f64"])
    flat = to_flat(runs["f64"][1])
    leaf_rel = {}
    for key in sorted(k[len("leaf_sample/"):] for k in fx if k.startswith("leaf_sample/")):
        v = flat[key].reshape(-1)
        got = v[leaf_sample_index(v.size)].astype(np.float64)
        want = fx[f"leaf_sample/{key}"].astype(np.float64)
        leaf_rel[key] = float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))
    worst = max(leaf_rel, key=leaf_rel.get)
    return {"targets_equal": targets, "losses_f32": runs["f32"][0].tolist(),
            "loss_max_rel_f32_step1": float(rel32[0].max()), "loss_max_rel_f32": float(rel32.max()),
            "loss_max_rel_f64": float(rel64.max()), "leaves": len(leaf_rel),
            "leaf_max_rel_l2_f64": leaf_rel[worst], "leaf_worst_f64": worst,
            "leaf_median_rel_l2_f64": float(np.median(list(leaf_rel.values()))),
            "digests": {name: run[2] for name, run in runs.items()}}


def check_detector_fixture(report: dict, family: str) -> None:
    check(all(report["targets_equal"].values()), f"{family} targets equal the fixture's: {report}")
    f32 = report["loss_max_rel_f32"] if family == "ssd" else report["loss_max_rel_f32_step1"]
    check(f32 <= TRAIN_LOSS_RTOL, f"{family} float32 losses within {TRAIN_LOSS_RTOL}: {report}")
    check(report["loss_max_rel_f64"] <= TRAIN_LOSS_RTOL,
          f"{family} float64 losses within {TRAIN_LOSS_RTOL}: {report}")
    check(report["leaf_max_rel_l2_f64"] <= TRAIN_LEAF_REL_L2,
          f"{family} float64 leaves within {TRAIN_LEAF_REL_L2}: {report}")


def cli_log_records(path: str, names) -> list:
    """The ``speed:`` lines of a training log: samples/s and each loss."""
    records = []
    with open(path) as f:
        for line in f:
            if " speed: " not in line:
                continue
            speed = float(line.split(" speed: ")[1].split()[0])
            values = {n: float(line.split(f"{n}=")[1].split(",")[0]) for n in names}
            records.append({"samples_per_sec": speed, **values})
    return records


def detector_step_parts(family: str, model, generator):
    """The parts of one train step, a marker between them (``step_phases``)."""
    import torch

    from viddet_tpu_torch.models.faster_rcnn import frcnn_loss
    from viddet_tpu_torch.models.ssd import ssd_loss
    from viddet_tpu_torch.train.loop import _maybe_normalize

    def parts(st, batch, mark):
        images, boxes, ids = batch
        x = _maybe_normalize(images)
        if family == "ssd":
            out = st.model.train()(x)
            mark()
            losses = ssd_loss(out, boxes, ids)
        else:
            out = st.model.train()(x, boxes, ids, generator=generator)
            mark()
            u = torch.rand((x.shape[0], 2, out["anchors"].shape[0]), generator=generator,
                           device=x.device)
            losses = frcnn_loss(out, boxes, ids, model.config, u)
        mark()
        st.zero_grad()
        losses["total"].backward()
        mark()
        st.apply_gradients()

    return parts


def detector_train_family(dev, kernels, family: str, smi: str) -> tuple:
    """One family of the detector training phase (module docstring, phase
    17): (its CLI's launches, K5's row on the step's proposals or None)."""
    import tempfile

    import torch

    from viddet_tpu_torch.cli import train_faster_rcnn, train_ssd
    from viddet_tpu_torch.cli.common import get_dataset
    from viddet_tpu_torch.data.loader import DetectionLoader
    from viddet_tpu_torch.data.transforms import ValTransform
    from viddet_tpu_torch.infer.service import to_device_batch
    from viddet_tpu_torch.models.faster_rcnn import frcnn_postprocess
    from viddet_tpu_torch.models.ssd import SSDNMSConfig, ssd_postprocess
    from viddet_tpu_torch.models.zoo import get_model
    from viddet_tpu_torch.ops import nms as nms_ops
    from viddet_tpu_torch.ops import nms_cuda
    from viddet_tpu_torch.train.loop import make_frcnn_train_step, make_ssd_train_step
    from viddet_tpu_torch.train.state import (
        TrainState, latest_checkpoint, load_weights_npz, make_lr_schedule, make_optimizer,
    )
    from viddet_tpu_torch.weights import init_flat, load_flat, to_flat

    t_family = time.perf_counter()
    ssd = family == "ssd"
    name = SSD_MODEL if ssd else FRCNN_MODEL
    size, b, epochs = ((SSD_TRAIN_SIZE, SSD_TRAIN_B, SSD_TRAIN_EPOCHS) if ssd else
                       (FRCNN_TRAIN_SIZE, FRCNN_TRAIN_B, FRCNN_TRAIN_EPOCHS))
    cli, log_names = ((train_ssd, ("CrossEntropy", "SmoothL1")) if ssd else
                      (train_faster_rcnn, ("RPNAcc-loss", "RPNL1", "RCNNCE", "RCNNL1")))
    kw = {"image_size": size} if ssd else {}
    model, classes = get_model(name, device=dev, **kw)
    load_flat(model, init_flat(name, seed=0, **kw))

    # -- the CLI at full width ------------------------------------------------
    train_images = len(get_dataset("synthetic", "synthetic")[0])
    steps = epochs * (train_images // b)
    val_batches = -(-TRAIN_VAL_IMAGES // b)
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, family)
        argv = ["--platform", "gpu" if dev.type == "cuda" else "cpu",
                "--dataset", "synthetic", "--data-root", "synthetic",
                "--data-shape", str(size), "--batch-size", str(b), "--epochs", str(epochs),
                "--num-workers", "4", "--log-interval", "1", "--val-interval", str(epochs),
                "--save-interval", "1", "--save-prefix", prefix]
        argv += ["--warmup-epochs", str(epochs)] if ssd else ["--lr", "1e-3"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        set_launches(kernels)
        t0 = time.perf_counter()
        cli.main(argv, built=(model, classes))
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        want = {k: v * val_batches for k, v in (SSD_LAUNCHES if ssd else FRCNN_LAUNCHES).items()}
        if not ssd:  # one proposal NMS a step
            want["nms_keep_mask"] += steps
        launches = read_launches(kernels, want, f"{family} train CLI")
        cli_peak = torch.cuda.max_memory_allocated() / 2**30
        records = cli_log_records(f"{prefix}_train.log", log_names)
        check(len(records) == steps, f"{family}: {steps} log lines, got {len(records)}")
        check(all(np.isfinite(r[n]) for r in records for n in log_names),
              f"{family}: every logged loss finite: {records}")
        ckpt = latest_checkpoint(f"{prefix}_ckpt")
        check(ckpt is not None and ckpt.endswith(f"step_{steps:08d}"),
              f"{family}: the last checkpoint is step {steps}: {ckpt}")
        final = load_weights_npz(f"{prefix}_final.npz")
        load_flat(model, final)
        check(all(np.array_equal(v, final[k]) for k, v in to_flat(model).items()),
              f"{family}: _final.npz loads back through weights.load_flat")
        check(os.path.exists(f"{prefix}_best.npz"), f"{family}: _best.npz written")

    # the validation batch through the kernel and plain tails
    val_ds, _ = get_dataset("synthetic", "synthetic", split="val")
    images = next(iter(DetectionLoader(val_ds, ValTransform(size=(size, size)), batch_size=b,
                                       num_workers=0)))[0]
    model.eval()
    with torch.inference_mode():
        out = model(to_device_batch(images, b, dev))
        if ssd:
            tails = [ssd_postprocess(out, SSDNMSConfig(backend=k)) for k in ("auto", "plain")]
        else:
            tails = [frcnn_postprocess(out["proposals"], out["roi_cls_logits"],
                                       out["roi_box_deltas"], (size, size), backend=k)
                     for k in ("auto", "plain")]
    check(all(equal(x, y) for x, y in zip(*tails)),
          f"{family} validation: kernel tail equal to plain tail")
    del out, tails
    model.train()

    # -- one step alone, by part; K5 in the Faster R-CNN step ---------------
    load_flat(model, init_flat(name, seed=0, **kw))
    state = TrainState(model, make_optimizer(make_lr_schedule(1e-3, 1)))
    generator = None if ssd else torch.Generator(device=dev).manual_seed(7)
    if ssd:
        ssd_step = make_ssd_train_step(model)

        def step(st, batch):
            return ssd_step(st, *batch)
    else:
        frcnn_step = make_frcnn_train_step(model)

        def step(st, batch):
            return frcnn_step(st, generator, *batch)

    batch = train_batch(dev, size, b, seed=size)
    for _ in range(2):
        step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = median_ms(lambda: step(state, batch), reps=5, warmup=0)
    peak = torch.cuda.max_memory_allocated() / 2**30
    parts = step_phases(state, detector_step_parts(family, model, generator), batch)
    busy = sum(p["device_ms"] for p in parts.values())
    waits = waits_for_card(lambda: step(state, batch))
    check(not waits, f"the {family} train step waits for the card: {waits}")

    k5 = None
    if not ssd:
        seen = []
        real = nms_ops._WRAPPERS

        def recording(boxes, valid, iou):
            keep = real.nms_keep_mask(boxes, valid, iou)
            seen.append((boxes.clone(), valid.clone(), iou, keep.clone()))
            return keep

        nms_ops._WRAPPERS = real._replace(nms_keep_mask=recording)
        try:
            set_launches(kernels)
            step(state, batch)
            torch.cuda.synchronize()
            read_launches(kernels, {"nms_keep_mask": 1}, "one Faster R-CNN train step")
        finally:
            nms_ops._WRAPPERS = real
        check(len(seen) == 1, f"K5 called once a step, got {len(seen)}")
        boxes, valid, iou, keep = seen[0]
        cfg = model.config
        check(tuple(boxes.shape) == (b, cfg.rpn_nms_input, 4) and iou == cfg.rpn_nms_thresh
              and not boxes.requires_grad, f"K5's input in the step: {tuple(boxes.shape)}, {iou}")
        check(equal(keep, nms_cuda.nms_keep_mask_plain(boxes, valid, iou)),
              "K5 on the train step's proposals equal to plain")
        k = boxes.shape[1]
        k5 = dict(batch=b, k=k, valid=int(valid.sum().item()), kept=int(keep.sum().item()),
                  max_abs_err=0.0, bound=bound_ms(b * k * (16 + 1 + 4), b * k * (k - 1) // 2 * 24),
                  **timings(lambda: nms_cuda.nms_keep_mask(boxes, valid, iou),
                            lambda: nms_cuda.nms_keep_mask_plain(boxes, valid, iou),
                            plain_reps=3, names=KERNEL_NAMES["nms_keep_mask"]))
        del seen, boxes, valid, keep

    # -- the overfit of one batch -----------------------------------------------
    steps_o, lr_o = ((SSD_OVERFIT_STEPS, SSD_OVERFIT_LR) if ssd else
                     (FRCNN_OVERFIT_STEPS, FRCNN_OVERFIT_LR))
    load_flat(model, init_flat(name, seed=0, **kw))
    state = TrainState(model, make_optimizer(make_lr_schedule(lr_o, 1), weight_decay=0.0))
    if generator is not None:
        generator.manual_seed(5)
    totals = [float(step(state, batch)[1]["total"]) for _ in range(steps_o)]
    check(all(np.isfinite(totals)), f"{family} overfit losses finite: {totals}")
    factor = 0.7 if ssd else 1.0
    check(min(totals[-3:]) < factor * max(totals[:3]),
          f"{family} overfit: least of the last three below {factor} x the greatest of the "
          f"first three: {totals}")
    del model, state, batch
    torch.cuda.empty_cache()

    speeds = [r["samples_per_sec"] for r in records]
    emit({"phase": f"{family}_train", "nvidia_smi": smi, "model": name, "dtype": "bfloat16",
          "size": size, "batch": b,
          "cli": {"epochs": epochs, "steps": steps, "seconds": cli_s,
                  "samples_per_s_median": statistics.median(speeds), "samples_per_s": speeds,
                  "last_losses": records[-1], "peak_mem_gib": cli_peak,
                  "validation_batches": val_batches, "launches": launches,
                  "tail_equal_plain": True, "checkpoint": os.path.basename(ckpt)},
          "step_alone": {"ms": step_ms, "samples_per_s": b / step_ms * 1e3, "peak_mem_gib": peak,
                         "device_busy_ms": busy, "idle_share": 1.0 - busy / step_ms,
                         "waits_for_card": 0, "parts": parts},
          **({"k5_in_step": k5} if k5 else {}),
          "overfit": {"steps": steps_o, "lr": lr_o, "first": totals[:3], "last": totals[-3:]},
          "phase_s": time.perf_counter() - t_family})
    return launches, k5


def detector_train_phase(dev, kernels) -> tuple:
    """Phase 18: the two fixtures, then each family at full width."""
    smi = nvidia_smi_line()
    for family in ("ssd", "frcnn"):
        t0 = time.perf_counter()
        report = detector_fixture_run(dev, family)
        check_detector_fixture(report, family)
        emit({"phase": f"{family}_train_fixture", "nvidia_smi": smi, "dtype": "float32, float64",
              "tf32": False, "seconds": time.perf_counter() - t0, **report})
    launches, k5_rows = {}, {}
    for family in ("ssd", "frcnn"):
        launches[f"{family}_train"], k5 = detector_train_family(dev, kernels, family, smi)
        if k5:
            k5_rows[f"{family}_train"] = k5
    return launches, k5_rows


# ---------------------------------------------------------------------------
# Phase 21: data_parallel
# ---------------------------------------------------------------------------

# The data-parallel slice (parallel/mesh.py) on the one card, in a process
# of its own: (a) NCCL at world size 1 with the main path's model (its CLI,
# DP_CLI_STEPS one-step epochs at batch 64, validated once, against the same
# run without a group, bit for bit, cuDNN deterministic in both) and
# Faster R-CNN's step (FRCNN_MODEL at 800 px, batch 8), each step's ms with
# and without the group; (b) DP_WORLD gloo processes on cuda:0 (NCCL
# refuses two ranks on one card): the three fixtures, one image a process,
# and the main path's model in float32 at DP_F32_B images a process against
# one process of DP_WORLD * DP_F32_B, the losses within DP_LOSS_RTOL; (c)
# the same processes evaluate the evaluate phase's 256 images, each its
# strided shard, against one process: the merged VOC07 mAP equal, each
# ``.p{i}`` detection file equal to its shard's from one process.
DP_WORLD, DP_CLI_STEPS, DP_FRCNN_STEPS = 2, 3, 3
# Float32 YOLOv3-416 images a process: one step at 16 a process peaked at
# 7.44 GiB a process and at 14.40 GiB in the reference of 32 on an H100
# (PERF.md), so both processes and the reference fit the card with room;
# a larger batch would only lengthen the phase.
DP_F32_B = 16
DP_LOSS_RTOL = 1e-4
DP_GROUP_TIMEOUT_S = 300.0
DP_RANK_TIMEOUT_S = 600.0
DP_BN_SHAPE = (16, 64, 208, 208)  # a Darknet-53 BatchNorm at 416 px, 16 images a process


def dp_step_batch(dev, b: int):
    """The float32 comparison's global batch: ``train_batch`` at 416 px of
    DP_WORLD * ``b`` images; each process takes its rows."""
    return train_batch(dev, IMAGE_SIZE, DP_WORLD * b, seed=17)


def dp_f32_step(dev, batch) -> dict:
    """The main path's model in float32 (seeded weights), one train step on
    ``batch`` (this process's rows under a group): the global losses, the
    leaves' digest, the step's ms over 3 more steps, peak memory, and the
    gradient all-reduce's ms alone (under a group)."""
    from viddet_tpu_torch.parallel import mesh
    import torch

    from viddet_tpu_torch.core.precision import FLOAT32_POLICY
    from viddet_tpu_torch.models.zoo import get_model
    from viddet_tpu_torch.parallel.mesh import shard_batch
    from viddet_tpu_torch.train.loop import make_train_step
    from viddet_tpu_torch.train.state import TrainState, make_lr_schedule, make_optimizer
    from viddet_tpu_torch.weights import init_flat, load_flat

    model, classes = get_model(MODEL, device=dev, policy=FLOAT32_POLICY)
    load_flat(model, init_flat(MODEL, seed=0))
    state = TrainState(model.train(), make_optimizer(make_lr_schedule(1e-3, 1)))
    step = make_train_step(strides=model.head.strides, anchors=model.head.anchors,
                           num_classes=len(classes))
    rows = tuple(shard_batch(t) for t in batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = {k: float(v) for k, v in step(state, *rows)[1].items()}
    digest = leaf_digest(model)
    ms = median_ms(lambda: step(state, *rows), reps=3, warmup=0)
    out = {"images": rows[0].shape[0], "losses": losses, "digest": digest, "step_ms": ms,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    if mesh.active():
        grads = [p.grad for p in state.params]
        out["all_reduce_ms"] = median_ms(lambda: mesh.all_reduce_(grads, mean=True), reps=3)
        out["gradient_mb"] = sum(g.numel() * g.element_size() for g in grads) / 1e6
    del model, state, step
    torch.cuda.empty_cache()
    return out


def dp_evaluate(dev, kernels, path: str, shard=None) -> dict:
    """``cli.evaluate.evaluate`` of the main path's model (bf16, seeded)
    over the evaluate phase's 256 images, detections to ``path`` (``.p{i}``
    under several processes), or in one process over the strided ``shard``
    (index, count) alone (``VIDDET_EVAL_SHARD``): the metric and its state,
    the launches, images/s."""
    import argparse
    import logging

    import torch

    from viddet_tpu_torch.cli.evaluate import evaluate
    from viddet_tpu_torch.data.names import COCO_CLASSES
    from viddet_tpu_torch.data.synthetic import SyntheticDetection
    from viddet_tpu_torch.eval.voc_map import VOC07MApMetric
    from viddet_tpu_torch.models.zoo import get_model
    from viddet_tpu_torch.parallel.mesh import process_count
    from viddet_tpu_torch.weights import init_flat, load_flat

    model, _ = get_model(MODEL, device=dev)
    load_flat(model, init_flat(MODEL, seed=0))
    dataset = SyntheticDetection(num_images=EVAL_IMAGES, size=EVAL_IMAGE_SIZE,
                                 num_classes=EVAL_CLASSES, seed=EVAL_SEED)
    args = argparse.Namespace(data_shape=IMAGE_SIZE, batch_size=EVAL_B,
                              num_workers=EVAL_WORKERS, letterbox=False, max_images=0,
                              device_normalize=True, temporal_k=1, save_detections=path)
    count = shard[1] if shard else process_count()
    batches = -(-EVAL_IMAGES // count // EVAL_B)
    metric = VOC07MApMetric(iou_thresh=0.5, class_names=COCO_CLASSES)
    stats = {}
    set_launches(kernels)
    if shard:
        os.environ["VIDDET_EVAL_SHARD"] = f"{shard[0]},{shard[1]}"
    try:
        names, values = evaluate(model, dataset, metric, args,
                                 logging.getLogger("chip_smoke.data_parallel"), stats)
    finally:
        os.environ.pop("VIDDET_EVAL_SHARD", None)
    torch.cuda.synchronize()
    launches = read_launches(kernels, {k: v * batches for k, v in HIER_LAUNCHES.items()},
                             f"evaluate over {count} shard(s)")
    del model
    torch.cuda.empty_cache()
    return {"names": list(names), "values": [float(v) for v in values], "launches": launches,
            "batches": batches, "images_per_s": stats["images"] / stats["seconds"],
            "images": stats["images"], "state": metric.state_dict()}


def detection_lines(path: str) -> dict:
    """A ``--save-detections`` file's lines by image index."""
    with open(path) as f:
        return {json.loads(line)["index"]: line for line in f}


def detection_diff(got: dict, want: dict) -> dict:
    """How two detection files (``detection_lines``) differ: images missing,
    lines unequal, among them lines whose ids differ, and the largest score
    and box difference where the ids agree."""
    unequal = [k for k in want if k in got and got[k] != want[k]]
    ids_differ, score, box = 0, 0.0, 0.0
    for k in unequal:
        g, w = json.loads(got[k]), json.loads(want[k])
        if g["ids"] != w["ids"]:
            ids_differ += 1
            continue
        score = max([score] + [abs(a - b) for a, b in zip(g["scores"], w["scores"])])
        box = max([box] + [float(np.abs(np.subtract(g["boxes"], w["boxes"])).max())]
                  if w["boxes"] else [box])
    return {"missing": len(set(want) - set(got)), "unequal": len(unequal),
            "ids_differ": ids_differ, "max_score_diff": score, "max_box_diff": box,
            "first_unequal": unequal[:5]}


def dp_bn_ms(dev) -> dict:
    """Train-mode BatchNorm forward and backward at DP_BN_SHAPE in float32
    and in bf16 (the main path's compute dtype): ``batch_norm_train`` under
    this process's group against ``native_batch_norm`` alone, each ms by
    CUDA events; the synced outputs and gradients finite."""
    import torch

    from viddet_tpu_torch.models.common import batch_norm_train

    out = {"shape": list(DP_BN_SHAPE)}
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(DP_BN_SHAPE, device=dev).to(dtype)
        x = x.contiguous(memory_format=torch.channels_last).requires_grad_(True)
        dy = torch.randn_like(x)
        bn = torch.nn.BatchNorm2d(DP_BN_SHAPE[1]).to(dev)

        def synced():
            y = batch_norm_train(x, bn)
            y.backward(dy)
            return y

        def native():
            torch.native_batch_norm(x, bn.weight, bn.bias, None, None, True, 0.0, 1e-5)[0] \
                .backward(dy)

        x.grad = None
        y = synced()
        check(bool(torch.isfinite(y).all() and torch.isfinite(x.grad).all())
              and y.dtype == dtype, f"the global BatchNorm in {dtype} is finite")
        name = "f32" if dtype == torch.float32 else "bf16"
        out[f"synced_{name}_ms"] = median_ms(synced, reps=5)
        out[f"native_{name}_ms"] = median_ms(native, reps=5)
    return out


def dp_rank_main(rank: int, store: str, out: str, tmp: str, device: str) -> None:
    """One gloo process of (b) and (c) on ``device`` (the card: cuda:0);
    its result, or its traceback, pickled to ``out``."""
    import pickle
    import traceback

    import torch

    from viddet_tpu_torch.kernels import build
    from viddet_tpu_torch.parallel import mesh

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    try:
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
            build.build()  # the parent's build, found by its source hash
            build.library()
        kernels = {name: row[0] for name, row in kernel_table().items()}
        mesh.initialize_distributed(f"file://{store}", DP_WORLD, rank, backend="gloo",
                                    timeout_s=DP_GROUP_TIMEOUT_S)
        t0 = time.perf_counter()
        result = {"fixtures": {"yolo": train_fixture_run(dev),
                               **{f: detector_fixture_run(dev, f) for f in ("ssd", "frcnn")}}}
        result["fixtures_s"] = time.perf_counter() - t0
        result["f32_step"] = dp_f32_step(dev, dp_step_batch(dev, DP_F32_B))
        result["bn"] = dp_bn_ms(dev)
        result["evaluate"] = dp_evaluate(dev, kernels, os.path.join(tmp, "two.jsonl"))
        payload = {"result": result}
    except BaseException:
        payload = {"error": traceback.format_exc()}
    finally:
        if mesh.active():
            torch.distributed.destroy_process_group()
    with open(out, "wb") as f:
        pickle.dump(payload, f)


def dp_cli_run(dev, kernels, model, classes, tmp: str, name: str) -> dict:
    """``cli.train_yolov3.main`` on the main path's model from its seeded
    weights: DP_CLI_STEPS one-step epochs at batch 64, 416 px, mixup off,
    validated at the end; each step's losses as the step returned them, the
    ``_final.npz`` leaves, the validation's launches."""
    import torch

    from viddet_tpu_torch.cli import train_yolov3
    from viddet_tpu_torch.train.state import load_weights_npz
    from viddet_tpu_torch.weights import init_flat, load_flat

    load_flat(model, init_flat(MODEL, seed=0))
    losses = []
    make_step = train_yolov3.make_train_step

    def recording_step(**kw):
        step = make_step(**kw)

        def run(*args):
            state, out = step(*args)
            losses.append({k: float(v) for k, v in out.items()})
            return state, out

        return run

    prefix = os.path.join(tmp, name, "y3")
    argv = ["--platform", "gpu", "--dataset", "synthetic", "--data-root", "synthetic",
            "--data-shape", str(IMAGE_SIZE), "--no-random-shape", "--batch-size", str(TRAIN_B),
            "--epochs", str(DP_CLI_STEPS), "--num-workers", "4", "--log-interval", "1",
            "--val-interval", str(DP_CLI_STEPS), "--save-interval", "0", "--save-prefix", prefix]
    train_yolov3.make_train_step = recording_step
    set_launches(kernels)
    t0 = time.perf_counter()
    try:
        train_yolov3.main(argv, built=(model, classes))
    finally:
        train_yolov3.make_train_step = make_step
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches(kernels, HIER_LAUNCHES, f"train CLI {name} (its validation batch)")
    return {"losses": losses, "final": load_weights_npz(f"{prefix}_final.npz"),
            "launches": launches, "seconds": seconds}


def dp_step_ms(kernels, step, batch, what: str, launches_per_step: dict) -> tuple:
    """ms of one train step (CUDA events, median of 5 after 2) and the
    launches of DP_FRCNN_STEPS steps."""
    import torch

    for _ in range(2):
        step(batch)
    torch.cuda.synchronize()
    set_launches(kernels)
    for _ in range(DP_FRCNN_STEPS):
        step(batch)
    torch.cuda.synchronize()
    launches = read_launches(kernels, {k: v * DP_FRCNN_STEPS for k, v in launches_per_step.items()},
                             what)
    return median_ms(lambda: step(batch), reps=5, warmup=0), launches


def data_parallel_phase(dev, kernels) -> dict:
    """Phase 21 (module docstring): returns its launch counts."""
    import multiprocessing
    import pickle
    import tempfile

    import torch

    from viddet_tpu_torch.cli.common import get_dataset
    from viddet_tpu_torch.models.zoo import get_model
    from viddet_tpu_torch.parallel import mesh
    from viddet_tpu_torch.train.loop import make_frcnn_train_step, make_train_step
    from viddet_tpu_torch.train.state import TrainState, make_lr_schedule, make_optimizer
    from viddet_tpu_torch.weights import init_flat, load_flat

    t_phase = time.perf_counter()
    smi = nvidia_smi_line()
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        # -- (a) NCCL at world size 1 --------------------------------------------
        model, classes = get_model(MODEL)
        saved = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            runs = {"alone": dp_cli_run(dev, kernels, model, classes, tmp, "alone")}
            mesh.initialize_distributed(f"file://{tmp}/nccl_store", 1, 0,
                                        timeout_s=DP_GROUP_TIMEOUT_S)
            check(mesh.active() and torch.distributed.get_backend() == "nccl",
                  "an NCCL group of one is up")
            runs["nccl"] = dp_cli_run(dev, kernels, model, classes, tmp, "nccl")
        finally:
            torch.backends.cudnn.deterministic = saved
        same_losses = runs["alone"]["losses"] == runs["nccl"]["losses"]
        same_final = all(np.array_equal(v, runs["nccl"]["final"][k])
                         for k, v in runs["alone"]["final"].items())
        steps = DP_CLI_STEPS * (len(get_dataset("synthetic", "synthetic")[0]) // TRAIN_B)
        check(len(runs["nccl"]["losses"]) == steps and same_losses,
              f"the CLI's losses under NCCL equal the run without a group: {runs}")
        check(same_final, "the CLI's _final.npz under NCCL equals the run without a group")
        launches["data_parallel_train"] = runs["nccl"]["launches"]

        # each step's ms with the group (NCCL all-reduce) and without
        timed = {}
        load_flat(model, init_flat(MODEL, seed=0))
        state = TrainState(model.train(), make_optimizer(make_lr_schedule(1e-3, 1)))
        yolo = make_train_step(strides=model.head.strides, anchors=model.head.anchors,
                               num_classes=len(classes))
        yolo_batch = train_batch(dev, IMAGE_SIZE, TRAIN_B, seed=IMAGE_SIZE)
        frcnn_model, _ = get_model(FRCNN_MODEL)
        load_flat(frcnn_model, init_flat(FRCNN_MODEL, seed=0))
        frcnn_state = TrainState(frcnn_model.train(), make_optimizer(make_lr_schedule(1e-3, 1)))
        frcnn = make_frcnn_train_step(frcnn_model)
        generator = torch.Generator(device=dev).manual_seed(7)
        frcnn_batch = train_batch(dev, FRCNN_TRAIN_SIZE, FRCNN_TRAIN_B, seed=FRCNN_TRAIN_SIZE)
        grads = [torch.ones_like(p) for p in state.params]
        for group in ("nccl", "alone"):
            if group == "alone":
                torch.distributed.destroy_process_group()
            ms_y, _ = dp_step_ms(kernels, lambda b: yolo(state, *b), yolo_batch,
                                 f"YOLOv3 train steps ({group})", {})
            ms_f, frcnn_launches = dp_step_ms(
                kernels, lambda b: frcnn(frcnn_state, generator, *b),
                frcnn_batch, f"Faster R-CNN train steps ({group})", {"nms_keep_mask": 1})
            timed[group] = {"yolo_step_ms": ms_y, "frcnn_step_ms": ms_f,
                            "all_reduce_ms": (median_ms(lambda: mesh.all_reduce_(grads, mean=True),
                                                        reps=10) if group == "nccl" else 0.0)}
            if group == "nccl":
                launches["data_parallel_frcnn_step"] = frcnn_launches
        del model, state, yolo_batch, frcnn_model, frcnn_state, frcnn_batch, grads
        torch.cuda.empty_cache()
        emit({"phase": "data_parallel_nccl", "nvidia_smi": smi, "world_size": 1,
              "backend": "nccl", "model": MODEL, "dtype": "bfloat16", "batch": TRAIN_B,
              "cli": {"steps": DP_CLI_STEPS, "losses_equal": True, "final_equal": True,
                      "losses": runs["nccl"]["losses"], "cudnn_deterministic": True,
                      "seconds": {k: r["seconds"] for k, r in runs.items()},
                      "validation_launches": runs["nccl"]["launches"]},
              "frcnn": {"model": FRCNN_MODEL, "size": FRCNN_TRAIN_SIZE, "batch": FRCNN_TRAIN_B,
                        "steps": DP_FRCNN_STEPS,
                        "k5_launches": launches["data_parallel_frcnn_step"]["nms_keep_mask"]},
              "ms": timed, "phase_s": time.perf_counter() - t_phase})
        del runs

        # -- references of (b) and (c) in this process, no group --------------
        batch = dp_step_batch(dev, DP_F32_B)
        one_step = dp_f32_step(dev, batch)
        del batch
        torch.cuda.empty_cache()
        one_eval = dp_evaluate(dev, kernels, os.path.join(tmp, "one.jsonl"))
        # the processes' shards in turn in this process: each image in the
        # batch and at the place the processes give it
        one_shards = [dp_evaluate(dev, kernels, os.path.join(tmp, f"one_shard{r}.jsonl"),
                                  (r, DP_WORLD)) for r in range(DP_WORLD)]

        # -- (b), (c): DP_WORLD gloo processes on cuda:0 --------------------------
        ctx = multiprocessing.get_context("spawn")
        outs = [os.path.join(tmp, f"rank{r}.pkl") for r in range(DP_WORLD)]
        t0 = time.perf_counter()
        procs = [ctx.Process(target=dp_rank_main,
                             args=(r, os.path.join(tmp, "gloo_store"), outs[r], tmp, str(dev)))
                 for r in range(DP_WORLD)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(DP_RANK_TIMEOUT_S)
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join(30)
        check(not alive, f"{len(alive)} gloo process(es) still running after {DP_RANK_TIMEOUT_S} s")
        ranks_s = time.perf_counter() - t0
        ranks = []
        for r, out in enumerate(outs):
            check(os.path.exists(out), f"gloo process {r} left no result")
            with open(out, "rb") as f:  # written by the process above
                payload = pickle.load(f)
            check("error" not in payload, f"gloo process {r} failed:\n{payload.get('error')}")
            ranks.append(payload["result"])

        # (b): fixtures, bit-identical replicas, float32 at 2 x b against 1 x 2b
        for family, report in ranks[0]["fixtures"].items():
            check(all(r["fixtures"][family] == report for r in ranks),
                  f"{family}: the processes' fixture reports (and leaf digests) are equal")
            if family == "yolo":
                check(all(report["targets_equal"].values())
                      and report["loss_max_rel"] <= TRAIN_LOSS_RTOL
                      and report["leaf_max_rel_l2"] <= TRAIN_LEAF_REL_L2,
                      f"yolo fixture on {DP_WORLD} processes: {report}")
            else:
                check_detector_fixture(report, family)
        check(len({r["f32_step"]["digest"] for r in ranks}) == 1,
              "the float32 step's replicas are bit-identical")
        rel = {k: abs(ranks[0]["f32_step"]["losses"][k] / v - 1) if v else 0.0
               for k, v in one_step["losses"].items()}
        check(max(rel.values()) <= DP_LOSS_RTOL,
              f"float32 losses of {DP_WORLD} x {DP_F32_B} within {DP_LOSS_RTOL} of 1 x "
              f"{DP_WORLD * DP_F32_B}: {rel}")

        # (c): the merged metric and the detection files
        from viddet_tpu_torch.data.names import COCO_CLASSES
        from viddet_tpu_torch.eval.distributed import merge_metric_states
        from viddet_tpu_torch.eval.voc_map import VOC07MApMetric

        shards_metric = merge_metric_states(
            VOC07MApMetric(iou_thresh=0.5, class_names=COCO_CLASSES),
            [e["state"] for e in one_shards])
        shards_merged = shards_metric.get()
        for r in ranks:
            # every record (score, TP, FP): the check that random weights'
            # mAP of 0 cannot make
            check(r["evaluate"]["state"] == shards_metric.state_dict(),
                  "the merged metric state equals the shards' merged in one process")
            for want, what in ((shards_merged, "the shards evaluated in turn in one process"),
                               ((one_eval["names"], one_eval["values"]), "one process")):
                check(np.array_equal(r["evaluate"]["values"], want[1], equal_nan=True)
                      and r["evaluate"]["names"] == list(want[0]),
                      f"merged metric {r['evaluate']['values'][-1]} equals {what}'s "
                      f"{want[1][-1]}")
        for r in range(DP_WORLD):
            got = detection_lines(os.path.join(tmp, f"two.jsonl.p{r}"))
            want = detection_lines(os.path.join(tmp, f"one_shard{r}.jsonl"))
            check(got == want and len(got) == len(range(r, EVAL_IMAGES, DP_WORLD)),
                  f"process {r}'s .p{r} file equals its shard's in one process, line for line: "
                  f"{detection_diff(got, want)}")
        # each image against the whole set in one process at batch 32, where
        # most images sit elsewhere in their batch (reported, not held)
        joined = {k: v for r in range(DP_WORLD)
                  for k, v in detection_lines(os.path.join(tmp, f"two.jsonl.p{r}")).items()}
        against_whole = detection_diff(joined, detection_lines(os.path.join(tmp, "one.jsonl")))
        for r, result in enumerate(ranks):
            launches[f"data_parallel_evaluate_p{r}"] = result["evaluate"]["launches"]

    fixtures = {f: {k: v for k, v in rep.items() if k != "digests"}
                for f, rep in ranks[0]["fixtures"].items()}
    emit({"phase": "data_parallel_gloo", "nvidia_smi": smi, "world_size": DP_WORLD,
          "backend": "gloo (both processes on cuda:0)", "processes_s": ranks_s,
          "fixtures": fixtures, "fixtures_s": [r["fixtures_s"] for r in ranks],
          "replicas_bit_identical": True,
          "f32_step": {"model": MODEL, "images_a_process": DP_F32_B,
                       "losses_rel_gap": rel, "losses": ranks[0]["f32_step"]["losses"],
                       "reference": one_step,
                       "processes": [{k: r["f32_step"][k] for k in
                                      ("step_ms", "peak_mem_gib", "all_reduce_ms", "gradient_mb")}
                                     for r in ranks]},
          "batch_norm": [r["bn"] for r in ranks],
          "evaluate": {"images": EVAL_IMAGES, "batch": EVAL_B, "value": one_eval["values"][-1],
                       "merged_equal": True, "files_equal_to_shards_in_one_process": True,
                       "files_against_whole_set_in_one_process": against_whole,
                       "images_per_s": {"one": one_eval["images_per_s"],
                                        "processes": [r["evaluate"]["images_per_s"]
                                                      for r in ranks]},
                       "launches": [r["evaluate"]["launches"] for r in ranks]},
          "phase_s": time.perf_counter() - t_phase})
    return launches


def kernel_table() -> dict:
    """Each ported kernel: (wrapper, source, the TPU kernel it replaces, the
    path its launches are read on)."""
    from viddet_tpu_torch.ops import (
        conv_cuda, nms_cuda, nms_gather_cuda, roi_align_cuda, topk_cuda,
    )

    return {
        "anchor_scores": (nms_gather_cuda.anchor_scores, "anchor_scores.cu",
                          "nms_gather_pallas.py:611", "hier"),
        "topk_indices": (topk_cuda.topk_indices, "topk_select.cu", "topk_pallas.py:237", "hier"),
        "gather_decode_pairs": (nms_gather_cuda.gather_decode_pairs, "gather_decode.cu",
                                "nms_gather_pallas.py:698", "det"),
        "gather_decode_top_m": (nms_gather_cuda.gather_decode_top_m, "gather_decode.cu",
                                "nms_gather_pallas.py:698", "hier"),
        "finalize_candidates": (nms_gather_cuda.finalize_candidates, "finalize.cu",
                                "nms_gather_pallas.py:480", "hier"),
        "nms_keep_mask": (nms_cuda.nms_keep_mask, "nms.cu", "nms_pallas.py:212", "hier"),
        "compact_and_pad": (nms_cuda.compact_and_pad, "nms.cu", "nms_pallas.py:156", "hier"),
        "conv_down2_bn_leaky": (conv_cuda.conv_down2_bn_leaky, "conv_down2.cu",
                                "conv_pallas.py:91", "conv"),
        "multilevel_roi_align": (roi_align_cuda.multilevel_roi_align, "roi_align.cu",
                                 "roi_align_pallas.py:143", "frcnn"),
    }


CHILD_FLAG = "--phases"
CHILD_GROUPS = ("mpeg4_bvop", "webm", "train", "detector_train", "int8_and_export",
                "data_parallel", "video")


def child_main(group: str) -> int:
    """One group of phases in a process of its own (``child_phases``):
    ``mpeg4_bvop`` or ``webm`` (the main path's model made again from its seed),
    ``train``, ``detector_train``, ``int8_and_export`` (the main path's model and
    frames made again from their seeds, then the ``int8`` and ``export``
    phases), or ``data_parallel``.  Its last line is its launch counts (and K5's rows in the
    train steps), with the profiler windows it had to take again.  ``video``
    (the ``video`` and ``mp4`` phases, which ``main`` runs in its own
    process) is for a run of those two alone: ``python3 chip_smoke.py
    --phases video``."""
    import torch

    from viddet_tpu_torch.kernels import build

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build()  # the parent's build, found by its source hash
    build.library()
    kernels = {name: row[0] for name, row in kernel_table().items()}
    dev = torch.device("cuda:0")
    k5_rows = {}
    if group == "train":
        launches = {"train": train_phase(dev, kernels)}
    elif group == "detector_train":
        launches, k5_rows = detector_train_phase(dev, kernels)
    elif group == "data_parallel":
        launches = data_parallel_phase(dev, kernels)
    else:
        from viddet_tpu_torch.cli.common import make_predictor
        from viddet_tpu_torch.models.zoo import get_model
        from viddet_tpu_torch.weights import init_flat, load_flat

        model, _ = get_model(MODEL)
        load_flat(model, init_flat(MODEL, seed=0))
        if group in ("mpeg4_bvop", "webm", "video"):
            from viddet_tpu_torch import native
            from viddet_tpu_torch.data.names import COCO_CLASSES

            native.build()  # the parent's build, found by its source hash
            predictor = make_predictor(model)
            if group == "video":
                launches = video_phase(dev, kernels, model, COCO_CLASSES, predictor)
                launches.update(mp4_phase(dev, kernels, model, COCO_CLASSES, predictor))
            else:
                phase = mpeg4_bvop_phase if group == "mpeg4_bvop" else webm_phase
                launches = phase(dev, kernels, model, COCO_CLASSES, predictor)
            emit({"phase": f"{group}_result", "launches": launches, "k5_rows": k5_rows,
                  "incomplete_windows": INCOMPLETE_WINDOWS, "spins_lost": SPINS_LOST})
            return 0
        rng = np.random.default_rng(0)  # main_path_phase's frames
        images = torch.from_numpy(rng.integers(
            0, 256, (max(E2E_BATCHES), IMAGE_SIZE, IMAGE_SIZE, 3), dtype=np.uint8)).pin_memory()
        launches = int8_phase(dev, kernels, model, make_predictor(model), images)
        launches.update(export_phase(dev, kernels, model))
    emit({"phase": f"{group}_result", "launches": launches, "k5_rows": k5_rows,
          "incomplete_windows": INCOMPLETE_WINDOWS, "spins_lost": SPINS_LOST})
    return 0


def child_phases(group: str) -> dict:
    """Run ``child_main(group)`` in a child process, its lines passed
    through; returns its result line, and its failure fails the run.  A
    process of its own starts the profiler afresh: after some 30 windows
    in one process the profiler drops records, and the train steps'
    windows at the end of the run came back without them in some runs,
    eight windows in a row once (``step_phases``)."""
    result = None
    with subprocess.Popen([sys.executable, os.path.abspath(__file__), CHILD_FLAG, group],
                          stdout=subprocess.PIPE, text=True) as proc:
        for line in proc.stdout:
            print(line, end="", flush=True)
            if line.startswith(f'{{"phase": "{group}_result"'):
                result = json.loads(line)
        rc = proc.wait(timeout=1200)
    check(rc == 0 and result is not None, f"the {group} phases exited {rc}")
    INCOMPLETE_WINDOWS.extend(result["incomplete_windows"])
    SPINS_LOST.extend(result["spins_lost"])
    return result


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    t_script = time.perf_counter()
    from viddet_tpu_torch.kernels import build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    smi = nvidia_smi_line()
    emit({"phase": "device", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    from viddet_tpu_torch import native

    # the image codec (g++) builds beside the kernels (nvcc)
    codec_s = []
    codec_build = threading.Thread(target=lambda: codec_s.append(timed(native.build)))
    t0 = time.perf_counter()
    codec_build.start()
    lib = build.build()
    build.library()
    kernels_s = time.perf_counter() - t0
    codec_build.join()
    check(bool(codec_s), "the image codec built")
    emit({"phase": "build", "library": str(lib.relative_to(build.BUILD_ROOT.parents[1])),
          "seconds": kernels_s, "codec_seconds": codec_s[0],
          "both_seconds": time.perf_counter() - t0})

    table = kernel_table()
    kernels = {name: row[0] for name, row in table.items()}
    floor = launch_floor_ms(dev, build)
    with torch.inference_mode():
        rows = kernel_phase(dev)
        rows["conv_down2_bn_leaky"] = conv_kernel_phase(dev)
        rows.update(frcnn_kernel_phase(dev))
    emit({"phase": "kernels_vs_plain", "nvidia_smi": smi,
          "launch_floor_ms": floor, "rows": rows})

    model, predictor, images, launches, head_out = main_path_phase(dev, kernels)
    launches["conv"] = conv_path_phase(dev, kernels, model, predictor, images, head_out)
    serving_phase(dev, predictor)
    launches["evaluate"] = evaluate_phase(dev, kernels, model)
    codec_phase()
    launches["evaluate_files"] = evaluate_files_phase(dev, kernels)
    from viddet_tpu_torch.data.names import COCO_CLASSES as classes

    launches["http"] = http_phase(dev, kernels, model, classes, predictor)
    launches.update(stream_phase(dev, kernels, predictor))
    launches.update(video_phase(dev, kernels, model, classes, predictor))
    launches.update(mp4_phase(dev, kernels, model, classes, predictor))
    launches["detect"] = detect_phase(dev, kernels, model, classes, predictor)
    del model, predictor, images, head_out
    launches["temporal"], temporal_rows = temporal_phase(dev, kernels)
    launches["ssd"], ssd_rows = ssd_phase(dev, kernels)
    rows["topk_indices"]["ssd_shapes"] = {
        name: {"shape": ssd_rows[name]["shape"], "ms": ssd_rows[name]["ms"],
               "library_ms": ssd_rows[name]["library_ms"],
               "bound_ms": ssd_rows[name]["bound"][0]} for name in ("stage1", "stage2")}
    # each kernel's row at the shapes of the later paths that launch it
    for path, path_rows in (("temporal", temporal_rows), ("ssd", ssd_rows)):
        for name, row in path_rows.items():
            if name in table:
                rows[name].setdefault("on_paths", {})[path] = {
                    key: row[key] for key in ("ms", "plain_ms", "library_ms")
                } | {"bound_ms": row["bound"][0], "bound_by": row["bound"][1]}
    frcnn_predictor, launches["frcnn"] = frcnn_path_phase(dev, kernels)
    serving_phase(dev, frcnn_predictor, FRCNN_MODEL, FRCNN_SIZE, requests=8)
    del frcnn_predictor
    torch.cuda.empty_cache()  # the children's memory
    launches.update(child_phases("mpeg4_bvop")["launches"])
    launches.update(child_phases("webm")["launches"])
    launches.update(child_phases("train")["launches"])
    child = child_phases("detector_train")
    launches.update(child["launches"])
    k5_rows = child["k5_rows"]
    for path, row in k5_rows.items():
        rows["nms_keep_mask"].setdefault("on_paths", {})[path] = {
            key: row[key] for key in ("ms", "plain_ms", "library_ms")
        } | {"bound_ms": row["bound"][0], "bound_by": row["bound"][1]}
    launches.update(child_phases("int8_and_export")["launches"])
    launches.update(child_phases("data_parallel")["launches"])
    emit({"phase": "profiler", "incomplete_windows": INCOMPLETE_WINDOWS,
          "windows_with_spins_lost": len(SPINS_LOST), "spins_lost": SPINS_LOST})
    # every phase, the kernels' build and the child processes included
    emit({"phase": "script", "seconds": time.perf_counter() - t_script})

    emit({"kernels": [
        {"name": name, "route": "cuda", "source": f"viddet_tpu_torch/csrc/{src}",
         "replaces": f"viddet_tpu/ops/{tpu}", "path": path, "launches": launches[path][name],
         "launches_by_path": {p: n[name] for p, n in launches.items() if n[name]},
         "max_abs_err": rows[name]["max_abs_err"], "ms": rows[name]["ms"],
         "plain_ms": rows[name]["plain_ms"], "bound_ms": rows[name]["bound"][0],
         "bound_by": rows[name]["bound"][1], "bound_peak": rows[name]["bound"][2],
         "library_ms": rows[name]["library_ms"],
         **{key: rows[name][key] for key in ("parts_ms", "queued_ms", "library_queued_ms",
                                             "ssd_shapes", "on_paths") if key in rows[name]},
         **({"batch_128": {key: rows[f"{name}_b128"][key] for key in ("ms", "queued_ms")}
             | {"bound_ms": rows[f"{name}_b128"]["bound"][0]}}
            if f"{name}_b128" in rows else {})}
        for name, (_, src, tpu, path) in table.items()
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == CHILD_FLAG and sys.argv[2] in CHILD_GROUPS:
        sys.exit(child_main(sys.argv[2]))
    sys.exit(main())
