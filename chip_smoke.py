#!/usr/bin/env python3
"""Drive the PyTorch port (``viddet_tpu_torch``) on one CUDA card and check it.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, each printed as one JSON line:

1. device:  the card's name and power limit (``nvidia-smi``);
2. build:   compile the hand-written kernels from ``viddet_tpu_torch/csrc``;
3. kernels: each kernel against its plain PyTorch version on the card, at
            the main paths' shapes plus edge cases (K7, K5 at K = 1000 and
            K2 at N = 24,000 at the Faster R-CNN path's), with its time, the
            plain version's time, a PyTorch library call's time where one
            computes the same function, and its bound;
4. main path: YOLOv3-416 / Darknet-53 / COCO at full width in bf16 with
            seeded weights, batch 32, through ``make_predictor`` under the
            default (hierarchical) ranking; the kernel launch counts of that
            one call; the kernel tail equal to the plain tail on the same
            head outputs; then the deterministic tail
            (``VIDDET_PAIR_TOPK=det``) on those head outputs, its launch
            counts and its equality to its plain tail; time per batch and
            frames/s at batch 32 and 128;
5. conv:    the same model under ``VIDDET_CONV_BACKEND=pallas`` (K8 on the
            three shallow downsamples), its launch counts, well-formed
            detections, head outputs close to the default path's, frames/s
            at batch 32;
6. serving: ``DetectionService`` answers 16 requests from 4 threads, each
            equal to the direct batched call;
7. frcnn:   Faster R-CNN ResNet-50 FPN / COCO at full width (512 px, batch
            8, bf16, seeded weights) through ``make_predictor``: its kernel
            launch counts (K7 once, K5 twice, K2 and K6 once), the kernel
            tail equal to the plain tail on the same head outputs and
            proposals, the head outputs under the plain ROIAlign close to
            the kernel's, K7 on the path's own pyramid and proposals, time
            per batch, frames/s, peak memory and a device breakdown; then
            ``DetectionService`` answers 8 requests, each equal to the direct
            call;
8. kernels: one line listing every ported kernel;
then the card's ``nvidia-smi`` line and, last, ``{"ok": true, "device": ...}``.

Any failed check raises, and the script exits non-zero without that last
line.  It needs no network and imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet), for the bound of each kernel.  Each
# row names the operation peak it uses.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12  # outside the tensor cores; also used for int32 compares
BF16_TC_OPS_PER_S = 989e12  # dense bf16 on the tensor cores
PEAKS = {"f32": F32_OPS_PER_S, "bf16_tensor": BF16_TC_OPS_PER_S}
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
# K7 against its plain version on unit-scale features: the two share every
# float expression and its order (csrc/roi_align.cu), so the bound is far
# above what a difference of summation order could give.
ROI_ALIGN_ATOL = 1e-5
# Head outputs under the kernel ROIAlign against the plain one: relative L2
# per output.  Equal ROIAlign outputs give 0; the limit admits the bf16
# rounding of the box head (a relative 2**-9 per rounding) over a few
# differently rounded inputs.
FRCNN_HEAD_REL_L2 = 1e-3

# Launches per main-path batch of each path; a kernel missing from a path
# must not launch there.
HIER_LAUNCHES = {"anchor_scores": 1, "topk_indices": 2, "gather_decode_top_m": 1,
                 "finalize_candidates": 1, "nms_keep_mask": 1, "compact_and_pad": 1}
DET_LAUNCHES = {"anchor_scores": 1, "topk_indices": 2, "gather_decode_pairs": 1,
                "nms_keep_mask": 1, "compact_and_pad": 1}
CONV_LAUNCHES = dict(HIER_LAUNCHES, conv_down2_bn_leaky=3)
FRCNN_LAUNCHES = {"multilevel_roi_align": 1, "nms_keep_mask": 2, "topk_indices": 1,
                  "compact_and_pad": 1}


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


def device_ms(fn, reps: int = 10):
    """Device time per call of ``fn``: the time of the kernels it runs as
    torch.profiler records them, or None when it records none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA)
    return total_us / 1e3 / reps if total_us > 0 else None


def timings(kernel, plain, library=None, plain_reps: int = 10) -> dict:
    """``ms`` / ``plain_ms`` / ``library_ms``: device time per call (the
    profiler's; CUDA events where it records nothing, named in ``timer``).
    ``*call_ms``: CUDA-event time per call, launch overhead included."""
    out = {"library_ms": None}
    for key, fn, reps in (("", kernel, 20), ("plain_", plain, plain_reps),
                          ("library_", library, 20)):
        if fn is None:
            continue
        call = median_ms(fn, reps=reps)
        dev = device_ms(fn, reps=min(reps, 10))
        out[f"{key}call_ms"] = call
        out[f"{key}ms"] = call if dev is None else dev
        out[f"{key}timer"] = "events" if dev is None else "profiler"
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

    # K1: per-scale bf16 cell tensors of the 416-px head; an f32 copy too.
    cells = [torch.randn((B, c, NA * NUM_PRED), generator=g).mul_(3).to(dev, torch.bfloat16)
             for c in CELLS]
    worst_ulp, worst_abs = 0, 0.0
    for xs in (cells, [c.float() for c in cells]):
        got = nms_gather_cuda.anchor_scores(xs, NA)
        want = nms_gather_cuda.anchor_scores_plain(xs, NA)
        check(got.shape == (B, N), "K1 shape")
        ulp = (got.view(torch.int32).long() - want.view(torch.int32).long()).abs().max().item()
        worst_ulp = max(worst_ulp, int(ulp))
        worst_abs = max(worst_abs, float((got - want).abs().max().item()))
    check(worst_ulp <= K1_MAX_ULP, f"K1 within {K1_MAX_ULP} ulp (max {worst_ulp})")
    k1_bytes = sum(c.numel() * 2 for c in cells) + B * N * 4
    rows["anchor_scores"] = dict(
        max_abs_err=worst_abs, max_ulp=worst_ulp,
        bound=bound_ms(k1_bytes, B * N * (NUM_PRED - 5 + 8)),
        **timings(lambda: nms_gather_cuda.anchor_scores(cells, NA),
                  lambda: nms_gather_cuda.anchor_scores_plain(cells, NA),
                  lambda: [torch.sigmoid(c.view(B, -1, NA, NUM_PRED)[..., 5:].amax(-1))
                           for c in cells]),
    )
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

    def k2_case(name, x):
        got = topk_cuda.topk_indices(x, K)
        want = topk_cuda.topk_indices_plain(x, K)
        check(equal(got, want), f"K2 {name} equal to plain")
        check(bool((got[:, 1:] > got[:, :-1]).all()), f"K2 {name} ascending")
        k2[name] = dict(
            width=x.shape[1],
            bound=bound_ms(x.numel() * 4 + B * K * 8, x.numel() * 34),  # 31 + 3 passes
            **timings(lambda: topk_cuda.topk_indices(x, K),
                      lambda: topk_cuda.topk_indices_plain(x, K),
                      lambda: torch.topk(x, K, dim=1, sorted=False)),
        )

    k2_case("stage1", hard_rows(stage1))
    k2_case("stage2_det", hard_rows(pair))
    # K3: the stage-1 winners of those heads in lax.top_k order, as the tail
    # ranks them, plus repeats and the first and last flat index.
    meta = tuple((c, int(round(c ** 0.5)), s, a)
                 for c, s, a in zip(CELLS, STRIDES_DARKNET53, ANCHORS_DARKNET53))
    a_idx = _pair_top_k_det(stage1, K)[1].contiguous()
    a_idx[1, :K // 2] = a_idx[1, K // 2:]
    a_idx[2, 0], a_idx[2, 1] = 0, N - 1
    worst_abs = 0.0
    for xs in (cells, [c.float() for c in cells]):
        got3 = nms_gather_cuda.gather_decode_pairs(xs, a_idx, meta)
        want3 = nms_gather_cuda.gather_decode_pairs_plain(xs, a_idx, meta)
        check(got3[0].shape == (B, K, 4) and got3[1].shape == (B, K, NUM_PRED - 5), "K3 shape")
        check(all(equal(a, b) for a, b in zip(got3, want3)), "K3 equal to plain")
        worst_abs = max(worst_abs, max(float((a - b).abs().max().item())
                                       for a, b in zip(got3, want3)))
    rows["gather_decode_pairs"] = dict(
        max_abs_err=worst_abs,
        # each winner's 5+C bf16 lanes and its index read, boxes and pairs
        # written; 4 operations per class lane, about 30 for the box
        bound=bound_ms(B * K * (NUM_PRED * 2 + 8) + B * K * (4 + NUM_PRED - 5) * 4,
                       B * K * ((NUM_PRED - 5) * 4 + 30)),
        **timings(lambda: nms_gather_cuda.gather_decode_pairs(cells, a_idx, meta),
                  lambda: nms_gather_cuda.gather_decode_pairs_plain(cells, a_idx, meta)),
    )

    # K3, extract_m=9 (the hierarchical form): winners in K2's ascending
    # order, as the hierarchical tail passes them, with the repeat and
    # first/last-index rows above, and image 3 made so that its boxes tie on
    # their 9th value (objectness all equal, class logits on three levels).
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
        check([tuple(t.shape) for t in got9] == [(B, K, 4), (B, K, TOP_M), (B, K, TOP_M),
                                                 (B, HOT_J, C), (B, 1, HOT_J)], "K3-m9 shapes")
        check(all(equal(a, b) for a, b in zip(got9, want9)), "K3-m9 equal to plain")
        worst_abs = max(worst_abs, max(float((a - b).abs().max().item())
                                       for a, b in zip(got9, want9)))
        ninth = got9[1][3, :, TOP_M - 1]
        ninth_ties = max(ninth_ties, int((ninth == ninth[got9[4][3, 0, -1]]).sum().item()))
    check(ninth_ties > HOT_J, f"K3-m9: image 3 ties on the 9th value ({ninth_ties} boxes)")
    a_hier = topk_cuda.topk_indices(stage1, K)  # the main path's winners, ascending
    rows["gather_decode_top_m"] = dict(
        max_abs_err=worst_abs, ninth_value_ties=ninth_ties,
        # each winner's 5+C bf16 lanes and its index read; boxes, v_m, i_m
        # and the hot rows and ids written; per winner 4 operations a class
        # lane, about 30 for the box, 2 a class lane per top-m step, and 3
        # a pair of the per-image rank
        bound=bound_ms(B * K * (NUM_PRED * 2 + 8) + B * K * (16 + TOP_M * 12)
                       + B * HOT_J * (C * 4 + 8),
                       B * K * (C * 4 + 30 + TOP_M * C * 2) + B * K * K * 3),
        **timings(lambda: nms_gather_cuda.gather_decode_top_m(cells, a_hier, meta, TOP_M, HOT_J),
                  lambda: nms_gather_cuda.gather_decode_pairs_plain(cells, a_hier, meta, TOP_M,
                                                                    HOT_J)),
    )

    # K4: the main path's merged stage-2 ranking of those heads, with winners
    # forced into both sections (the first and last of each).
    boxes_k, v_m, i_m, hot_flat, hot_idx = nms_gather_cuda.gather_decode_top_m(
        cells, a_hier, meta, TOP_M, HOT_J)
    width = K * (TOP_M - 1)
    merged = torch.cat([v_m[..., : TOP_M - 1].reshape(B, width), hot_flat.reshape(B, -1)], 1)
    k2_case("stage2_hier", hard_rows(merged))  # its -1.0 sentinels kept
    q = _pair_top_k_det(merged, TOPK)[1].contiguous()
    from_repair = int((q >= width).sum().item())
    q[0, :4] = torch.tensor([0, width - 1, width, width + HOT_J * C - 1], device=dev)
    got4 = nms_gather_cuda.finalize_candidates(i_m, hot_idx, q, boxes_k, C)
    want4 = nms_gather_cuda.finalize_candidates_plain(i_m, hot_idx, q, boxes_k, C)
    check(all(equal(a, b) for a, b in zip(got4, want4)), "K4 equal to plain")
    rows["finalize_candidates"] = dict(
        max_abs_err=max(float((a - b).abs().max().item()) for a, b in zip(got4, want4)),
        main_path_winners_from_repair=from_repair,
        # per winner: q, one class id or hot id, one box read; class, box written
        bound=bound_ms(B * TOPK * (8 + 8 + 16 + 4 + 16), B * TOPK * 10),
        **timings(lambda: nms_gather_cuda.finalize_candidates(i_m, hot_idx, q, boxes_k, C),
                  lambda: nms_gather_cuda.finalize_candidates_plain(i_m, hot_idx, q, boxes_k, C)),
    )

    main_calls = [k2[name] for name in ("stage1", "stage2_hier")]
    rows["topk_indices"] = dict(  # per main-path (hierarchical) batch: both calls
        max_abs_err=0.0, per_call=k2,
        **{key: sum(v[key] for v in main_calls)
           for key in ("ms", "plain_ms", "library_ms", "call_ms", "plain_call_ms",
                       "library_call_ms")},
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
    round_ns = scan_round_ns(dev, build)
    rows["nms_keep_mask"] = dict(
        # ``bound`` counts bytes and operations only; the K dependent rounds
        # of the greedy scan bound the kernel, and ``serial_bound_ms`` is K
        # times one round's latency as csrc/latency_probe.cu measures it
        max_abs_err=0.0, serial_steps=K, scan_round_ns=round_ns,
        serial_bound_ms=K * round_ns * 1e-6,
        bound=bound_ms(B * K * (16 + 1 + 4), B * pairs * 24),
        **timings(lambda: nms_cuda.nms_keep_mask(offset, valid, 0.45),
                  lambda: nms_cuda.nms_keep_mask_plain(offset, valid, 0.45), plain_reps=5),
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
                  lambda: nms_cuda.compact_and_pad_plain(keep, scores, cls, boxes, POST)),
    )
    return rows


def scan_round_ns(dev, build) -> float:
    """Latency of one dependent round of K5's greedy scan, in ns: the probe
    timed at 1 and 101 passes of K rounds, the difference over 100 K."""
    import torch

    lib = build.library()
    out = torch.empty(32, dtype=torch.int64, device=dev)

    def run(passes):
        build.check(lib.viddet_scan_round_probe(K, passes, out.data_ptr(), build.stream_of(out)),
                    "scan_round_probe")

    one, many = median_ms(lambda: run(1)), median_ms(lambda: run(101))
    return (many - one) / (100 * K) * 1e6


def conv_kernel_phase(dev) -> dict:
    """K8 at the three Darknet-53 layers it takes at batch 32 and 416 px and
    at one narrow edge shape, in bf16 and float32, against its plain
    version; times summed over the three layers (and the kernel's and the
    library call's per layer), with the present
    ``ConvBNLeaky`` path (cuDNN convolution, BatchNorm, leaky ReLU) as the
    library call."""
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
                               **k8_compare(got, conv_cuda.conv_down2_bn_leaky_plain(*xa),
                                            x, args[1], a)))
        if b != B:
            continue
        layer = ConvBNLeaky(cin, cout, 3, stride=2).to(dev).eval()
        layer.conv.weight.copy_(args[1])
        for p, v in zip((layer.bn.weight, layer.bn.bias, layer.bn.running_mean,
                         layer.bn.running_var), args[2:]):
            p.copy_(v)
        kernel_fns.append(lambda args=args: conv_cuda.conv_down2_bn_leaky(*args))
        plain_fns.append(lambda args=args: conv_cuda.conv_down2_bn_leaky_plain(*args))
        library_fns.append(lambda layer=layer, x=args[0]: layer(x))
        per_layer.append(dict(shape=[b, cin, cout, hw],
                              **timings(kernel_fns[-1], None, library_fns[-1])))
        m = b * (hw // 2) ** 2
        nbytes += b * hw * hw * cin * 2 + 9 * cin * cout * 2 + cout * 8 + m * cout * 2
        ops += 2 * m * cout * 9 * cin
    worst = max(checks, key=lambda r: r["max_abs_err"])
    return dict(
        max_abs_err=worst["max_abs_err"], checks=checks, per_layer=per_layer,
        bound=bound_ms(nbytes, ops, "bf16_tensor"),
        **timings(lambda: [f() for f in kernel_fns], lambda: [f() for f in plain_fns],
                  lambda: [f() for f in library_fns], plain_reps=5),
        library="ConvBNLeaky default path: F.pad, cuDNN F.conv2d, F.batch_norm, F.leaky_relu",
    )


def roi_align_cells(pyramid, rois, strides) -> int:
    """The distinct pyramid cells (image, level, row, column) that the
    rois' valid samples read: what this run's data needs read."""
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

    def taps(coord, ext):
        ok = (coord > -1.0) & (coord < ext.float())
        c0 = torch.minimum(coord.clamp_min(0.0), ext.float() - 1.0).floor().long()
        return ok, c0, torch.minimum(c0 + 1, ext - 1)

    oky, y0, y1 = taps(ys, hs)
    okx, x0, x1 = taps(xs, ws)
    base = (torch.arange(b, device=dev)[:, None] * sum(sizes) + offsets[lvl])[..., None, None]
    ok = oky[..., :, None] & okx[..., None, :]
    cells = [(base + (yi * ws)[..., :, None] + xi[..., None, :])[ok]
             for yi in (y0, y1) for xi in (x0, x1)]
    return int(torch.unique(torch.cat(cells)).numel())


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


def frcnn_kernel_phase(dev, round_ns) -> dict:
    """K7 at the Faster R-CNN path's shapes (P2..P5 of batch 8 at 512 px,
    300 rois an image, C = 256) on unit-scale features in bf16 and float32;
    K5 at K = 1000 (class-agnostic proposal NMS, IoU 0.7); K2 at the
    detection ranking's N = 24,000, k = 400."""
    import torch

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
        err = float((got - want).abs().max().item())
        checks.append(dict(dtype=str(pyr[0].dtype).split(".")[-1], max_abs_err=err,
                           bit_equal=equal(got, want)))
        check(err <= ROI_ALIGN_ATOL, f"K7 within {ROI_ALIGN_ATOL} of plain: {checks[-1]}")
    cells = roi_align_cells(pyr16, rois, strides)
    out_bytes = FRCNN_B * FRCNN_R * 49 * FPN_C * 4
    pyramid_bytes = sum(p.numel() * 2 for p in pyr16)
    rows = {"multilevel_roi_align": dict(
        max_abs_err=max(c["max_abs_err"] for c in checks), checks=checks,
        levels=torch.bincount(levels.flatten(), minlength=6)[2:].tolist(),
        cells_read=cells,
        # the output, the cells the valid samples read (bf16) and the rois
        # once; about 36 operations an output element (4 samples of 4
        # products and 3 sums, 3 sums and a scale)
        bound=bound_ms(out_bytes + cells * FPN_C * 2 + rois.numel() * 4,
                       out_bytes / 4 * 36),
        bound_output_only_ms=out_bytes / HBM_BYTES_PER_S * 1e3,
        bound_whole_pyramid_ms=(out_bytes + pyramid_bytes) / HBM_BYTES_PER_S * 1e3,
        **timings(lambda: roi_align_cuda.multilevel_roi_align(pyr16, rois, strides),
                  lambda: multilevel_roi_align_packed(pyr16, rois, strides), plain_reps=5),
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
        max_abs_err=0.0, k=k, kept_per_image=got.sum(1).int().tolist(), serial_steps=k,
        serial_bound_ms=k * round_ns * 1e-6,
        bound=bound_ms(FRCNN_B * k * (16 + 1 + 4), FRCNN_B * k * (k - 1) // 2 * 24),
        **timings(lambda: nms_cuda.nms_keep_mask(boxes, valid, 0.7),
                  lambda: nms_cuda.nms_keep_mask_plain(boxes, valid, 0.7), plain_reps=3),
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
        bound=bound_ms(probs.numel() * 4 + FRCNN_B * FRCNN_TOPK * 8, probs.numel() * 34),
        **timings(lambda: topk_cuda.topk_indices(probs, FRCNN_TOPK),
                  lambda: topk_cuda.topk_indices_plain(probs, FRCNN_TOPK),
                  lambda: torch.topk(probs, FRCNN_TOPK, dim=1, sorted=False)),
    )
    return rows


# ---------------------------------------------------------------------------
# Phase 4: the main path
# ---------------------------------------------------------------------------

# Kernel-name substrings per group, for the main path's device-time breakdown.
KERNEL_GROUPS = (
    ("port kernels", ("anchor_scores_kernel", "topk_select_kernel", "gather_decode_kernel",
                      "gather_decode_top_m_kernel", "hot_rows_kernel", "finalize_kernel",
                      "nms_keep_kernel", "compact_kernel", "conv_bf16_kernel",
                      "roi_align_kernel")),
    ("convolution", ("conv", "gemm", "xmma", "cutlass", "sm90", "implicit", "winograd")),
    ("batch_norm", ("batch_norm",)),
    ("sort", ("Sort", "sort")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "leaky", "pad", "copy",
                     "cat", "upsample", "CatArray")),
)


def kernel_breakdown(fn, top: int = 12) -> dict:
    """Device time of one call of ``fn``, by kernel group and top kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    groups: dict = {}
    for e in events:
        group = next((g for g, subs in KERNEL_GROUPS if any(x in e.key for x in subs)), "other")
        groups[group] = groups.get(group, 0.0) + e.self_device_time_total / 1e3
    ranked = sorted(events, key=lambda e: -e.self_device_time_total)[:top]
    return {"device_ms": sum(groups.values()), "groups": groups,
            "top": [[e.key[:90], e.count, e.self_device_time_total / 1e3] for e in ranked]}


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
    from viddet_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
    from viddet_tpu_torch.models.yolo3 import NMSConfig
    from viddet_tpu_torch.models.zoo import get_model
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
        mean, std = (torch.as_tensor(v, device=dev) for v in (IMAGENET_MEAN, IMAGENET_STD))
        x = (batch.float() / 255.0 - mean) / std  # as make_predictor does
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
        tail_device_ms = device_ms(lambda: tail("auto"))

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
            det_tail_device_ms = device_ms(lambda: tail("auto"))
        finally:
            del os.environ["VIDDET_PAIR_TOPK"]
        same_ids = bool(torch.equal(det[0], ids))
    step_ms = median_ms(lambda: predictor(batch), reps=10)  # images already on the card
    breakdown = kernel_breakdown(lambda: predictor(batch))
    breakdown["step_ms"] = step_ms
    breakdown["idle_share"] = 1.0 - breakdown["device_ms"] / step_ms

    timings = {str(bs): end_to_end(dev, predictor, images, bs, 10 if bs == main_b else 5)
               for bs in E2E_BATCHES}
    emit({"phase": "main_path", "model": MODEL, "size": IMAGE_SIZE,
          "dtype": "bfloat16", "batch": main_b, "setup_s": setup_s, "ranking": "hier",
          "launches": launches, "kept_detections": kept, "tail_equal_plain": True,
          "det_tail_equal_plain": True, "det_ids_equal_hier": same_ids,
          "head_ms": head_ms, "tail_ms": tail_ms, "plain_tail_ms": plain_tail_ms,
          "tail_device_ms": tail_device_ms, "det_tail_ms": det_tail_ms,
          "det_plain_tail_ms": det_plain_tail_ms, "det_tail_device_ms": det_tail_device_ms,
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
# Phase 5: the conv-kernel configuration
# ---------------------------------------------------------------------------


def conv_path_phase(dev, kernels, model, predictor, images, head_out) -> dict:
    """``VIDDET_CONV_BACKEND=pallas`` through ``set_conv_backend``: the same
    model and frames at batch 32, its launches (K8 three times), its
    detections, its head outputs against the default path's, frames/s."""
    import torch

    from viddet_tpu_torch.core.platform import set_conv_backend
    from viddet_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
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
            mean, std = (torch.as_tensor(v, device=dev) for v in (IMAGENET_MEAN, IMAGENET_STD))
            out = model((batch.float() / 255.0 - mean) / std)
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
              "launches": launches, "kept_detections": kept, "heads_vs_default": heads,
              "head_rel_l2_limit": CONV_HEAD_REL_L2, "step_ms": step_ms, "end_to_end": timing,
              "default_step_ms_after": default_step_ms, "default_end_to_end_after": default_timing}
    emit(result)
    return launches


# ---------------------------------------------------------------------------
# Phase 7: Faster R-CNN
# ---------------------------------------------------------------------------


def rel_l2(got, want) -> float:
    return float(((got.float() - want.float()).norm() / want.float().norm()).item())


def frcnn_path_phase(dev, kernels):
    """Faster R-CNN ResNet-50 FPN / COCO at 512 px, batch 8, bf16, seeded
    weights, through ``make_predictor``."""
    import dataclasses

    import torch

    from viddet_tpu_torch.cli.common import make_predictor
    from viddet_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
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
        mean, std = (torch.as_tensor(v, device=dev) for v in (IMAGENET_MEAN, IMAGENET_STD))
        x = (batch.float() / 255.0 - mean) / std  # as make_predictor does
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
        check(err <= ROI_ALIGN_ATOL, f"K7 on the path's proposals within {ROI_ALIGN_ATOL}: {err}")
        cells = roi_align_cells(maps, props, strides)
        out_bytes = got.numel() * 4
        k7_path = dict(
            max_abs_err=err, bit_equal=equal(got, want), cells_read=cells,
            levels=torch.bincount(fpn_roi_level(props).flatten(), minlength=6)[2:].tolist(),
            proposals_valid=int(out["proposal_valid"].sum().item()),
            bound=bound_ms(out_bytes + cells * FPN_C * 2 + props.numel() * 4,
                           out_bytes / 4 * 36),
            **timings(lambda: roi_align_cuda.multilevel_roi_align(maps, props, strides),
                      lambda: multilevel_roi_align_packed(maps, props, strides), plain_reps=5))

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
        tail_device_ms = device_ms(lambda: tail("auto"))
    step_ms = median_ms(lambda: predictor(batch), reps=10)  # images already on the card
    breakdown = kernel_breakdown(lambda: predictor(batch))
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from viddet_tpu_torch.kernels import build
    from viddet_tpu_torch.ops import (
        conv_cuda, nms_cuda, nms_gather_cuda, roi_align_cuda, topk_cuda,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    smi = nvidia_smi_line()
    emit({"phase": "device", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    lib = build.build()
    build.library()
    emit({"phase": "build", "library": str(lib.relative_to(build.BUILD_ROOT.parents[1])),
          "seconds": time.perf_counter() - t0})

    # (wrapper, source, the TPU kernel it replaces, the path its launches are read on)
    table = {
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
    kernels = {name: row[0] for name, row in table.items()}
    with torch.inference_mode():
        rows = kernel_phase(dev)
        rows["conv_down2_bn_leaky"] = conv_kernel_phase(dev)
        rows.update(frcnn_kernel_phase(dev, rows["nms_keep_mask"]["scan_round_ns"]))
    emit({"phase": "kernels_vs_plain", "nvidia_smi": smi, "rows": rows})

    model, predictor, images, launches, head_out = main_path_phase(dev, kernels)
    launches["conv"] = conv_path_phase(dev, kernels, model, predictor, images, head_out)
    serving_phase(dev, predictor)
    del model, predictor, images, head_out
    frcnn_predictor, launches["frcnn"] = frcnn_path_phase(dev, kernels)
    serving_phase(dev, frcnn_predictor, FRCNN_MODEL, FRCNN_SIZE, requests=8)

    emit({"kernels": [
        {"name": name, "route": "cuda", "source": f"viddet_tpu_torch/csrc/{src}",
         "replaces": f"viddet_tpu/ops/{tpu}", "path": path, "launches": launches[path][name],
         "launches_by_path": {p: n[name] for p, n in launches.items() if n[name]},
         "max_abs_err": rows[name]["max_abs_err"], "ms": rows[name]["ms"],
         "plain_ms": rows[name]["plain_ms"], "bound_ms": rows[name]["bound"][0],
         "bound_by": rows[name]["bound"][1], "bound_peak": rows[name]["bound"][2],
         "library_ms": rows[name]["library_ms"]}
        for name, (_, src, tpu, path) in table.items()
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
