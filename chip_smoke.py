#!/usr/bin/env python3
"""Drive the PyTorch port (``viddet_tpu_torch``) on one CUDA card and check it.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, each printed as one JSON line:

1. device:  the card's name and power limit (``nvidia-smi``);
2. build:   compile the hand-written kernels from ``viddet_tpu_torch/csrc``;
3. kernels: each kernel against its plain PyTorch version on the card, at
            the main path's shapes plus edge cases, with its time, the plain
            version's time, a PyTorch library call's time where one computes
            the same function, and its bound;
4. main path: YOLOv3-416 / Darknet-53 / COCO at full width in bf16 with
            seeded weights, batch 32, through ``make_predictor``; the kernel
            launch counts of that one call; the kernel tail equal to the
            plain tail on the same head outputs; time per batch and frames/s
            at batch 32 and 128;
5. serving: ``DetectionService`` answers 16 requests from 4 threads, each
            equal to the direct batched call;
6. kernels: one line listing every ported kernel;
then the card's ``nvidia-smi`` line and, last, ``{"ok": true, "device": ...}``.

Any failed check raises, and the script exits non-zero without that last
line.  It needs no network and imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet), for the bound of each kernel.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12  # outside the tensor cores; also used for int32 compares
B, N, K, PAIRS, TOPK, POST = 32, 10647, 400, 32000, 400, 100
CELLS = (169, 676, 2704)  # 13x13, 26x26, 52x52 at 416 px
NA, NUM_PRED = 3, 85
K1_MAX_ULP = 0  # every chip run measured 0
MODEL, IMAGE_SIZE, E2E_BATCHES = "yolo3_darknet53_coco", 416, (32, 128)


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


def bound_ms(nbytes: float, ops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def equal(a, b) -> bool:
    import torch

    return a.shape == b.shape and bool(torch.equal(a, b))


# ---------------------------------------------------------------------------
# Phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------


def kernel_phase(dev):
    import torch

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
    for name, x in (("stage1", hard_rows(stage1)), ("stage2", hard_rows(pair))):
        got = topk_cuda.topk_indices(x, K)
        want = topk_cuda.topk_indices_plain(x, K)
        check(equal(got, want), f"K2 {name} equal to plain")
        check(bool((got[:, 1:] > got[:, :-1]).all()), f"K2 {name} ascending")
        k2[name] = dict(
            bound=bound_ms(x.numel() * 4 + B * K * 8, x.numel() * 34),  # 31 + 3 passes
            **timings(lambda: topk_cuda.topk_indices(x, K),
                      lambda: topk_cuda.topk_indices_plain(x, K),
                      lambda: torch.topk(x, K, dim=1, sorted=False)),
        )
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

    rows["topk_indices"] = dict(  # per main-path batch: both calls
        max_abs_err=0.0, per_call=k2,
        **{key: sum(v[key] for v in k2.values())
           for key in ("ms", "plain_ms", "library_ms", "call_ms", "plain_call_ms",
                       "library_call_ms")},
        bound=bound_ms(sum(x.numel() * 4 + B * K * 8 for x in (stage1, pair)),
                       sum(x.numel() * 34 for x in (stage1, pair))),
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
        # the bound counts bytes and operations only; the K dependent steps
        # of the greedy scan, which bound the kernel, are not in it
        max_abs_err=0.0, serial_steps=K,
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


# ---------------------------------------------------------------------------
# Phase 4: the main path
# ---------------------------------------------------------------------------

# Kernel-name substrings per group, for the main path's device-time breakdown.
KERNEL_GROUPS = (
    ("port kernels", ("anchor_scores_kernel", "topk_select_kernel", "gather_decode_kernel",
                      "nms_keep_kernel", "compact_kernel")),
    ("convolution", ("conv", "gemm", "xmma", "cutlass", "sm90", "implicit", "winograd")),
    ("batch_norm", ("batch_norm",)),
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

    for fn in kernels.values():
        fn.launches = 0
    ids, scores, boxes = predictor(batch)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in kernels.items()}
    check(all(n > 0 for n in launches.values()), f"every kernel launched: {launches}")
    kept = check_detections(ids, scores, boxes, main_b, len(classes), NMSConfig().valid_thresh)

    # The head once; its outputs through the kernel tail and the plain tail.
    with torch.inference_mode():
        mean, std = (torch.as_tensor(v, device=dev) for v in (IMAGENET_MEAN, IMAGENET_STD))
        x = (batch.float() / 255.0 - mean) / std  # as make_predictor does
        out = model(x)
        tails = {b: multiclass_nms_late_decode_cells(out["raws_cells"], out["meta"], backend=b)
                 for b in ("auto", "plain")}
        check(all(equal(a, b) for a, b in zip(tails["auto"], tails["plain"])),
              "kernel tail equal to plain tail")
        check(all(equal(a, b) for a, b in zip(tails["auto"], (ids, scores, boxes))),
              "predictor equal to head + kernel tail")
        head_ms = median_ms(lambda: model(x), reps=10)
        tail_ms = median_ms(lambda: multiclass_nms_late_decode_cells(
            out["raws_cells"], out["meta"], backend="auto"), reps=10)
        plain_tail_ms = median_ms(lambda: multiclass_nms_late_decode_cells(
            out["raws_cells"], out["meta"], backend="plain"), reps=5)
    step_ms = median_ms(lambda: predictor(batch), reps=10)  # images already on the card
    breakdown = kernel_breakdown(lambda: predictor(batch))
    breakdown["step_ms"] = step_ms
    breakdown["idle_share"] = 1.0 - breakdown["device_ms"] / step_ms

    timings = {}
    for bs in E2E_BATCHES:
        host = images[:bs]

        def step():
            return [t.cpu() for t in predictor(host.to(dev, non_blocking=True))]

        for _ in range(2):
            step()
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for _ in range(10 if bs == main_b else 5):
            t = time.perf_counter()
            step()
            walls.append((time.perf_counter() - t) * 1e3)
        ms = statistics.median(walls)
        timings[str(bs)] = dict(ms_per_batch=ms, frames_per_s=bs / ms * 1e3,
                                peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    emit({"phase": "main_path", "model": MODEL, "size": IMAGE_SIZE,
          "dtype": "bfloat16", "batch": main_b, "setup_s": setup_s, "launches": launches,
          "kept_detections": kept, "tail_equal_plain": True,
          "head_ms": head_ms, "tail_ms": tail_ms, "plain_tail_ms": plain_tail_ms,
          "end_to_end": timings, "device_breakdown": breakdown})
    return model, predictor, launches


# ---------------------------------------------------------------------------
# Phase 5: serving
# ---------------------------------------------------------------------------


def serving_phase(dev, predictor):
    import torch

    from viddet_tpu_torch.data.transforms import ValTransform, invert_affine_to_boxes
    from viddet_tpu_torch.infer.service import DetectionService

    bs = 8
    rng = np.random.default_rng(1)
    sizes = [(480, 640), (360, 500), (416, 416), (600, 400)]
    frames = [rng.integers(0, 256, sizes[i % 4] + (3,), dtype=np.uint8) for i in range(16)]
    transform = ValTransform((IMAGE_SIZE, IMAGE_SIZE), normalize=False)

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
    emit({"phase": "serving", "requests": len(frames), "threads": 4, "batch_size": bs,
          "wall_s": wall, "stats": stats, "all_equal_direct": True})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from viddet_tpu_torch.kernels import build
    from viddet_tpu_torch.ops import nms_cuda, nms_gather_cuda, topk_cuda

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

    kernels = {
        "anchor_scores": nms_gather_cuda.anchor_scores,
        "topk_indices": topk_cuda.topk_indices,
        "gather_decode_pairs": nms_gather_cuda.gather_decode_pairs,
        "nms_keep_mask": nms_cuda.nms_keep_mask,
        "compact_and_pad": nms_cuda.compact_and_pad,
    }
    with torch.inference_mode():
        rows = kernel_phase(dev)
    emit({"phase": "kernels_vs_plain", "nvidia_smi": smi, "rows": rows})

    _, predictor, launches = main_path_phase(dev, kernels)
    serving_phase(dev, predictor)

    meta = {
        "anchor_scores": ("viddet_tpu_torch/csrc/anchor_scores.cu",
                          "viddet_tpu/ops/nms_gather_pallas.py:611"),
        "topk_indices": ("viddet_tpu_torch/csrc/topk_select.cu",
                         "viddet_tpu/ops/topk_pallas.py:237"),
        "gather_decode_pairs": ("viddet_tpu_torch/csrc/gather_decode.cu",
                                "viddet_tpu/ops/nms_gather_pallas.py:698"),
        "nms_keep_mask": ("viddet_tpu_torch/csrc/nms.cu", "viddet_tpu/ops/nms_pallas.py:212"),
        "compact_and_pad": ("viddet_tpu_torch/csrc/nms.cu", "viddet_tpu/ops/nms_pallas.py:156"),
    }
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": meta[name][0], "replaces": meta[name][1],
         "launches": launches[name], "max_abs_err": rows[name]["max_abs_err"],
         "ms": rows[name]["ms"], "plain_ms": rows[name]["plain_ms"],
         "bound_ms": rows[name]["bound"][0], "bound_by": rows[name]["bound"][1],
         "library_ms": rows[name]["library_ms"]}
        for name in kernels
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
