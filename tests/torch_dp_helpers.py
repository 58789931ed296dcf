"""Rank bodies of the data-parallel tests and their spawner.

``spawn(job, world, tmp_path, *args)`` starts ``world`` processes (the
``spawn`` start method), each joining a gloo group through a ``file://``
store under ``tmp_path`` (no TCP port), runs ``job(*args)`` in each and
returns their results in process order.  Every process has one torch
thread, as the one-process references of the tests do; the group's
collectives time out after ``GROUP_TIMEOUT_S`` and the parent kills what
still runs after ``SPAWN_TIMEOUT_S``.  This module imports torch, numpy,
``chip_smoke`` and the port only, so the processes start without JAX.

The jobs are module-level functions: ``steps`` (the fixtures' batches
through the train steps, with a digest of every leaf after each step),
``fixture_report`` (``chip_smoke``'s fixture checks), ``cli`` (a CLI's
``main``) and ``basics`` (the collectives of ``parallel/mesh.py`` and the
global BatchNorm on a seeded tensor).
"""

import multiprocessing
import os
import pickle
import time
import traceback
import types

import numpy as np
import torch

SPAWN_TIMEOUT_S = 240.0
GROUP_TIMEOUT_S = 60.0
THREADS = 1
FAMILIES = ("yolo", "ssd", "frcnn")


def spawn(job, world: int, tmp_path, *args, timeout: float = SPAWN_TIMEOUT_S) -> list:
    """``job(*args)`` in ``world`` gloo ranks; their results in rank order.
    A rank's exception fails the call with its traceback."""
    ctx = multiprocessing.get_context("spawn")
    store = os.path.join(str(tmp_path), "store")
    outs = [os.path.join(str(tmp_path), f"rank{r}.pkl") for r in range(world)]
    procs = [ctx.Process(target=_rank_main, args=(job, r, world, store, outs[r], args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join(10)
    assert not alive, f"{len(alive)} of {world} ranks still running after {timeout} s"
    results = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert os.path.exists(out), f"rank {r} exited {p.exitcode} without a result"
        with open(out, "rb") as f:  # written by the rank above
            payload = pickle.load(f)
        assert "error" not in payload, f"rank {r} failed:\n{payload['error']}"
        results.append(payload["result"])
    return results


def _rank_main(job, rank: int, world: int, store: str, out: str, args) -> None:
    torch.set_num_threads(THREADS)
    from viddet_tpu_torch.parallel import mesh

    try:
        mesh.initialize_distributed(f"file://{store}", world, rank, backend="gloo",
                                    timeout_s=GROUP_TIMEOUT_S)
        payload = {"result": job(*args)}
    except BaseException:
        payload = {"error": traceback.format_exc()}
    finally:
        if mesh.active():
            torch.distributed.destroy_process_group()
    with open(out, "wb") as f:
        pickle.dump(payload, f)


# ---------------------------------------------------------------------------
# The training runs
# ---------------------------------------------------------------------------


def load_fixture(family: str) -> dict:
    import chip_smoke

    path = chip_smoke.TRAIN_FIXTURE if family == "yolo" else chip_smoke.DETECTOR_FIXTURES[family]
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def leaf_arrays(model) -> dict:
    """Every parameter and statistic as a float64 numpy copy (``to_flat``
    rounds to float32)."""
    from viddet_tpu_torch.weights import leaves

    return {key: t.detach().double().cpu().numpy().copy() for key, t, _ in leaves(model)}


def _model(family: str, fx: dict, f64: bool, cfg: dict):
    import chip_smoke

    from viddet_tpu_torch.core.precision import FLOAT32_POLICY, Policy
    from viddet_tpu_torch.models.faster_rcnn import FasterRCNN, FRCNNConfig
    from viddet_tpu_torch.models.yolo3 import YOLOv3
    from viddet_tpu_torch.weights import load_flat, seeded_flat

    policy = Policy(torch.float64) if f64 else FLOAT32_POLICY
    if family == "yolo":
        anchors = tuple(tuple((float(w), float(h)) for w, h in s) for s in fx["anchors"])
        model = YOLOv3(num_classes=int(fx["num_classes"]), backbone="tiny", anchors=anchors,
                       strides=tuple(int(s) for s in fx["strides"]), policy=policy)
    elif family == "frcnn" and cfg:
        counts = {str(k): int(v) for k, v in zip(fx["count_names"], fx["counts"])}
        model = FasterRCNN(int(fx["num_classes"]), FRCNNConfig(**{**counts, **cfg}), policy,
                           backbone_blocks=tuple(int(v) for v in fx["backbone_blocks"]),
                           backbone_widths=tuple(int(v) for v in fx["backbone_widths"]))
    else:
        return chip_smoke.detector_fixture_model(fx, torch.device("cpu"), f64)
    model = model.to(dtype=torch.float64 if f64 else torch.float32,
                     memory_format=torch.channels_last)
    load_flat(model, seeded_flat(model, 0))
    return model.train()


def steps(family: str, f64: bool = True, n_steps: int = 3, sync_bn: bool = True,
          cfg: dict | None = None, drop_boxes: bool = False, generator_seed: int | None = None
          ) -> dict:
    """The family's fixture batch (two images) through ``n_steps`` train
    steps, each process on its rows: the global losses of each step, a
    digest of every leaf after each step, the leaves after the last.

    ``sync_bn`` False patches the global BatchNorm out (each process then
    normalizes with its own batch's statistics); ``cfg`` overrides Faster
    R-CNN's counts; ``drop_boxes`` leaves the second image one box;
    ``generator_seed`` draws Faster R-CNN's uniforms from a generator (the
    draw rule) instead of JAX's recorded ones, and the result also holds
    each step's local counts (RPN, head) before the all-reduce."""
    import chip_smoke

    from viddet_tpu_torch.models import common, faster_rcnn
    from viddet_tpu_torch.parallel.mesh import shard_batch
    from viddet_tpu_torch.train.loop import (
        make_frcnn_train_step, make_ssd_train_step, make_train_step,
    )
    from viddet_tpu_torch.train.state import TrainState, make_lr_schedule, make_optimizer

    fx = load_fixture(family)
    model = _model(family, fx, f64, cfg or {})
    state = TrainState(model, make_optimizer(make_lr_schedule(float(fx["lr"]), 1),
                                             momentum=float(fx["momentum"]),
                                             weight_decay=float(fx["weight_decay"])))
    ids = fx["gt_ids"].copy()
    if drop_boxes:
        ids[1, 1:] = -1
    images = torch.from_numpy(fx["images"]).to(torch.float64 if f64 else torch.float32)
    images, boxes, ids = (shard_batch(t) for t in
                          (images, torch.from_numpy(fx["gt_boxes"]), torch.from_numpy(ids)))
    counts = []
    real_denominators = faster_rcnn._loss_denominators

    def recording(rpn_count, head_count):
        counts.append((float(rpn_count), float(head_count)))
        return real_denominators(rpn_count, head_count)

    saved_mesh = common.mesh
    if not sync_bn:
        common.mesh = types.SimpleNamespace(process_count=lambda: 1)
    faster_rcnn._loss_denominators = recording
    try:
        if family == "yolo":
            anchors = tuple(tuple((float(w), float(h)) for w, h in s) for s in fx["anchors"])
            yolo = make_train_step(strides=tuple(int(s) for s in fx["strides"]),
                                   anchors=anchors, num_classes=int(fx["num_classes"]))

            def step(i):
                return yolo(state, images, boxes, ids)[1]
        elif family == "ssd":
            ssd = make_ssd_train_step(model)

            def step(i):
                return ssd(state, images, boxes, ids)[1]
        else:
            frcnn = make_frcnn_train_step(model)
            generator = (None if generator_seed is None
                         else torch.Generator().manual_seed(generator_seed))

            def step(i):
                uniforms = None
                if generator is None:
                    uniforms = tuple(shard_batch(torch.from_numpy(fx[f"{k}_uniform"][i] / 2.0**23)
                                                 .float()) for k in ("roi", "rpn"))
                return frcnn(state, generator, images, boxes, ids, uniforms=uniforms)[1]

        losses, digests = [], []
        for i in range(n_steps):
            out = step(i)
            losses.append({k: float(v) for k, v in out.items()})
            digests.append(chip_smoke.leaf_digest(model))
    finally:
        common.mesh = saved_mesh
        faster_rcnn._loss_denominators = real_denominators
    return {"losses": losses, "digests": digests, "leaves": leaf_arrays(model),
            "counts": counts}


def many(calls) -> list:
    """Several jobs in one process group, in order: ``calls`` is a list of
    (function, args, kwargs)."""
    return [fn(*args, **kwargs) for fn, args, kwargs in calls]


def fixture_report(family: str) -> dict:
    """``chip_smoke``'s fixture run of the family on the CPU (float32; the
    detectors also float64), each process on its rows."""
    import chip_smoke

    if family == "yolo":
        return chip_smoke.train_fixture_run(torch.device("cpu"))
    return chip_smoke.detector_fixture_run(torch.device("cpu"), family)


def cli(module: str, argv: list, float64_network: str = ""):
    """``viddet_tpu_torch.cli.<module>.main(argv)``, ``{rank}`` in an
    argument replaced by the process index.  ``float64_network``: the CLI
    trains that network of ``--dataset synthetic`` in float64 compute
    (``main``'s ``built``), where the CLI alone builds the bf16 default."""
    import importlib

    from viddet_tpu_torch.parallel.mesh import process_index

    main = importlib.import_module(f"viddet_tpu_torch.cli.{module}").main
    argv = [a.replace("{rank}", str(process_index())) for a in argv]
    if not float64_network:
        return main(argv)
    return main(argv, built=float64_model(float64_network))


def float64_model(network: str):
    """(model, class names): ``network`` over the synthetic set's classes in
    float64 compute, ``seeded_flat(model, 233)`` (the train CLIs' default
    seed), on the CPU, in train mode."""
    from viddet_tpu_torch.cli.common import build_model, get_dataset
    from viddet_tpu_torch.core.precision import Policy
    from viddet_tpu_torch.weights import load_flat, seeded_flat

    ds, _ = get_dataset("synthetic", "synthetic")
    model, names = build_model(network, "synthetic", classes=ds.classes, device="cpu",
                               policy=Policy(torch.float64))
    model = model.to(torch.float64)
    load_flat(model, seeded_flat(model, 233))
    return model.train(), names


# ---------------------------------------------------------------------------
# The collectives and the global BatchNorm alone
# ---------------------------------------------------------------------------


def bn_case(seed: int, dtype, channels_last: bool, batch: int = 4, c: int = 5, hw: int = 6):
    """A seeded global batch for ``batch_norm_train``: x, dy, and the
    BatchNorm's scale, bias and running statistics."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(3.0, 2.0, (batch, c, hw, hw))).to(dtype)
    dy = torch.from_numpy(rng.normal(0.0, 1.0, (batch, c, hw, hw))).to(dtype)
    if channels_last:
        x, dy = (t.contiguous(memory_format=torch.channels_last) for t in (x, dy))
    bn = torch.nn.BatchNorm2d(c).to(dtype)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c)))
        bn.bias.copy_(torch.from_numpy(rng.normal(0, 0.5, c)))
        bn.running_mean.copy_(torch.from_numpy(rng.normal(0, 1, c)))
        bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2, c)))
    return x, dy, bn


def bn_run(x, dy, bn) -> dict:
    """``batch_norm_train`` forward, then the backward of sum(y * dy)."""
    from viddet_tpu_torch.models.common import batch_norm_train

    x = x.clone().requires_grad_(True)
    y = batch_norm_train(x, bn)
    (y * dy).sum().backward()
    return {"y": y.detach().numpy(), "dx": x.grad.numpy(),
            "dweight": bn.weight.grad.numpy(), "dbias": bn.bias.grad.numpy(),
            "running_mean": bn.running_mean.numpy(), "running_var": bn.running_var.numpy(),
            "channels_last": y.is_contiguous(memory_format=torch.channels_last)}


def basics(bn_cases) -> dict:
    """What one process sees of the collectives: its index and count, the
    mesh, a second initialization (a no-op), ``replicate`` of a module whose
    values differ by process, the gathered metric states, the gradient
    average, a shard of a global batch, and ``batch_norm_train`` on its
    rows of each (seed, dtype, channels_last) case in ``bn_cases``."""
    from viddet_tpu_torch.cli.common import platform_device
    from viddet_tpu_torch.eval.distributed import gather_states
    from viddet_tpu_torch.parallel import mesh

    rank, world = mesh.process_index(), mesh.process_count()
    mesh.initialize_distributed()  # already up: a logged no-op
    m = mesh.make_mesh(platform_device("cpu"))
    module = torch.nn.Linear(3, 2)
    momentum = torch.full((4,), float(rank + 1))
    with torch.no_grad():
        module.weight.fill_(rank + 1.0)
    mesh.replicate(module, [momentum])
    grads = [torch.full((2, 3), float(rank)), torch.full((5,), 2.0 * rank, dtype=torch.float64)]
    mesh.all_reduce_(grads, mean=True)
    bn = {}
    for seed, dtype, channels_last in bn_cases:
        x, dy, layer = bn_case(seed, dtype, channels_last)
        bn[(seed, str(dtype), channels_last)] = bn_run(mesh.shard_batch(x), mesh.shard_batch(dy),
                                                       layer)
    mesh.barrier()
    return {"rank": rank, "world": world, "mesh": (m.size, m.rank, str(m.device)),
            "replicated": (module.weight.detach().numpy().copy(), momentum.numpy().copy()),
            "states": gather_states({"rank": rank, "records": list(range(rank + 2))}),
            "grads": [g.numpy().copy() for g in grads],
            "rows": mesh.shard_batch(torch.arange(8)).tolist(),
            "uniform": mesh.global_uniform((2, 3), torch.Generator().manual_seed(3), "cpu"),
            "bn": bn}
