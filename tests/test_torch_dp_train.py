"""Data-parallel training of the port on the CPU: two gloo processes of one
image each against one process of both images.

The counterpart of ``tests/distributed/test_data_parallel.py`` and
``test_data_parallel_families.py``.  JAX's data parallelism is one SPMD
program over the global batch, so the port's two processes must take the
step that one process with the whole batch takes:

* in float64 compute every parameter and statistic after three steps
  agrees within ``LEAF_RTOL_F64`` (1e-9 of the leaf's largest value) for
  each family; the losses are float32 values (the models' own casts, as in
  JAX) and agree within ``LOSS_RTOL_F32`` (four float32 ulps);
* the two processes' leaves are bit-identical after every step;
* in float32 each family's two-process run holds its JAX fixture at the
  limits and compute dtypes of ``tests/test_torch_train_fixture.py`` and
  ``tests/test_torch_detector_train_fixture.py``;
* with the BatchNorm sync patched out (each process on its own image's
  statistics) the run misses the one-process result by far more than the
  limit, so the sync is what the equality measures;
* Faster R-CNN runs with counts that differ between the processes (a
  roi batch larger than the candidates, an RPN batch larger than the
  anchors, the second image with one box) and its uniforms from a
  generator (the draw rule), so the global denominators and the global
  draws are both what the equality measures;
* ``cli.train_yolov3.main`` on two processes writes its outputs from
  process 0 only and they equal one process at the same global batch:
  in float64 compute, the logged losses as written and every element of
  ``_final.npz`` within one float32 rounding.  (In float32 a BatchNorm
  bias, a gradient that nearly cancels over 32 images, lands 4.4e-2 apart
  after two steps: rounding, which float64 removes.)

Every process and every reference here runs on one torch thread
(``tests/torch_dp_helpers.py``).
"""

import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from tests import torch_dp_helpers as H

LEAF_RTOL_F64 = 1e-9
LOSS_RTOL_F32 = 2.0 ** -21
# Faster R-CNN with counts that differ between the processes
FRCNN_UNEQUAL = dict(cfg={"roi_batch": 128, "rpn_batch": 8192}, drop_boxes=True,
                     generator_seed=7)
FAMILY_KW = {"yolo": {}, "ssd": {}, "frcnn": FRCNN_UNEQUAL}


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(H.THREADS)
    yield
    torch.set_num_threads(threads)


_RUNS: dict = {}


def runs(family: str, tmp_path_factory) -> dict:
    """The family's two-process jobs (each process's results) and the
    one-process float64 reference, once per worker."""
    if family not in _RUNS:
        calls = [(H.steps, (family,), FAMILY_KW[family]), (H.fixture_report, (family,), {})]
        if family == "yolo":
            calls.append((H.steps, (family,), {"sync_bn": False}))
        threads = torch.get_num_threads()
        torch.set_num_threads(H.THREADS)
        try:
            ranks = H.spawn(H.many, 2, tmp_path_factory.mktemp(family), calls)
            ref = H.steps(family, **FAMILY_KW[family])
        finally:
            torch.set_num_threads(threads)
        _RUNS[family] = {"ranks": ranks, "ref": ref}
    return _RUNS[family]


def leaf_gaps(got: dict, want: dict) -> dict:
    assert set(got) == set(want)
    return {k: float(np.abs(got[k] - w).max() / max(np.abs(w).max(), 1e-300))
            for k, w in want.items()}


@pytest.mark.parametrize("family", H.FAMILIES)
def test_two_ranks_equal_one_process_in_float64(family, tmp_path_factory):
    r = runs(family, tmp_path_factory)
    got, want = r["ranks"][0][0], r["ref"]
    for step, (g, w) in enumerate(zip(got["losses"], want["losses"])):
        for k in w:
            assert abs(g[k] - w[k]) <= LOSS_RTOL_F32 * abs(w[k]), (step, k, g[k], w[k])
    gaps = leaf_gaps(got["leaves"], want["leaves"])
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= LEAF_RTOL_F64, (worst, gaps[worst])


@pytest.mark.parametrize("family", H.FAMILIES)
def test_ranks_bit_identical_after_every_step(family, tmp_path_factory):
    a, b = (rank[0] for rank in runs(family, tmp_path_factory)["ranks"])
    assert len(a["digests"]) == 3 and a["digests"] == b["digests"]
    assert a["losses"] == b["losses"]  # the global losses on both


@pytest.mark.parametrize("family", H.FAMILIES)
def test_two_ranks_hold_the_jax_fixture(family, tmp_path_factory):
    """Each process on its image of the fixture's two (Faster R-CNN on its
    rows of JAX's draws), at the one-process tests' limits."""
    a, b = (rank[1] for rank in runs(family, tmp_path_factory)["ranks"])
    assert a == b
    if family == "yolo":
        assert all(a["targets_equal"].values()), a["targets_equal"]
        assert a["loss_max_rel_step1"] <= 1e-5, a
        assert a["loss_max_rel"] <= chip_smoke.TRAIN_LOSS_RTOL, a
        assert a["leaf_max_rel_l2"] <= chip_smoke.TRAIN_LEAF_REL_L2, a
    else:
        chip_smoke.check_detector_fixture(a, family)
        assert a["loss_max_rel_f32_step1"] <= 1e-4 and a["loss_max_rel_f64"] <= 1e-5, a
        assert a["leaf_max_rel_l2_f64"] <= (5e-5 if family == "frcnn" else 1e-3), a


def test_per_process_batch_norm_misses(tmp_path_factory):
    """Each process on its own image's BatchNorm statistics (plain DDP's
    BatchNorm) is not the global step: far outside the limit."""
    r = runs("yolo", tmp_path_factory)
    gaps = leaf_gaps(r["ranks"][0][2]["leaves"], r["ref"]["leaves"])
    assert max(gaps.values()) > 1e3 * LEAF_RTOL_F64, max(gaps.values())
    assert max(gaps.values()) > 1e-3


def test_frcnn_denominators_are_the_global_batchs(tmp_path_factory):
    """The two processes' RPN and head counts differ in every step, and
    each sums to the one process's count."""
    r = runs("frcnn", tmp_path_factory)
    local = [np.asarray(rank[0]["counts"]) for rank in r["ranks"]]
    want = np.asarray(r["ref"]["counts"])
    assert local[0].shape == want.shape == (3, 2)
    assert (local[0] != local[1]).all(), local
    np.testing.assert_array_equal(local[0] + local[1], want)


def test_loader_shards_equal_jax():
    """The port's strided shards are JAX's: the training shards cut to
    their common floor, the evaluation shards with their uneven tails."""
    import viddet_tpu.data.loader as jax_loader
    import viddet_tpu.data.synthetic as jax_synthetic
    import viddet_tpu.data.transforms as jax_transforms
    import viddet_tpu_torch.data.loader as torch_loader
    import viddet_tpu_torch.data.synthetic as torch_synthetic
    import viddet_tpu_torch.data.transforms as torch_transforms

    def indices(synthetic, loader, transforms, shard, train):
        ds = synthetic.SyntheticDetection(num_images=11, size=48, num_classes=4, seed=2)
        tf = (transforms.TrainTransform(size=(32, 32)) if train
              else transforms.ValTransform(size=(32, 32)))
        it = loader.DetectionLoader(ds, tf, batch_size=2, train=train, num_workers=0, seed=5,
                                    shard=shard)
        return len(it), [[int(i) for i in b[5]] for b in it]

    for train in (True, False):
        for shard in ((0, 2), (1, 2), (2, 3)):
            want = indices(jax_synthetic, jax_loader, jax_transforms, shard, train)
            got = indices(torch_synthetic, torch_loader, torch_transforms, shard, train)
            assert got == want, (train, shard)
    assert indices(torch_synthetic, torch_loader, torch_transforms, (0, 2), True)[0] == 2
    assert indices(torch_synthetic, torch_loader, torch_transforms, (0, 2), False)[0] == 3


def _train_argv(prefix: str, batch: int) -> list:
    return ["--platform", "cpu", "--network", "yolo3_tiny_darknet", "--dataset", "synthetic",
            "--data-root", "synthetic", "--data-shape", "64", "--no-random-shape",
            "--batch-size", str(batch), "--epochs", "1", "--num-workers", "1",
            "--log-interval", "1", "--val-interval", "1", "--save-interval", "1",
            "--metrics-jsonl", f"{prefix}_metrics.jsonl", "--save-prefix", prefix]


def test_train_cli_on_two_processes(tmp_path):
    """Two processes of 16 images against one of 32 (two steps, an epoch,
    tiny YOLOv3 in float64 compute): process 0 alone writes the log, the
    metrics, the checkpoint and the ``.npz`` files, the logged losses equal
    the one process's as written (5 decimals) and every element of
    ``_final.npz`` (float32) is within one float32 rounding of it."""
    from viddet_tpu_torch.cli import train_yolov3
    from viddet_tpu_torch.train.state import latest_checkpoint, load_weights_npz

    H.spawn(H.cli, 2, tmp_path, "train_yolov3", _train_argv(f"{tmp_path}/r{{rank}}/y3", 16),
            "yolo3_tiny_darknet")
    train_yolov3.main(_train_argv(f"{tmp_path}/one/y3", 32),
                      built=H.float64_model("yolo3_tiny_darknet"))
    assert not os.path.exists(tmp_path / "r1"), os.listdir(tmp_path / "r1")
    for run in ("r0", "one"):
        prefix = f"{tmp_path}/{run}/y3"
        for suffix in ("_train.log", "_best.npz", "_final.npz", "_metrics.jsonl"):
            assert os.path.exists(prefix + suffix), prefix + suffix
        assert latest_checkpoint(f"{prefix}_ckpt").endswith("step_00000002")

    def records(run):
        with open(f"{tmp_path}/{run}/y3_metrics.jsonl") as f:
            return [json.loads(line) for line in f]

    got, want = records("r0"), records("one")
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2]
    for g, w in zip(got, want):
        assert {k: g[k] for k in chip_smoke.TRAIN_LOSS_NAMES} == \
            {k: w[k] for k in chip_smoke.TRAIN_LOSS_NAMES}
    a, b = (load_weights_npz(f"{tmp_path}/{run}/y3_final.npz") for run in ("r0", "one"))
    assert set(a) == set(b)
    for k, v in b.items():
        np.testing.assert_allclose(a[k], v, rtol=2.0 ** -23, atol=1e-30, err_msg=k)
