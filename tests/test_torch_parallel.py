"""The port's process groups (``viddet_tpu_torch/parallel/mesh.py``) against
the JAX package's ``initialize_distributed`` rule, and its collectives.

The first three tests are ``tests/distributed/test_initialize.py``'s cases
on the port: one process is a clean no-op (twice), and a bad explicit
coordinator or a multi-process marker with a failing initialization raises
"refusing to fall back" rather than training each process alone.  The
rest run two gloo processes (``tests/torch_dp_helpers.py``): the
collectives, ``replicate``, the gathered metric states, the draw rule's
rows and train-mode BatchNorm on the global batch, each process's rows
normalized as one process normalizes the whole batch: float64 within
1e-12 of it (forward, backward, running statistics), float32 within the
merge's rounding (``BN_F32_ATOL``).
"""

import logging

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tests import torch_dp_helpers as H
from viddet_tpu_torch.cli.common import platform_device
from viddet_tpu_torch.parallel import mesh

BN_CASES = [(1, torch.float64, False), (2, torch.float64, True), (3, torch.float32, True)]
BN_F64_RTOL = 1e-12
# float32: the merged mean and M2 against one Welford pass over the batch,
# then the normalization: a few float32 ulps of values of order 10
BN_F32_ATOL = 1e-5


def test_single_process_noop(caplog, monkeypatch):
    for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", *mesh.COUNT_MARKERS):
        monkeypatch.delenv(name, raising=False)
    with caplog.at_level(logging.INFO, logger="viddet_tpu_torch.parallel"):
        mesh.initialize_distributed()
    assert not dist.is_initialized()
    assert any("single-process environment" in r.message for r in caplog.records)
    mesh.initialize_distributed()  # and again, without raising
    assert (mesh.process_index(), mesh.process_count(), mesh.active()) == (0, 1, False)


def test_explicit_bad_coordinator_raises(tmp_path):
    # a process count that no job has; nothing is contacted
    with pytest.raises(RuntimeError, match="refusing to fall back"):
        mesh.initialize_distributed(coordinator_address=f"file://{tmp_path}/store",
                                    num_processes=-3, process_id=0, backend="gloo")
    assert not dist.is_initialized()


def test_cluster_marker_failure_raises(monkeypatch):
    monkeypatch.setenv("SLURM_NTASKS", "4")

    def boom(*args, **kwargs):
        raise RuntimeError("coordinator unreachable")

    monkeypatch.setattr(dist, "init_process_group", boom)
    with pytest.raises(RuntimeError, match="refusing to fall back"):
        mesh.initialize_distributed(backend="gloo")


def test_helpers_are_identities_in_one_process():
    x = torch.arange(6).reshape(3, 2)
    assert mesh.shard_batch(x) is not None and torch.equal(mesh.shard_batch(x), x)
    m = mesh.make_mesh(torch.device("cpu"))
    assert (m.size, m.rank, m.device) == (1, 0, torch.device("cpu"))
    grads = [torch.ones(3)]
    mesh.all_reduce_(grads, mean=True)  # no group: untouched
    assert torch.equal(grads[0], torch.ones(3))
    g = torch.Generator().manual_seed(3)
    assert torch.equal(mesh.global_uniform((2, 3), g, "cpu"),
                       torch.rand((2, 3), generator=torch.Generator().manual_seed(3)))
    batch = mesh.put_batch((np.zeros((2, 4), np.uint8),), m)
    assert batch[0].device.type == "cpu" and batch[0].shape == (2, 4)


def test_platform_device_under_a_group(monkeypatch):
    assert platform_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(mesh, "active", lambda: True)
    monkeypatch.setattr("viddet_tpu_torch.cli.common.active", lambda: True)
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert platform_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert platform_device("gpu") == torch.device("cuda", 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        platform_device("auto")


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return H.spawn(H.basics, 2, tmp_path_factory.mktemp("basics"), BN_CASES)


def test_two_ranks_group_and_mesh(two_ranks):
    for rank, r in enumerate(two_ranks):
        assert (r["rank"], r["world"]) == (rank, 2)
        assert r["mesh"] == (2, rank, "cpu")


def test_replicate_takes_process_0s_values(two_ranks):
    for r in two_ranks:
        np.testing.assert_array_equal(r["replicated"][0], np.ones((2, 3), np.float32))
        np.testing.assert_array_equal(r["replicated"][1], np.ones(4, np.float32))


def test_gradients_averaged_over_processes(two_ranks):
    for r in two_ranks:
        np.testing.assert_array_equal(r["grads"][0], np.full((2, 3), 0.5, np.float32))
        np.testing.assert_array_equal(r["grads"][1], np.full(5, 1.0))
        assert r["grads"][1].dtype == np.float64


def test_gather_states_in_process_order(two_ranks):
    want = [{"rank": 0, "records": [0, 1]}, {"rank": 1, "records": [0, 1, 2]}]
    assert two_ranks[0]["states"] == two_ranks[1]["states"] == want


def test_shards_and_draw_rule_rows(two_ranks):
    assert [r["rows"] for r in two_ranks] == [[0, 1, 2, 3], [4, 5, 6, 7]]
    whole = torch.rand((4, 3), generator=torch.Generator().manual_seed(3))
    got = torch.cat([r["uniform"] for r in two_ranks])
    assert torch.equal(got, whole)


@pytest.mark.parametrize("case", BN_CASES, ids=lambda c: f"seed{c[0]}-{c[1]}-cl{int(c[2])}")
def test_global_batch_norm_equals_one_process(two_ranks, case):
    seed, dtype, channels_last = case
    key = (seed, str(dtype), channels_last)
    want = H.bn_run(*H.bn_case(seed, dtype, channels_last))
    ranks = [r["bn"][key] for r in two_ranks]
    for name in ("y", "dx"):
        got = np.concatenate([r[name] for r in ranks])
        if dtype == torch.float64:
            np.testing.assert_allclose(got, want[name], rtol=0,
                                       atol=BN_F64_RTOL * np.abs(want[name]).max(), err_msg=name)
        else:
            np.testing.assert_allclose(got, want[name], rtol=0, atol=BN_F32_ATOL, err_msg=name)
    # the scale's and bias's gradients are each process's share
    for name in ("dweight", "dbias"):
        np.testing.assert_allclose(ranks[0][name] + ranks[1][name], want[name],
                                   rtol=1e-10 if dtype == torch.float64 else 1e-5,
                                   atol=1e-12 if dtype == torch.float64 else 1e-5, err_msg=name)
    for name in ("running_mean", "running_var"):
        np.testing.assert_array_equal(ranks[0][name], ranks[1][name])  # replicas agree
        np.testing.assert_allclose(ranks[0][name], want[name],
                                   rtol=1e-12 if dtype == torch.float64 else 1e-6, err_msg=name)
    assert all(r["channels_last"] == channels_last for r in ranks)
