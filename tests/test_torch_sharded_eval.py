"""Sharded evaluation of the port equals unsharded evaluation
(``viddet_tpu_torch/eval/distributed.py``, ``cli/evaluate.py``).

The counterpart of ``tests/unit/test_sharded_eval.py``: strided shards of
an image stream (with uneven tails) accumulated apart and merged through
the port's ``merge_metric_states`` give the unsharded ``get()`` exactly,
and the JAX package's merge of the JAX metrics on the same shards, value
for value, for the VOC, COCO and VID metrics; a merge of one image twice
raises.  Then ``cli.evaluate.main`` on two gloo processes: each evaluates
its strided shard, writes ``{path}.p{i}``, and returns the merged metric,
equal to one process's, and the two files joined hold the one process's
detections, line for line by image index.
"""

import json

import numpy as np
import pytest
import torch

import viddet_tpu.eval.coco_eval as jax_coco
import viddet_tpu.eval.distributed as jax_distributed
import viddet_tpu.eval.vid_motion_iou as jax_vid
import viddet_tpu.eval.voc_map as jax_voc
import viddet_tpu_torch.eval.coco_eval as torch_coco
import viddet_tpu_torch.eval.vid_motion_iou as torch_vid
import viddet_tpu_torch.eval.voc_map as torch_voc
from tests import torch_dp_helpers as H
from tests.unit.test_sharded_eval import _BoxDataset, _VidDataset, random_scene, shard_indices
from viddet_tpu_torch.eval.distributed import gather_states, merge_metric_states


def assert_same_result(a, b):
    names_a, vals_a = a
    names_b, vals_b = b
    assert list(names_a) == list(names_b)
    np.testing.assert_array_equal(np.asarray(vals_a, np.float64), np.asarray(vals_b, np.float64))


def sharded_runs(make, update, n: int, count: int):
    """(unsharded port result, port merge of strided shards, JAX merge of
    the same shards); ``make(pkg)`` builds a metric of the package's
    module set, ``update(metric, i)`` feeds it image ``i``."""
    results = {}
    for pkg, merge in (("torch", merge_metric_states),
                       ("jax", jax_distributed.merge_metric_states)):
        if pkg == "torch":
            full = make(pkg)
            for i in range(n):
                update(full, i)
            results["full"] = full.get()
        states = []
        for idxs in shard_indices(n, count):
            m = make(pkg)
            for i in idxs:
                update(m, i)
            states.append(m.state_dict())
        results[pkg] = merge(make(pkg), states).get()
    return results


@pytest.mark.parametrize("count", [2, 3])
def test_voc_metric_shard_merge_exact(count):
    rng = np.random.default_rng(7)
    scenes = [random_scene(rng) for _ in range(11)]  # 11 % count != 0
    modules = {"torch": torch_voc, "jax": jax_voc}

    def update(metric, i):
        gb, gi, gd, db, di, sc = scenes[i]
        metric.update(db[None], di[None], sc[None], gb[None], gi[None], gd[None])

    r = sharded_runs(lambda pkg: modules[pkg].VOCMApMetric(class_names=["a", "b", "c"]),
                     update, len(scenes), count)
    assert_same_result(r["torch"], r["full"])
    assert_same_result(r["torch"], r["jax"])


def _coco_scenes(seed, n):
    rng = np.random.default_rng(seed)
    scenes = [random_scene(rng) for _ in range(n)]
    labels = [np.concatenate([s[0], s[1][:, None], s[2][:, None]], axis=1).astype(np.float32)
              for s in scenes]
    return scenes, _BoxDataset(labels)


def test_coco_metric_shard_merge_exact():
    scenes, ds = _coco_scenes(3, 10)
    modules = {"torch": torch_coco, "jax": jax_coco}

    def update(metric, i):
        _, _, _, db, di, sc = scenes[i]
        metric.update_with_indices(db[None], di[None], sc[None], [i])

    r = sharded_runs(lambda pkg: modules[pkg].COCODetectionMetric(ds), update, len(scenes), 3)
    assert_same_result(r["torch"], r["full"])
    assert_same_result(r["torch"], r["jax"])


def test_coco_merge_rejects_duplicate_images():
    (s,), ds = _coco_scenes(5, 1)
    a, b = torch_coco.COCODetectionMetric(ds), torch_coco.COCODetectionMetric(ds)
    for m in (a, b):
        m.update_with_indices(s[3][None], s[4][None], s[5][None], [0])
    with pytest.raises(ValueError, match="duplicate image ids"):
        merge_metric_states(torch_coco.COCODetectionMetric(ds), [a.state_dict(), b.state_dict()])


def test_vid_metric_shard_merge_exact():
    ds = _VidDataset(n=7)  # 7 % 2 != 0
    rng = np.random.default_rng(11)
    draws = {i: rng.uniform(-3, 3, (1, 4)).astype(np.float32) for i in range(7)}
    modules = {"torch": torch_vid, "jax": jax_vid}

    def update(metric, i):
        db = ds.label(i)[:, :4] + draws[i]
        metric.update_with_indices(db[None], np.zeros((1, 1), np.float32),
                                   np.asarray([[0.9]], np.float32), [i])

    r = sharded_runs(lambda pkg: modules[pkg].VIDDetectionMetric(ds), update, 7, 2)
    assert_same_result(r["torch"], r["full"])
    assert_same_result(r["torch"], r["jax"])


def test_gather_states_single_process_identity():
    state = {"records": {0: [(0.5, 1, 0)]}, "npos": {0: 1}}
    assert gather_states(state) == [state]


def _eval_argv(path: str) -> list:
    return ["--platform", "cpu", "--network", "yolo3_tiny_darknet", "--dataset", "synthetic",
            "--data-root", "synthetic", "--data-shape", "64", "--batch-size", "3",
            "--num-workers", "1", "--save-detections", path]


def test_evaluate_on_two_processes_equals_one(tmp_path):
    """16 val images: 8 a process in batches of 3 (each shard's last batch
    padded); the merged metric on both processes equals one process's
    exactly, and ``.p0`` and ``.p1`` joined hold its lines by index."""
    from viddet_tpu_torch.cli import evaluate

    threads = torch.get_num_threads()
    torch.set_num_threads(H.THREADS)
    try:
        ranks = H.spawn(H.cli, 2, tmp_path, "evaluate", _eval_argv(f"{tmp_path}/two.jsonl"))
        one = evaluate.main(_eval_argv(f"{tmp_path}/one.jsonl"))
    finally:
        torch.set_num_threads(threads)
    for r in ranks:
        assert_same_result(r, one)
    assert not (tmp_path / "two.jsonl").exists()

    def lines(path):
        with open(path) as f:
            return {json.loads(line)["index"]: line for line in f}

    shards = [lines(tmp_path / f"two.jsonl.p{i}") for i in range(2)]
    assert sorted(shards[0]) == list(range(0, 16, 2)) and sorted(shards[1]) == list(range(1, 16, 2))
    assert {**shards[0], **shards[1]} == lines(tmp_path / "one.jsonl")
