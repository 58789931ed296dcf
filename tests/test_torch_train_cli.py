"""The port's training CLI on the CPU (``--platform cpu``), tiny YOLOv3:
the cases of ``tests/integration/test_cli.py:61,243,279`` (dump config,
temporal training on a combined still dataset, training from packed
shards), the output files, ``--precompile`` and ``--profile``, and the
fault-inject / resume path."""

import json
import logging
import os

import cv2
import numpy as np
import pytest

from viddet_tpu_torch.cli.train_yolov3 import main, parse_args
from viddet_tpu_torch.train.state import latest_checkpoint, load_weights_npz

TINY = ["--platform", "cpu", "--network", "yolo3_tiny_darknet", "--num-workers", "0",
        "--data-shape", "64", "--no-random-shape"]


def _messages(caplog):
    return [r.getMessage() for r in caplog.records]


def test_dump_config_and_config_file(tmp_path, capsys):
    with pytest.raises(SystemExit):
        parse_args(["--data-root", "synthetic", "--dump-config"])
    dumped = json.loads(capsys.readouterr().out)
    assert dumped["batch_size"] == 64
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"batch_size": 7, "epochs": 2}))
    args = parse_args(["--data-root", "synthetic", "--config", str(cfg)])
    assert args.batch_size == 7 and args.epochs == 2
    args = parse_args(["--data-root", "synthetic", "--config", str(cfg), "--batch-size", "9"])
    assert args.batch_size == 9
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"nonexistent_flag": 1}))
    with pytest.raises(SystemExit):
        parse_args(["--data-root", "synthetic", "--config", str(bad)])


def test_train_cli_writes_its_outputs(tmp_path, caplog):
    """Two epochs of 4 steps with mixup in the first, validation after the
    second: the reference's log lines, metric records, checkpoint and
    weight files, and a torch.profiler trace of steps 5-6."""
    caplog.set_level(logging.INFO, logger="viddet_tpu_torch")
    prefix = str(tmp_path / "y3")
    jsonl = str(tmp_path / "m.jsonl")
    main(TINY + ["--dataset", "synthetic", "--data-root", "synthetic", "--batch-size", "16",
                 "--epochs", "2", "--mixup", "--no-mixup-epochs", "1", "--log-interval", "2",
                 "--val-interval", "2", "--save-interval", "1", "--metrics-jsonl", jsonl,
                 "--profile", "1", "--save-prefix", prefix])
    messages = _messages(caplog)
    assert any(m.startswith("[Epoch 0][Batch 2] speed:") and "ObjLoss=" in m for m in messages)
    assert any("[Epoch 1] validation: mAP=" in m for m in messages)
    with open(jsonl) as f:
        records = [json.loads(line) for line in f]
    assert [r["step"] for r in records] == [2, 4, 6, 8]
    assert all(np.isfinite(r[k]) for r in records for k in ("obj", "center", "scale", "cls",
                                                              "total", "samples_per_sec"))
    assert sorted(os.listdir(f"{prefix}_ckpt")) == ["step_00000004", "step_00000008"]
    assert latest_checkpoint(f"{prefix}_ckpt").endswith("step_00000008")
    final, best = (load_weights_npz(f"{prefix}_{name}.npz") for name in ("final", "best"))
    assert set(final) == set(best)
    with open(f"{prefix}_trace/trace.json") as f:
        assert json.load(f)["traceEvents"]
    assert os.path.exists(f"{prefix}_train.log")


def test_precompile_warms_each_bucket(tmp_path, caplog):
    caplog.set_level(logging.INFO, logger="viddet_tpu_torch")
    args = [a for a in TINY if a != "--no-random-shape"]
    main(args + ["--dataset", "synthetic", "--data-root", "synthetic", "--batch-size", "2",
                 "--epochs", "1", "--max-steps", "1", "--precompile",
                 "--save-prefix", str(tmp_path / "pc")])
    compiled = [m for m in _messages(caplog) if m.endswith("s") and "compiled in" in m]
    assert [m.split()[0] for m in compiled] == [f"{s}x{s}" for s in range(320, 609, 64)]


def test_fault_inject_then_resume(tmp_path, caplog):
    """``--fault-inject 3`` checkpoints step 3 and raises; ``--resume`` on the
    checkpoint directory restarts from it (epoch 0, 8 steps an epoch) and
    finishes the epoch."""
    caplog.set_level(logging.INFO, logger="viddet_tpu_torch")
    prefix = str(tmp_path / "fi")
    base = TINY + ["--dataset", "synthetic", "--data-root", "synthetic", "--batch-size", "8",
                   "--epochs", "1", "--val-interval", "0", "--save-prefix", prefix]
    with pytest.raises(RuntimeError, match="fault injected at step 3"):
        main(base + ["--fault-inject", "3"])
    assert latest_checkpoint(f"{prefix}_ckpt").endswith("step_00000003")
    main(base + ["--resume", f"{prefix}_ckpt"])
    assert any("resumed from" in m and "(step 3, epoch 0)" in m for m in _messages(caplog))
    assert latest_checkpoint(f"{prefix}_ckpt").endswith("step_00000011")


def test_train_cli_temporal_on_combined_still_dataset(tmp_path, caplog):
    """Temporal k-frame training over a combined dataset of still images,
    tiled into static clips (``tests/integration/test_cli.py:243``)."""
    caplog.set_level(logging.INFO, logger="viddet_tpu_torch")
    main(TINY + ["--dataset", "synthetic+synthetic", "--data-root", "synthetic",
                 "--temporal-k", "3", "--temporal-agg", "max", "--batch-size", "8",
                 "--max-steps", "2", "--save-prefix", str(tmp_path / "tcomb")])
    assert any("reached max-steps" in m for m in _messages(caplog))


def test_train_cli_from_packed_shards(tmp_path, caplog):
    """``--dataset packed`` trains from .vdtp shards
    (``tests/integration/test_cli.py:279``)."""
    from viddet_tpu_torch.data.packed import pack_dataset

    caplog.set_level(logging.INFO, logger="viddet_tpu_torch")

    class _Disk:
        classes = ("a", "b")
        wn_classes = ("n1", "n2")

        def __len__(self):
            return 16

        def image_path(self, i):
            return str(tmp_path / f"{i}.jpg")

        def label(self, i):
            return np.array([[2.0, 2.0, 30.0, 30.0, i % 2, 0.0]], np.float32)

    rng = np.random.default_rng(0)
    for i in range(16):
        cv2.imwrite(str(tmp_path / f"{i}.jpg"), rng.integers(0, 255, (48, 64, 3)).astype(np.uint8))
    pack_dataset(_Disk(), str(tmp_path / "pk"), shard_size=8)
    main(TINY + ["--dataset", "packed", "--data-root", str(tmp_path / "pk"), "--batch-size", "8",
                 "--max-steps", "2", "--save-prefix", str(tmp_path / "pkrun")])
    assert any("reached max-steps" in m for m in _messages(caplog))
