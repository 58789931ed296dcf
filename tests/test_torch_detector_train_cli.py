"""The SSD and Faster R-CNN training CLIs of the port on the CPU
(``--platform cpu``): JAX's flags and defaults, the log lines, the output
files, resume, and the ``.npz`` files read back by the JAX package's
``load_weights_npz`` into its own modules.  The runs pass the shallow
models of the JAX unit tests (4 classes, as ``--dataset synthetic``: ``main(argv, built=...)``) to
stay quick;
``--network`` builds the full models, as ``tests/test_torch_zoo.py`` holds.
"""

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_detector_helpers import frcnn_model, one_torch_thread, ssd_model  # noqa: F401
from viddet_tpu.cli import train_faster_rcnn as jax_frcnn_cli
from viddet_tpu.cli import train_ssd as jax_ssd_cli
from viddet_tpu.core.precision import FLOAT32_POLICY
from viddet_tpu.models import faster_rcnn as JF
from viddet_tpu.models import ssd as JS
from viddet_tpu.train.state import load_weights_npz as jax_load_weights_npz
from viddet_tpu_torch.cli import train_faster_rcnn, train_ssd
from viddet_tpu_torch.train.state import latest_checkpoint, load_weights_npz

CLIS = {"ssd": (train_ssd, jax_ssd_cli), "frcnn": (train_faster_rcnn, jax_frcnn_cli)}
CPU = ["--platform", "cpu", "--dataset", "synthetic", "--data-root", "synthetic",
       "--num-workers", "0"]


def _messages(caplog):
    return [r.getMessage() for r in caplog.records]


@pytest.mark.parametrize("family", ["ssd", "frcnn"])
def test_flags_and_defaults_are_jax(family):
    port, jax_cli = CLIS[family]
    got = vars(port.parse_args(["--data-root", "d"]))
    want = vars(jax_cli.parse_args(["--data-root", "d"]))
    extra = {"platform", "jax_cache_dir"}  # JAX's cache dir has no counterpart
    assert {k: v for k, v in got.items() if k not in extra} == \
        {k: v for k, v in want.items() if k not in extra}
    assert got["platform"] == "auto"


@pytest.mark.parametrize("family", ["ssd", "frcnn"])
def test_default_platform_needs_cuda(family, tmp_path):
    """No fallback: without CUDA the default platform raises."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CLIS[family][0].main(["--dataset", "synthetic", "--data-root", "synthetic",
                              "--save-prefix", str(tmp_path / family)])


def _run(family, tmp_path, caplog, extra, model=None):
    caplog.set_level(logging.INFO, logger="viddet_tpu_torch")
    model = model or (ssd_model(num_classes=4) if family == "ssd" else frcnn_model(num_classes=4))
    classes = tuple(f"c{i}" for i in range(model.num_classes))
    prefix = str(tmp_path / family)
    size = "64" if family == "ssd" else "128"
    CLIS[family][0].main(CPU + ["--data-shape", size, "--save-prefix", prefix] + extra,
                         built=(model, classes))
    return prefix, model


def test_train_ssd_cli_writes_its_outputs(tmp_path, caplog):
    """Two epochs of 4 steps, validated after the second: JAX's log lines
    and files; ``_final.npz`` read by JAX's ``load_weights_npz`` gives its
    SSD the port's outputs."""
    prefix, model = _run("ssd", tmp_path, caplog,
                         ["--batch-size", "16", "--epochs", "2", "--log-interval", "2",
                          "--val-interval", "2", "--save-interval", "1"])
    messages = _messages(caplog)
    assert any(m.startswith("[Epoch 0][Batch 2] speed:") and "CrossEntropy=" in m
               and "SmoothL1=" in m for m in messages)
    assert any(m.startswith("[Epoch 1] validation mAP=") for m in messages)
    assert sorted(os.listdir(f"{prefix}_ckpt")) == ["step_00000004", "step_00000008"]
    assert os.path.exists(f"{prefix}_best.npz") and os.path.exists(f"{prefix}_train.log")
    params, stats = jax_load_weights_npz(f"{prefix}_final.npz")
    module = JS.SSD(num_classes=4, image_size=64, policy=FLOAT32_POLICY,
                    backbone_blocks=(1, 1, 1, 1), backbone_widths=(8, 16, 32, 64))
    x = np.random.default_rng(0).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    want = module.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train=False)
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for k in ("cls_logits", "box_deltas"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def test_train_ssd_cli_resumes(tmp_path, caplog):
    """``--max-steps 3`` checkpoints step 3; ``--resume`` on the checkpoint
    directory restores it (momentum included) and finishes the epoch."""
    base = ["--batch-size", "8", "--epochs", "1", "--val-interval", "0", "--log-interval", "4"]
    prefix, _ = _run("ssd", tmp_path, caplog, base + ["--max-steps", "3"])
    assert latest_checkpoint(f"{prefix}_ckpt").endswith("step_00000003")
    _run("ssd", tmp_path, caplog, base + ["--resume", f"{prefix}_ckpt"])
    assert any("resumed from" in m and m.endswith("step_00000003") for m in _messages(caplog))
    assert latest_checkpoint(f"{prefix}_ckpt").endswith("step_00000011")


def test_train_faster_rcnn_cli_writes_its_outputs(tmp_path, caplog):
    """One epoch of 8 steps, validated: JAX's four loss names in each log
    line, the checkpoint, and ``_final.npz`` read by JAX's
    ``load_weights_npz`` with the tree of JAX's own module."""
    prefix, model = _run("frcnn", tmp_path, caplog,
                         ["--batch-size", "8", "--epochs", "1", "--log-interval", "4"])
    lines = [m for m in _messages(caplog) if " speed: " in m]
    assert len(lines) == 2 and all(all(f"{n}=" in m for n in ("RPNAcc-loss", "RPNL1", "RCNNCE",
                                                                "RCNNL1")) for m in lines)
    assert any(m.startswith("[Epoch 0] validation mAP=") for m in _messages(caplog))
    assert latest_checkpoint(f"{prefix}_ckpt").endswith("step_00000008")
    params, stats = jax_load_weights_npz(f"{prefix}_final.npz")
    module = JF.FasterRCNN(num_classes=4, config=JF.FRCNNConfig(nms_backend="xla"),
                           policy=FLOAT32_POLICY, backbone_blocks=(1, 1, 1, 1),
                           backbone_widths=(8, 16, 32, 64))
    shapes = jax.eval_shape(lambda: module.init({"params": jax.random.key(0)},
                                                jnp.zeros((1, 128, 128, 3)), train=False))
    assert jax.tree_util.tree_map(lambda a: a.shape, shapes["params"]) == \
        jax.tree_util.tree_map(np.shape, params)
    assert jax.tree_util.tree_map(lambda a: a.shape, shapes["batch_stats"]) == \
        jax.tree_util.tree_map(np.shape, stats)
    final = load_weights_npz(f"{prefix}_final.npz")
    from viddet_tpu_torch.weights import to_flat

    assert all(np.array_equal(v, final[k]) for k, v in to_flat(model).items())


def test_generator_is_seeded_from_seed_plus_7(tmp_path, caplog, monkeypatch):
    """JAX seeds its sampling key from ``--seed + 7``; the port its
    generator."""
    seeds, real = [], torch.Generator

    class Recording:
        def __init__(self, device=None):
            self.generator = real(device=device)

        def manual_seed(self, seed):
            seeds.append(seed)
            return self.generator.manual_seed(seed)

    monkeypatch.setattr(torch, "Generator", Recording)
    _run("frcnn", tmp_path, caplog, ["--batch-size", "8", "--max-steps", "1", "--seed", "5"])
    assert seeds == [12]
