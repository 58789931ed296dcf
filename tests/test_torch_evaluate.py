"""The port's ``evaluate`` against the JAX package's: the slice's gate.

Both packages evaluate ``--dataset synthetic`` (16 images of 256 px) in
float32 (``FLOAT32_POLICY`` on both sides, the module built directly) at
the same ``.npz`` weights and write ``--save-detections`` files, which
``tools/compare_detections.py --strict-order`` must find identical: ids
exact and in the same order, scores within 1e-6 and boxes within 1e-4 px
of the network input (the golden tolerances of
``tests/integration/test_golden.py``; the files hold original-image
pixels, so the box tolerance is scaled by 256 / input size).  The metric
values must be equal exactly.  Models: the tiny YOLOv3 at 64 and 256 px,
and the shallow SSD and Faster R-CNN that ``tests/test_torch_ssd.py`` and
``tests/test_torch_frcnn.py`` use, at 128 px.  Faster R-CNN is held at the
tolerances of ``tests/test_torch_frcnn.py``, scores 1e-5 and boxes 1e-3 px:
its deeper stack (FPN, RPN ranking, ROIAlign, box head) sums in another
order in the two frameworks, and here it measured 2.5e-6 and 4.4e-4 px.

Then the CLI in its default bf16 on the CPU: its save -> rescore round
trip reproduces the metric lines, JAX's ``rescore_from_detections`` on the
port's file gives the port's values exactly, ``--device-normalize`` and
``--letterbox`` run, a VID tree prints the three motion-IoU modes (also
through a temporal model), and a ``VIDDET_EVAL_SHARD`` pair merged equals
the unsharded run.
"""

import argparse
import json
import logging
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from tests.test_torch_metrics import assert_same
from tests.unit.test_datasets import vid_root  # noqa: F401 -- fixture
from viddet_tpu.cli import evaluate as jax_evaluate
from viddet_tpu.cli.common import get_dataset as jax_get_dataset
from viddet_tpu.core.precision import FLOAT32_POLICY as JAX_F32
from viddet_tpu.train.state import load_weights_npz
from viddet_tpu_torch.cli import evaluate as torch_evaluate
from viddet_tpu_torch.cli.common import get_dataset
from viddet_tpu_torch.core.precision import FLOAT32_POLICY as TORCH_F32
from viddet_tpu_torch.models.zoo import place
from viddet_tpu_torch.weights import seeded_flat

ROOT = Path(__file__).resolve().parents[1]
SHALLOW = dict(backbone_blocks=(1, 1, 1, 1), backbone_widths=(8, 16, 32, 64))
FRCNN_COUNTS = dict(rpn_pre_nms_topk=64, rpn_nms_input=128, rpn_post_nms_train=64,
                    rpn_post_nms_test=32, rpn_batch=64, roi_batch=64)
SYNTHETIC_SIZE = 256  # get_dataset's synthetic val images
# (score, box px at the network input) per family
TOLERANCES = {"yolo": (1e-6, 1e-4), "ssd": (1e-6, 1e-4), "frcnn": (1e-5, 1e-3)}
LOGGER = logging.getLogger("viddet_tpu_torch.test")


def _models(family: str, size: int, classes, jax_policy=JAX_F32, torch_policy=TORCH_F32):
    """(JAX module, port model, not yet placed), float32 unless the
    policies say otherwise."""
    n = len(classes)
    if family == "yolo":
        from viddet_tpu.models.zoo import yolo3_custom
        from viddet_tpu_torch.models.zoo import yolo3_custom as torch_yolo3_custom

        return (yolo3_custom(classes, backbone="tiny", policy=jax_policy)[0],
                torch_yolo3_custom(classes, backbone="tiny", policy=torch_policy)[0])
    if family == "ssd":
        from viddet_tpu.models import ssd as JS
        from viddet_tpu_torch.models import ssd as TS

        return (JS.SSD(num_classes=n, image_size=size, policy=jax_policy, **SHALLOW),
                TS.SSD(n, size, torch_policy, **SHALLOW))
    from viddet_tpu.models import faster_rcnn as JF
    from viddet_tpu_torch.models import faster_rcnn as TF

    return (JF.FasterRCNN(num_classes=n, config=JF.FRCNNConfig(**FRCNN_COUNTS),
                          policy=jax_policy, **SHALLOW),
            TF.FasterRCNN(n, TF.FRCNNConfig(**FRCNN_COUNTS), torch_policy, **SHALLOW))


def _args(size: int, save: str = "", **kw):
    base = dict(data_shape=size, batch_size=4, num_workers=2, letterbox=False, max_images=0,
                save_detections=save, device_normalize=False, temporal_k=1)
    return argparse.Namespace(**(base | kw))


def _gate(family: str, size: int, out_dir: str):
    """Both packages' evaluate at one .npz: (JAX values, port values, JAX
    file, port file)."""
    out = Path(out_dir)
    dataset, metric_factory = get_dataset("synthetic", "synthetic", split="val")
    jax_module, model = _models(family, size, dataset.classes)
    model = place(model, "cpu")
    flat = seeded_flat(model, seed=3)
    npz = out / f"{family}_{size}.npz"
    np.savez(npz, **flat)
    torch_evaluate.load_weights(model, str(npz))
    files = [str(out / f"{side}_{family}_{size}.jsonl") for side in ("jax", "port")]
    port = torch_evaluate.evaluate(model, dataset, metric_factory(list(dataset.classes)),
                                   _args(size, files[1]), LOGGER)
    jds, jmf = jax_get_dataset("synthetic", "synthetic", split="val")
    params, batch_stats = load_weights_npz(str(npz))
    jax = jax_evaluate.evaluate(jax_module, {"params": params, "batch_stats": batch_stats}, jds,
                                jmf(list(jds.classes)), _args(size, files[0]), LOGGER)
    return jax, port, files[0], files[1]


@pytest.mark.parametrize("family, size", [("yolo", 64), ("yolo", 256), ("ssd", 128),
                                          ("frcnn", 128)])
def test_f32_detections_and_metric_match_jax(family, size, tmp_path_factory):
    jax, port, jax_file, port_file = _gate(family, size, str(tmp_path_factory.mktemp("gate")))
    rows = [json.loads(line) for line in open(port_file)]
    assert [r["index"] for r in rows] == list(range(16))
    assert sum(len(r["ids"]) for r in rows) > 16  # a real workload
    score_atol, box_atol = TOLERANCES[family]
    cmd = [sys.executable, str(ROOT / "tools" / "compare_detections.py"), jax_file, port_file,
           "--strict-order", "--score-atol", str(score_atol),
           "--atol", str(box_atol * SYNTHETIC_SIZE / size)]
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert json.loads(proc.stdout.splitlines()[-1])["identical"]
    assert_same(jax, port)
    # the largest gaps, for the record (-s prints them)
    gaps = []
    for a, b in zip(map(json.loads, open(jax_file)), rows):
        for sa, sb, ba, bb in zip(a["scores"], b["scores"], a["boxes"], b["boxes"]):
            gaps += [(abs(sa - sb), abs(x - y) * size / SYNTHETIC_SIZE) for x, y in zip(ba, bb)]
    print(json.dumps({"family": family, "size": size, "max_score_gap": max(g[0] for g in gaps),
                      "max_box_gap_px_network": max(g[1] for g in gaps)}))


def _log_table(caplog):
    """The metric lines of the last table the CLI logged."""
    lines = [r.getMessage() for r in caplog.records if r.name == "viddet_tpu_torch"]
    table = []
    for line in reversed(lines):
        if " " not in line or line.startswith(("evaluated", "detections", "re-scored")):
            break
        table.append(line)
    return table[::-1]


CLI = ["--platform", "cpu", "--network", "yolo3_tiny_darknet", "--dataset", "synthetic",
       "--data-root", "synthetic", "--data-shape", "64", "--batch-size", "4",
       "--num-workers", "2"]


def test_cli_bf16_round_trip_and_jax_rescore(tmp_path, caplog):
    caplog.set_level(logging.INFO, logger="viddet_tpu_torch")
    saved = str(tmp_path / "dets.jsonl")
    torch_evaluate.main(CLI + ["--save-detections", saved])
    table = _log_table(caplog)
    assert [line.split()[0] for line in table] == ["class0", "class1", "class2", "class3", "mAP"]
    caplog.clear()
    torch_evaluate.main(CLI + ["--from-detections", saved])
    assert _log_table(caplog) == table

    dataset, factory = get_dataset("synthetic", "synthetic", split="val")
    port = torch_evaluate.rescore_from_detections(dataset, factory(list(dataset.classes)), saved,
                                                  LOGGER)
    jds, jmf = jax_get_dataset("synthetic", "synthetic", split="val")
    jax = jax_evaluate.rescore_from_detections(jds, jmf(list(jds.classes)), saved, LOGGER)
    assert_same(jax, port)
    assert [f"{v:.4f}" for v in port[1]] == [line.split()[-1] for line in table]


def test_cli_options_run(tmp_path, caplog):
    """--device-normalize (uint8 frames normalized by the predictor),
    --letterbox, --max-images and --config / --dump-config."""
    caplog.set_level(logging.INFO, logger="viddet_tpu_torch")
    saved = str(tmp_path / "dets.jsonl")
    config = tmp_path / "cfg.json"
    config.write_text(json.dumps({"letterbox": True, "max_images": 6}))
    torch_evaluate.main(CLI + ["--device-normalize", "--config", str(config),
                               "--save-detections", saved])
    assert len(open(saved).readlines()) == 8  # two batches of four, then the stop
    assert _log_table(caplog)[-1].startswith("mAP")
    with pytest.raises(SystemExit):
        torch_evaluate.main(CLI + ["--config", str(config), "--dump-config",
                                   str(tmp_path / "dump.json")])
    dumped = json.loads((tmp_path / "dump.json").read_text())
    assert dumped["letterbox"] is True and dumped["platform"] == "cpu"


def test_cli_without_cuda_raises(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_evaluate.main([a for a in CLI if a not in ("--platform", "cpu")])


@pytest.mark.parametrize("temporal_k", [1, 3])
def test_vid_prints_motion_modes(vid_root, temporal_k, caplog):  # noqa: F811
    caplog.set_level(logging.INFO, logger="viddet_tpu_torch")
    torch_evaluate.main(["--platform", "cpu", "--network", "yolo3_tiny_darknet",
                         "--dataset", "vid", "--data-root", vid_root, "--data-shape", "64",
                         "--batch-size", "4", "--num-workers", "0",
                         "--temporal-k", str(temporal_k)])
    names = [line.split()[0] for line in _log_table(caplog)]
    assert names[-4:] == ["mAP", "mAP(slow)", "mAP(medium)", "mAP(fast)"]


def test_eval_shards_merge_to_the_unsharded_run(monkeypatch):
    from viddet_tpu_torch.cli.common import build_model

    dataset, factory = get_dataset("synthetic", "synthetic", split="val")
    model, names = build_model("yolo3_tiny_darknet", "synthetic", classes=dataset.classes,
                               device="cpu")
    torch_evaluate.load_flat(model, seeded_flat(model, seed=0))
    args = _args(64, batch_size=3)
    full = factory(names)
    torch_evaluate.evaluate(model, dataset, full, args, LOGGER)
    merged = factory(names)
    for i in range(3):
        monkeypatch.setenv("VIDDET_EVAL_SHARD", f"{i},3")
        shard = factory(names)
        torch_evaluate.evaluate(model, dataset, shard, args, LOGGER)
        merged.merge_state(shard.state_dict())
    assert_same(full.get(), merged.get())
