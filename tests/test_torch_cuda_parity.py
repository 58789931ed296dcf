"""bf16 parity of the port's ``evaluate`` on the card against JAX's on the CPU.

The tiny YOLOv3 (64 px), the shallow SSD and the shallow Faster R-CNN
(128 px) of ``tests/test_torch_evaluate.py`` evaluate ``--dataset
synthetic`` (16 images) in bf16 (each package's default policy) at the same
seeded weights (``weights.seeded_flat(model, 3)``): once with frames
normalized on the host and once with ``--device-normalize`` (uint8 frames
normalized by the predictor, where the card's division by 255 multiplies
by a rounded reciprocal).

The card machine has JAX but not Flax, so JAX's detections come from
``tests/fixtures/jax_bf16_eval.npz``, written on the CPU by

    JAX_PLATFORMS=cpu python -m tests.test_torch_cuda_parity

and held to a live JAX run by ``test_fixture_equals_live_jax`` in tier 1.
The card test (``-m cuda``, skipped without a card; ``-s`` prints one
JSON line a case) runs the port on ``cuda:0`` through its kernels;
``python -m tests.test_torch_cuda_parity --cpu`` prints the same
comparison with the port on the CPU.  bf16
keeps 8 significant bits and the two frameworks round each layer's sums
differently, so detections are matched as sets per image
(``tools/compare_detections.py``): at least ``MIN_MATCHED[family]`` of
JAX's detections must have a port detection of the same class within
``SCORE_ATOL`` and ``BOX_ATOL`` px of the network input, and at most
``1 - MIN_MATCHED[family]`` of the port's may lack a JAX partner.  The
limits sit between the card's measured shares (99.875 %, 99.375 %,
94.35 %) and the port's CPU shares against JAX (99.75 %, 99.3 %, 93.3 %).
"""

import argparse
import json
import logging
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from tools.compare_detections import match_image
from viddet_tpu_torch.cli import evaluate as torch_evaluate
from viddet_tpu_torch.cli.common import get_dataset
from viddet_tpu_torch.models.zoo import place
from viddet_tpu_torch.weights import seeded_flat

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "jax_bf16_eval.npz"
CASES = [(family, size, dn) for family, size in (("yolo", 64), ("ssd", 128), ("frcnn", 128))
         for dn in (False, True)]
SHALLOW = dict(backbone_blocks=(1, 1, 1, 1), backbone_widths=(8, 16, 32, 64))
FRCNN_COUNTS = dict(rpn_pre_nms_topk=64, rpn_nms_input=128, rpn_post_nms_train=64,
                    rpn_post_nms_test=32, rpn_batch=64, roi_batch=64)
SYNTHETIC_SIZE = 256
MIN_MATCHED = {"yolo": 0.99, "ssd": 0.99, "frcnn": 0.9}
SCORE_ATOL, BOX_ATOL = 2e-2, 1.0  # box px at the network input
LOGGER = logging.getLogger("viddet_tpu_torch.test")


def _key(family, size, device_normalize):
    return f"{family}_{size}_{'uint8' if device_normalize else 'float'}"


def _args(size, save, device_normalize):
    return argparse.Namespace(data_shape=size, batch_size=4, num_workers=2, letterbox=False,
                              max_images=0, save_detections=save,
                              device_normalize=device_normalize, temporal_k=1)


def _port_model(family, size, classes, device):
    """The bf16 port model with its seeded weights, and those weights."""
    from viddet_tpu_torch.models import faster_rcnn as TF
    from viddet_tpu_torch.models import ssd as TS
    from viddet_tpu_torch.models.zoo import yolo3_custom

    if family == "yolo":
        model = yolo3_custom(classes, backbone="tiny")[0]
    elif family == "ssd":
        model = TS.SSD(len(classes), size, **SHALLOW)
    else:
        model = TF.FasterRCNN(len(classes), TF.FRCNNConfig(**FRCNN_COUNTS), **SHALLOW)
    model = place(model, device)
    flat = seeded_flat(model, seed=3)
    torch_evaluate.load_flat(model, flat)
    return model, flat


def jax_lines(family, size, device_normalize):
    """JAX's bf16 ``--save-detections`` lines on the CPU at the port's
    seeded weights."""
    from viddet_tpu.cli import evaluate as jax_evaluate
    from viddet_tpu.cli.common import get_dataset as jax_get_dataset
    from viddet_tpu.models import faster_rcnn as JF
    from viddet_tpu.models import ssd as JS
    from viddet_tpu.models.zoo import yolo3_custom
    from viddet_tpu.train.state import _unflatten

    jds, jmf = jax_get_dataset("synthetic", "synthetic", split="val")
    if family == "yolo":
        module = yolo3_custom(jds.classes, backbone="tiny")[0]
    elif family == "ssd":
        module = JS.SSD(num_classes=len(jds.classes), image_size=size, **SHALLOW)
    else:
        module = JF.FasterRCNN(num_classes=len(jds.classes),
                               config=JF.FRCNNConfig(**FRCNN_COUNTS), **SHALLOW)
    _, flat = _port_model(family, size, jds.classes, "cpu")
    tree = _unflatten(flat)
    variables = {"params": tree["params"], "batch_stats": tree["batch_stats"]}
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "jax.jsonl")
        jax_evaluate.evaluate(module, variables, jds, jmf(list(jds.classes)),
                              _args(size, path, device_normalize), LOGGER)
        return open(path).read().splitlines()


def test_fixture_equals_live_jax():
    with np.load(FIXTURE) as data:
        assert sorted(data.files) == sorted(_key(*case) for case in CASES)
        for case in CASES:
            assert data[_key(*case)].tolist() == jax_lines(*case), _key(*case)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def compare(family, size, device_normalize, device, tmp_dir):
    """The port's bf16 ``evaluate`` on ``device`` against the fixture's JAX
    lines: the match shares as one dict."""
    dataset, factory = get_dataset("synthetic", "synthetic", split="val")
    model, _ = _port_model(family, size, dataset.classes, device)
    path = str(Path(tmp_dir) / "port.jsonl")
    port = torch_evaluate.evaluate(model, dataset, factory(list(dataset.classes)),
                                   _args(size, path, device_normalize), LOGGER)
    with np.load(FIXTURE) as data:
        jax = [json.loads(line) for line in data[_key(family, size, device_normalize)]]
    rows = [{r["index"]: r for r in jax}, {r["index"]: r for r in map(json.loads, open(path))}]
    assert sorted(rows[0]) == sorted(rows[1]) == list(range(16))

    scale = SYNTHETIC_SIZE / size
    total = unmatched_jax = unmatched_port = 0
    for idx, a in rows[0].items():
        ua, ub, _ = match_image(a, rows[1][idx], SCORE_ATOL, BOX_ATOL * scale)
        total += len(a["ids"])
        unmatched_jax += ua
        unmatched_port += ub
    return {"family": family, "size": size, "device_normalize": device_normalize,
            "device": str(device), "detections": total,
            "matched_share": 1 - unmatched_jax / total,
            "port_unmatched_share": unmatched_port / total,
            "images_with_equal_ids": sum(rows[0][i]["ids"] == rows[1][i]["ids"] for i in rows[0]),
            "port_map": port[1][-1]}


@pytest.mark.cuda
@pytest.mark.parametrize("family, size, device_normalize", CASES)
def test_bf16_card_matches_jax_cpu(dev, family, size, device_normalize, tmp_path):
    result = compare(family, size, device_normalize, dev, tmp_path)
    print(json.dumps(result))
    assert result["detections"] > 16
    assert result["matched_share"] >= MIN_MATCHED[family], result
    assert result["port_unmatched_share"] <= 1 - MIN_MATCHED[family], result


if __name__ == "__main__":
    import sys

    if sys.argv[1:] == ["--cpu"]:  # the same comparison with the port on the CPU
        with tempfile.TemporaryDirectory() as tmp:
            for case in CASES:
                print(json.dumps(compare(*case, torch.device("cpu"), tmp)))
    else:
        import jax

        jax.config.update("jax_platforms", "cpu")
        np.savez_compressed(FIXTURE,
                            **{_key(*case): np.array(jax_lines(*case)) for case in CASES})
        print(f"wrote {FIXTURE}")
