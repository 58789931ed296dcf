"""The port's DetectionLoader against the JAX package's.

Every case of ``tests/unit/test_loader.py`` runs with ``DetectionLoader``,
``pad_label`` and ``ValTransform`` twinned (``tests/test_torch_metrics.py``):
both loaders iterate together and every batch must be equal array for
array, as must their lengths and ``dropped_boxes``; a worker's exception
must reach both consumers.  Both loaders read the JAX test's own datasets,
and its train cases pass both the JAX ``TrainTransform`` (the port has no
training transform yet), so they hold the loader's shuffling, sharding,
multi-scale schedule and per-sample seeds.  Then the eval batches of the
port's loader and ``ValTransform`` on the port's synthetic set equal JAX's
at 0 and 4 workers, plain and letterboxed, float and uint8.
"""

import numpy as np
import pytest

import viddet_tpu.data.loader as jax_loader
import viddet_tpu.data.synthetic as jax_synthetic
import viddet_tpu.data.transforms as jax_transforms
import viddet_tpu_torch.data.loader as torch_loader
import viddet_tpu_torch.data.synthetic as torch_synthetic
import viddet_tpu_torch.data.transforms as torch_transforms
from tests.test_torch_metrics import assert_same, install_twins, mirrored_cases, run_mirrored
from tests.unit import test_loader

TWINNED = (
    (jax_loader, torch_loader, ("DetectionLoader", "pad_label")),
    (jax_transforms, torch_transforms, ("ValTransform",)),
)


@pytest.mark.parametrize("fn, kwargs", list(mirrored_cases((test_loader,))))
def test_loader_case_matches_jax(fn, kwargs, monkeypatch, tmp_path):
    install_twins(monkeypatch, TWINNED, (test_loader,))
    run_mirrored(fn, kwargs, tmp_path)


def test_max_gt_boxes_matches_jax():
    assert torch_loader.MAX_GT_BOXES == jax_loader.MAX_GT_BOXES


@pytest.mark.parametrize("workers", [0, 4])
@pytest.mark.parametrize("letterbox", [False, True])
@pytest.mark.parametrize("normalize", [True, False])
def test_eval_batches_match_jax(workers, letterbox, normalize):
    batches = []
    for synthetic, loader, transforms in ((jax_synthetic, jax_loader, jax_transforms),
                                          (torch_synthetic, torch_loader, torch_transforms)):
        ds = synthetic.SyntheticDetection(num_images=11, size=150, num_classes=8,
                                          max_objects=4, seed=3)
        tf = transforms.ValTransform(size=(96, 96), letterbox_resize=letterbox,
                                     normalize=normalize)
        batches.append(list(loader.DetectionLoader(ds, tf, batch_size=4, train=False,
                                                   num_workers=workers, max_boxes=6)))
    assert len(batches[0]) == len(batches[1]) == 3
    for k, (want, got) in enumerate(zip(*batches)):
        assert_same(want, got, f"batch {k}")
    assert batches[1][0][0].dtype == (np.float32 if normalize else np.uint8)
