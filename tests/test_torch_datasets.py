"""The port's datasets and packed shards against the JAX package's.

Every case of ``tests/unit/test_datasets.py`` and ``tests/unit/test_packed.py``
runs with the dataset classes, the packing functions and ``get_dataset``
twinned (``tests/test_torch_metrics.py``): each is built from the same
arguments in both packages, and every label, image, length, class list and
statistic read from it must be equal, images bit for bit (the port decodes
with its own libjpeg reader, JAX with ``cv2.imread`` / ``cv2.imdecode``).
Then every item of each generated tree is compared, on trees that also
hold a greyscale JPEG and one with an EXIF orientation tag.
"""

import json
import struct

import cv2
import numpy as np
import pytest

import viddet_tpu.cli.common as jax_common
import viddet_tpu.data.coco as jax_coco
import viddet_tpu.data.combined as jax_combined
import viddet_tpu.data.imgnetdet as jax_det
import viddet_tpu.data.imgnetvid as jax_vid
import viddet_tpu.data.packed as jax_packed
import viddet_tpu.data.synthetic as jax_synthetic
import viddet_tpu.data.voc as jax_voc
import viddet_tpu_torch.cli.common as torch_common
import viddet_tpu_torch.data.coco as torch_coco
import viddet_tpu_torch.data.combined as torch_combined
import viddet_tpu_torch.data.imgnetdet as torch_det
import viddet_tpu_torch.data.imgnetvid as torch_vid
import viddet_tpu_torch.data.packed as torch_packed
import viddet_tpu_torch.data.synthetic as torch_synthetic
import viddet_tpu_torch.data.voc as torch_voc
from tests.test_torch_metrics import assert_same, install_twins, mirrored_cases, run_mirrored
from tests.unit import test_datasets, test_packed
from tests.unit.test_datasets import coco_root, det_root, vid_root, voc_root  # noqa: F401 -- fixtures

TWINNED = (
    (jax_voc, torch_voc, ("VOCDetection",)),
    (jax_coco, torch_coco, ("COCODetection",)),
    (jax_det, torch_det, ("ImageNetDetection",)),
    (jax_vid, torch_vid, ("ImageNetVidDetection",)),
    (jax_combined, torch_combined, ("CombinedDetection",)),
    (jax_synthetic, torch_synthetic, ("SyntheticDetection",)),
    (jax_packed, torch_packed, ("PackedDetection", "pack_dataset", "write_shard", "open_packed")),
    (jax_common, torch_common, ("get_dataset",)),
)
MIRRORED = (test_datasets, test_packed)


@pytest.mark.parametrize("fn, kwargs", list(mirrored_cases(MIRRORED)))
def test_dataset_case_matches_jax(fn, kwargs, monkeypatch, request, tmp_path):
    install_twins(monkeypatch, TWINNED, MIRRORED)
    for name in ("voc_root", "coco_root", "vid_root", "det_root"):
        if name in fn.__code__.co_varnames[: fn.__code__.co_argcount]:
            kwargs = dict(kwargs, **{name: request.getfixturevalue(name)})
    run_mirrored(fn, kwargs, tmp_path)


def assert_datasets_equal(jax_ds, torch_ds):
    assert len(jax_ds) == len(torch_ds)
    assert_same(tuple(jax_ds.classes), tuple(torch_ds.classes))
    assert_same(tuple(jax_ds.wn_classes), tuple(torch_ds.wn_classes))
    for i in range(len(jax_ds)):
        assert_same(jax_ds.label(i), torch_ds.label(i), f"label {i}")
        assert_same(jax_ds[i], torch_ds[i], f"item {i}")
    assert_same(jax_ds.statistics(), torch_ds.statistics())


def _exif_jpeg(path, orientation):
    """A cv2 JPEG with an APP1 EXIF Orientation entry after SOI."""
    rng = np.random.default_rng(orientation)
    data = cv2.imencode(".jpg", rng.integers(0, 256, (60, 80, 3), dtype=np.uint8))[1].tobytes()
    tiff = (b"II" + struct.pack("<HI", 42, 8) + struct.pack("<H", 1)
            + struct.pack("<HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack("<I", 0))
    app1 = b"Exif\x00\x00" + tiff
    path.write_bytes(data[:2] + b"\xff\xe1" + struct.pack(">H", len(app1) + 2) + app1 + data[2:])


@pytest.fixture
def coco_mixed(coco_root):  # noqa: F811 -- the imported fixture
    """The COCO tree with a greyscale image and an EXIF-rotated one added."""
    from pathlib import Path

    root = Path(coco_root)
    ann_path = root / "annotations" / "instances_val2017.json"
    data = json.loads(ann_path.read_text())
    cv2.imwrite(str(root / "val2017" / "grey.jpg"),
                np.random.default_rng(5).integers(0, 256, (60, 80), dtype=np.uint8))
    _exif_jpeg(root / "val2017" / "rot.jpg", 6)
    data["images"] += [{"id": 11, "file_name": "grey.jpg", "width": 80, "height": 60},
                       {"id": 12, "file_name": "rot.jpg", "width": 60, "height": 80}]
    data["annotations"] += [{"image_id": 11, "category_id": 18, "bbox": [3, 4, 20, 10]},
                            {"image_id": 12, "category_id": 3, "bbox": [1, 2, 30, 40]}]
    ann_path.write_text(json.dumps(data))
    return coco_root


@pytest.mark.parametrize("tree", ["voc", "coco", "det", "vid", "vid_clips", "combined",
                                  "packed", "synthetic"])
def test_every_item_matches_jax(tree, voc_root, coco_mixed, det_root, vid_root, tmp_path):  # noqa: F811
    if tree == "voc":
        make = lambda mod: mod.VOCDetection(voc_root, splits=(("2007", "trainval"),))  # noqa: E731
    elif tree == "coco":
        make = lambda mod: mod.COCODetection(coco_mixed, split="val2017")  # noqa: E731
    elif tree == "det":
        make = lambda mod: mod.ImageNetDetection(det_root, split="train", allow_empty=True)  # noqa: E731
    elif tree == "vid":
        make = lambda mod: mod.ImageNetVidDetection(vid_root, frames_fraction=0.75)  # noqa: E731
    elif tree == "vid_clips":
        make = lambda mod: mod.ImageNetVidDetection(vid_root, window=3, stride=2,  # noqa: E731
                                                    allow_empty=True)
    elif tree == "combined":
        def make(mods):
            combined, det, vid = mods
            return combined.CombinedDetection([det.ImageNetDetection(det_root, split="train"),
                                               vid.ImageNetVidDetection(vid_root)])
    elif tree == "packed":
        src = jax_coco.COCODetection(coco_mixed, split="val2017")
        (tmp_path / "pk").mkdir()
        jax_packed.pack_dataset(src, str(tmp_path / "pk" / "val"), shard_size=3, split="val")
        make = lambda mod: mod.open_packed(str(tmp_path / "pk"), split="val")  # noqa: E731
    else:
        make = lambda mod: mod.SyntheticDetection(num_images=6, size=96, num_classes=8,  # noqa: E731
                                                  max_objects=5, seed=4)
    modules = {"voc": (jax_voc, torch_voc), "coco": (jax_coco, torch_coco),
               "det": (jax_det, torch_det), "vid": (jax_vid, torch_vid),
               "vid_clips": (jax_vid, torch_vid),
               "combined": ((jax_combined, jax_det, jax_vid),
                            (torch_combined, torch_det, torch_vid)),
               "packed": (jax_packed, torch_packed),
               "synthetic": (jax_synthetic, torch_synthetic)}[tree]
    assert_datasets_equal(*(make(mod) for mod in modules))


def test_get_dataset_branches_match_jax(voc_root, coco_root, det_root, vid_root):  # noqa: F811
    """Each --dataset value builds the same dataset and the same metric."""
    from pathlib import Path

    test_root = Path(voc_root) / "VOC2007" / "ImageSets" / "Main"
    (test_root / "test.txt").write_text("000002\n")
    cases = (("voc", voc_root, "val"), ("coco", coco_root, "val"), ("vid", vid_root, "val"),
             ("det", det_root, "train"), ("synthetic", "synthetic", "val"),
             ("synthetic", "synthetic", "train"))
    for name, root, split in cases:
        (jds, jmf), (tds, tmf) = (mod.get_dataset(name, root, split=split)
                                  for mod in (jax_common, torch_common))
        assert_datasets_equal(jds, tds)
        jm, tm = jmf(list(jds.classes)), tmf(list(tds.classes))
        assert type(jm).__name__ == type(tm).__name__
    with pytest.raises(ValueError):
        torch_common.get_dataset("nope", "x")
    with pytest.raises(ValueError, match="--data-root"):
        torch_common.get_dataset("det+vid", "a,b,c")
