"""The port's uint8 resize against OpenCV and the JAX package, bit for bit.

The port imports no OpenCV (``tests/test_torch_isolation.py``); its
``_resize`` reproduces ``cv2.resize(..., INTER_LINEAR)`` in integer
arithmetic.  ``cv2`` is importable in the tests, so the sweep holds it to
OpenCV itself: upscales and downscales, an exact 2x, odd widths whose byte
count is not a multiple of 16, 1-pixel rows and columns, 1080p -> 416 and
128 -> 416, on random, saturated and black-and-white images.
"""

import cv2
import numpy as np
import pytest

from viddet_tpu.data.clip_transforms import ClipValTransform as JaxClipValTransform
from viddet_tpu.data.transforms import ValTransform as JaxValTransform
from viddet_tpu_torch.data.clip_transforms import ClipValTransform
from viddet_tpu_torch.data.transforms import ValTransform, _resize

SHAPES = [  # (source h, w) -> (destination h, w)
    ((480, 640), (416, 416)),
    ((1080, 1920), (416, 416)),
    ((128, 128), (416, 416)),
    ((200, 200), (100, 100)),  # exact 2x down
    ((64, 64), (128, 128)),  # exact 2x up
    ((101, 37), (96, 128)),
    ((3, 129), (17, 43)),
    ((64, 517), (31, 129)),
    ((1, 50), (7, 9)),  # 1-pixel row
    ((50, 1), (9, 7)),  # 1-pixel column
    ((1, 1), (5, 5)),
    ((5, 5), (1, 1)),
    ((9, 9), (1, 416)),
    ((416, 416), (416, 416)),  # identity
    ((33, 77), (66, 154)),
    ((7, 7), (416, 416)),
    ((600, 400), (416, 277)),
    ((360, 500), (300, 416)),
    ((2, 3), (3, 2)),
    ((1000, 3), (10, 1)),
    ((719, 1279), (233, 415)),
]


def _images(shape, seed):
    rng = np.random.default_rng(seed)
    noise = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    binary = (rng.integers(0, 2, shape + (3,)) * 255).astype(np.uint8)
    return {"random": noise, "saturated": np.full_like(noise, 255), "binary": binary}


@pytest.mark.parametrize("src,dst", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_resize_equals_opencv(src, dst):
    for name, image in _images(src, sum(src) + sum(dst)).items():
        want = cv2.resize(image, dst[::-1], interpolation=cv2.INTER_LINEAR)
        got = _resize(image, *dst)
        assert got.dtype == np.uint8 and got.shape == dst + (3,)
        np.testing.assert_array_equal(got, want.reshape(got.shape), err_msg=name)


@pytest.mark.parametrize("letterbox", [False, True])
@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("shape", [(480, 640), (1080, 1920), (101, 37), (128, 128)])
def test_val_transform_equals_jax(shape, normalize, letterbox):
    image = _images(shape, 7)["random"]
    label = np.array([[10, 20, 30, 40, 1], [-1, -1, -1, -1, -1]], np.float32)
    size = (416, 416) if shape[0] > 200 else (96, 128)
    got = ValTransform(size, letterbox_resize=letterbox, normalize=normalize)(image, label)
    want = JaxValTransform(size, letterbox_resize=letterbox, normalize=normalize)(image, label)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("letterbox", [False, True])
def test_clip_val_transform_equals_jax(letterbox):
    clip = np.random.default_rng(4).integers(0, 256, (3, 90, 120, 3), dtype=np.uint8)
    label = np.array([[10.0, 10.0, 60.0, 70.0, 1.0]], np.float32)
    for normalize in (False, True):
        got = ClipValTransform((64, 48), letterbox, k=3, normalize=normalize)(clip, label)
        want = JaxClipValTransform((64, 48), letterbox, k=3, normalize=normalize)(clip, label)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    still = ClipValTransform((64, 48), letterbox, k=3, normalize=False)(clip[0])[0]
    assert still.shape == (3, 64, 48, 3) and (still == still[:1]).all()
    with pytest.raises(ValueError):
        ClipValTransform((64, 48), k=0)(clip[0])
    with pytest.raises(ValueError):
        ClipValTransform((64, 48), k=5)(clip)
