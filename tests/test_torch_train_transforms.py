"""The port's training transforms against OpenCV and the JAX package, bit
for bit.

The port imports no OpenCV; ``rgb_to_hsv`` and ``hsv_to_rgb`` reproduce
``cv2.cvtColor``'s uint8 conversions and are held to ``cv2`` (5.0, which
the tests import) over the whole uint8 cubes: all 2**24 RGB colours, and
all 180 * 256 * 256 HSV triples at row widths that take OpenCV's vector
loop, its scalar loop and both.  ``TrainTransform``, ``ClipTrainTransform``
and each augmentation equal the JAX package's under the same seeds (one
seed draws one sample in both), and the cases of
``tests/unit/test_transforms.py`` run on the port.
"""

import cv2
import numpy as np
import pytest

from viddet_tpu.data import transforms as J
from viddet_tpu.data.clip_transforms import ClipTrainTransform as JaxClipTrainTransform
from viddet_tpu_torch.data import transforms as T
from viddet_tpu_torch.data.clip_transforms import ClipTrainTransform, ClipValTransform

CHUNKS = 16  # the cubes in slices, to bound the tests' memory


def make_image(h=100, w=150, seed=0):
    return np.random.default_rng(seed).integers(0, 255, size=(h, w, 3), dtype=np.uint8)


def test_rgb_to_hsv_whole_cube():
    cube = np.arange(1 << 24, dtype=np.uint32)
    rgb = np.stack([(cube >> 16) & 255, (cube >> 8) & 255, cube & 255], -1).astype(np.uint8)
    for chunk in np.array_split(rgb, CHUNKS):
        img = chunk.reshape(-1, 1024, 3)
        np.testing.assert_array_equal(T.rgb_to_hsv(img), cv2.cvtColor(img, cv2.COLOR_RGB2HSV))


@pytest.mark.parametrize("width", [1024, 30, 1021])  # vector loop, scalar loop, both
def test_hsv_to_rgb_whole_cube(width):
    h, s, v = np.meshgrid(np.arange(180), np.arange(256), np.arange(256), indexing="ij")
    hsv = np.stack([h, s, v], -1).reshape(-1, 3).astype(np.uint8)
    hsv = np.concatenate([hsv, hsv[: -hsv.shape[0] % width]])  # whole rows
    for chunk in np.array_split(hsv.reshape(-1, width, 3), CHUNKS):
        np.testing.assert_array_equal(T.hsv_to_rgb(chunk), cv2.cvtColor(chunk, cv2.COLOR_HSV2RGB))


def test_hsv_round_trip_on_images():
    for seed, (h, w) in enumerate([(7, 5), (33, 97), (64, 64), (100, 150)]):
        img = make_image(h, w, seed)
        hsv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV)
        np.testing.assert_array_equal(T.rgb_to_hsv(img), hsv)
        np.testing.assert_array_equal(T.hsv_to_rgb(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))


def _label(w, h):
    return np.array([[5, 5, w // 2, h // 2, 1, 0], [w // 3, h // 3, w - 2, h - 2, 0, 0],
                     [-1, -1, -1, -1, -1, -1]], np.float32)


@pytest.mark.parametrize("letterbox", [False, True])
@pytest.mark.parametrize("normalize", [False, True])
def test_train_transform_equals_jax(letterbox, normalize):
    rng = np.random.default_rng(int(letterbox) * 2 + int(normalize))
    for seed in range(40):
        h, w = (int(x) for x in rng.integers(16, 320, 2))
        img, label = make_image(h, w, seed), _label(w, h)
        size = (64, 96) if seed % 2 else (96, 64)
        args = dict(size=size, letterbox_resize=letterbox, normalize=normalize)
        got = T.TrainTransform(**args)(img, label.copy(), np.random.default_rng(seed))
        want = J.TrainTransform(**args)(img, label.copy(), np.random.default_rng(seed))
        np.testing.assert_array_equal(got[0], want[0], err_msg=f"image, seed {seed}")
        np.testing.assert_array_equal(got[1], want[1], err_msg=f"label, seed {seed}")


@pytest.mark.parametrize("name", ["random_color_distort", "random_expand",
                                  "random_crop_with_constraints", "random_hflip"])
def test_each_augmentation_equals_jax(name):
    for seed in range(32):
        img = make_image(40 + seed, 70 - seed, seed)
        args = (img,) if name == "random_color_distort" else (img, _label(70 - seed, 40 + seed))
        got = getattr(T, name)(*args, np.random.default_rng(seed))
        want = getattr(J, name)(*args, np.random.default_rng(seed))
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            np.testing.assert_array_equal(a, b, err_msg=f"{name}, seed {seed}")


def test_clip_train_transform_equals_jax():
    for seed in range(8):
        clip = np.stack([make_image(60, 80, seed + i) for i in range(3)])
        label = _label(80, 60)
        got = ClipTrainTransform(size=(48, 48), k=3, normalize=False)(
            clip, label.copy(), np.random.default_rng(seed))
        want = JaxClipTrainTransform(size=(48, 48), k=3, normalize=False)(
            clip, label.copy(), np.random.default_rng(seed))
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


# ------------------------------------------ tests/unit/test_transforms.py


def test_train_transform_deterministic_under_seed():
    img = make_image()
    label = np.array([[10.0, 10.0, 60.0, 80.0, 2.0, 0.0]])
    tf = T.TrainTransform(size=(64, 64))
    out1, lab1 = tf(img, label.copy(), np.random.default_rng(42))
    out2, lab2 = tf(img, label.copy(), np.random.default_rng(42))
    np.testing.assert_array_equal(out1, out2)
    np.testing.assert_array_equal(lab1, lab2)
    out3, _ = tf(img, label.copy(), np.random.default_rng(43))
    assert not np.array_equal(out1, out3)


def test_train_transform_output_shape_and_range():
    img = make_image()
    label = np.array([[10.0, 10.0, 60.0, 80.0, 2.0, 0.0]])
    tf = T.TrainTransform(size=(96, 64))
    for seed in range(5):
        out, lab = tf(img, label.copy(), np.random.default_rng(seed))
        assert out.shape == (96, 64, 3) and out.dtype == np.float32
        valid = lab[(lab[:, 4] >= 0)]
        if len(valid):
            assert (valid[:, 0] <= valid[:, 2]).all()
            assert (valid[:, [0, 2]] <= 64 + 1e-3).all()
            assert (valid[:, [1, 3]] <= 96 + 1e-3).all()


def test_hflip_boxes():
    img = make_image(10, 100)
    boxes = np.array([[10.0, 1.0, 30.0, 5.0, 0.0, 0.0]])
    for seed in range(20):
        out, ob = T.random_hflip(img, boxes, np.random.default_rng(seed))
        if not np.array_equal(out, img):
            np.testing.assert_allclose(ob[0, :4], [70.0, 1.0, 90.0, 5.0])
            return
    raise AssertionError("no flip in 20 seeds")


def test_clip_transforms_tile_stills_to_static_clips():
    img = make_image(80, 120)
    label = np.array([[10.0, 10.0, 60.0, 70.0, 1.0, 0.0]])
    out, _, _ = ClipValTransform(size=(64, 64), letterbox_resize=True, k=3)(img, label)
    assert out.shape == (3, 64, 64, 3)
    np.testing.assert_array_equal(out[0], out[2])
    out_t, _ = ClipTrainTransform(size=(64, 64), k=3)(img, label.copy(),
                                                      np.random.default_rng(0))
    assert out_t.shape == (3, 64, 64, 3)
    np.testing.assert_array_equal(out_t[0], out_t[2])


def test_clip_train_transform_rejects_mismatched_clips():
    img = make_image(40, 40)
    label = np.array([[1.0, 1.0, 20.0, 20.0, 0.0, 0.0]])
    with pytest.raises(ValueError, match="expects k=3"):
        ClipTrainTransform(size=(32, 32), k=3)(np.stack([img, img]), label,
                                                np.random.default_rng(0))
    with pytest.raises(ValueError, match="no k set"):
        ClipTrainTransform(size=(32, 32))(img, label, np.random.default_rng(0))


def test_color_distort_lut_matches_float_chain():
    """The LUT form equals the direct full-image float chain with the same
    gating, through OpenCV's own HSV conversions."""

    def oracle(image, rng):
        b = c = None
        if rng.random() < 0.5:
            b = rng.uniform(-32, 32)
        if rng.random() < 0.5:
            c = rng.uniform(0.5, 1.5)
        if b is not None or c is not None:
            img = image.astype(np.float32)
            if b is not None:
                img = img + np.float32(b)
            if c is not None:
                img = img * np.float32(c)
            image = np.clip(img, 0, 255).astype(np.uint8)
        k = d = None
        if rng.random() < 0.5:
            k = rng.uniform(0.5, 1.5)
        if rng.random() < 0.5:
            d = rng.uniform(-18, 18)
        if k is not None or d is not None:
            hsv = cv2.cvtColor(image, cv2.COLOR_RGB2HSV).astype(np.float32)
            if k is not None:
                hsv[..., 1] = hsv[..., 1] * np.float32(k)
            if d is not None:
                hsv[..., 0] = (hsv[..., 0] + np.float32(d)) % 180
            hsv[..., 1:] = np.clip(hsv[..., 1:], 0, 255)
            image = cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2RGB)
        return image

    base = np.random.default_rng(0).integers(0, 255, (97, 113, 3)).astype(np.uint8)
    for seed in range(64):
        np.testing.assert_array_equal(T.random_color_distort(base, np.random.default_rng(seed)),
                                      oracle(base, np.random.default_rng(seed)))
