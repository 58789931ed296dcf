"""K7's plain version (``viddet_tpu_torch/ops/roi_align.py``) against the
JAX package's ROIAlign: the packed oracle ``multilevel_roi_align_packed``
(at 1e-5, float32 and bf16 pyramids), the Pallas kernel in interpret mode
inside its exactness domain (at 1e-4, the JAX package's own tolerance for
it), and ``fpn_roi_level`` at the level boundaries.  The CUDA kernel is
held to the plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viddet_tpu.ops.roi_align import fpn_roi_level as jax_fpn_roi_level
from viddet_tpu.ops.roi_align import multilevel_roi_align_packed as jax_packed
from viddet_tpu.ops.roi_align_pallas import WINDOW, multilevel_roi_align_pallas
from viddet_tpu_torch.ops import roi_align_cuda
from viddet_tpu_torch.ops.roi_align import fpn_roi_level, multilevel_roi_align_packed

STRIDES = (4, 8, 16, 32)


def _pyramid(rng, b, c, image):
    return [rng.normal(size=(b, image // s, image // s, c)).astype(np.float32) for s in STRIDES]


def _in_domain_rois(rng, b, r, image, max_aspect=2.5):
    """``tests/unit/test_roi_align.py:84-102``'s generator: sizes over every
    level, aspects inside the Pallas kernel's exact domain, clipped to the
    image."""
    size = rng.uniform(8, image * 0.9, size=(b, r))
    aspect = rng.uniform(1.0 / max_aspect, max_aspect, size=(b, r))
    w_box, h_box = size * np.sqrt(aspect), size / np.sqrt(aspect)
    cx, cy = rng.uniform(0, image, size=(b, r)), rng.uniform(0, image, size=(b, r))
    rois = np.stack([cx - w_box / 2, cy - h_box / 2, cx + w_box / 2, cy + h_box / 2], axis=-1)
    return np.clip(rois, 0, image).astype(np.float32)


def _oracle(pyramid, rois, dtype=jnp.float32):
    maps = [jnp.asarray(p).astype(dtype) for p in pyramid]
    return np.asarray(jax.vmap(lambda m, bx: jax_packed(m, bx, strides=STRIDES))(
        maps, jnp.asarray(rois)))


def _port(pyramid, rois, dtype=torch.float32):
    maps = [torch.from_numpy(p).to(dtype) for p in pyramid]
    out = multilevel_roi_align_packed(maps, torch.from_numpy(rois), STRIDES)
    assert out.dtype == torch.float32
    return out.numpy()


def _pallas(pyramid, rois):
    return np.asarray(multilevel_roi_align_pallas(
        [jnp.asarray(p) for p in pyramid], jnp.asarray(rois), strides=STRIDES, interpret=True))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_packed_oracle(dtype):
    rng = np.random.default_rng(0)
    pyramid = _pyramid(rng, 2, 8, 128)
    pts = rng.uniform(-30, 160, size=(2, 40, 2, 2)).astype(np.float32)
    rois = np.concatenate([pts.min(2), pts.max(2) + rng.uniform(0, 8, (2, 40, 1))], -1)
    rois = rois.astype(np.float32)
    want = _oracle(pyramid, rois, getattr(jnp, dtype))
    got = _port(pyramid, rois, getattr(torch, dtype))
    assert got.shape == want.shape == (2, 40, 7, 7, 8)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_plain_matches_pallas_interpret_in_its_domain():
    rng = np.random.default_rng(0)
    pyramid = _pyramid(rng, 2, 8, 128)
    rois = _in_domain_rois(rng, 2, 24, 128)
    np.testing.assert_allclose(_port(pyramid, rois), _pallas(pyramid, rois), rtol=0, atol=1e-4)


def test_rois_partly_or_wholly_outside_the_image():
    rng = np.random.default_rng(1)
    pyramid = _pyramid(rng, 1, 8, 128)
    rois = np.asarray([[[-20.0, -10.0, 40.0, 30.0], [100.0, 100.0, 160.0, 150.0],
                        [-300.0, -300.0, -200.0, -150.0], [200.0, 10.0, 260.0, 90.0],
                        [60.0, -5.0, 90.0, 20.0], [-8.0, -8.0, 136.0, 136.0],
                        [127.0, 127.0, 127.001, 127.001], [0.0, 0.0, 0.0, 0.0]]], np.float32)
    got = _port(pyramid, rois)
    np.testing.assert_allclose(got, _oracle(pyramid, rois), rtol=0, atol=1e-5)
    assert not got[0, 2].any() and not got[0, 3].any()  # wholly outside: all zero
    assert got[0, 0].any()


def test_wide_rois_follow_the_oracle_where_pallas_clips():
    """8:1 rois at the top of the level-2 band (sqrt(w*h) just under 112 px,
    79 cells wide on P2, more than the Pallas kernel's 48-cell window): the
    port follows the oracle and the TPU kernel does not."""
    rng = np.random.default_rng(2)
    pyramid = _pyramid(rng, 1, 8, 384)
    side = 111.0
    w, h = side * np.sqrt(8.0), side / np.sqrt(8.0)
    rois = np.asarray([[[20.0, 40.0, 20.0 + w, 40.0 + h],
                        [30.0, 200.0, 30.0 + h, 200.0 + w]]], np.float32)  # and 1:8
    assert (fpn_roi_level(torch.from_numpy(rois)) == 2).all()
    assert w / STRIDES[0] > WINDOW
    want = _oracle(pyramid, rois)
    np.testing.assert_allclose(_port(pyramid, rois), want, rtol=0, atol=1e-5)
    assert np.abs(_pallas(pyramid, rois) - want).max() > 1e-2


def test_fpn_roi_level_at_the_boundaries():
    sides = np.asarray([56.0, 112.0, 224.0, 448.0, 111.99, 112.01, 10.0, 1000.0], np.float32)
    zeros = np.zeros_like(sides)
    squares = np.stack([zeros, zeros, sides, sides], -1)
    # non-square rois of the same area: 28 x 112, 56 x 224, ...
    wide = np.stack([zeros, zeros, 2 * sides, sides / 2], -1)
    for rois in (squares, wide):
        got = fpn_roi_level(torch.from_numpy(rois)).numpy()
        np.testing.assert_array_equal(got, np.asarray(jax_fpn_roi_level(jnp.asarray(rois))))
    np.testing.assert_array_equal(fpn_roi_level(torch.from_numpy(squares)).numpy(),
                                  [2, 3, 4, 5, 2, 3, 2, 5])


def test_wrapper_runs_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(3)
    pyramid = [torch.from_numpy(p) for p in _pyramid(rng, 2, 4, 64)]
    rois = torch.from_numpy(_in_domain_rois(rng, 2, 5, 64))
    before = roi_align_cuda.multilevel_roi_align.launches
    got = roi_align_cuda.multilevel_roi_align(pyramid, rois, STRIDES)
    assert roi_align_cuda.multilevel_roi_align.launches == before
    assert torch.equal(got, multilevel_roi_align_packed(pyramid, rois, STRIDES))
