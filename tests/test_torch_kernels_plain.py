"""Each kernel's plain PyTorch version against its Pallas kernel.

The port's wrappers run the plain version for CPU tensors; the Pallas
kernels run in interpret mode, as the JAX package's own tests run them.
K2, K5 and K6 must be exact.  K1 and K3 may differ in the last bits of
the sigmoid and exp: XLA's and PyTorch's CPU versions are different
implementations and differ by up to 2 ulp (2 * 2^-23 relative at most), so
a product of two sigmoids is held at rtol 6e-7 (4 ulp plus the product's
own rounding).  A K3 box corner is centre -/+ half size, each a few ulp
apart between the frameworks, and the sum or difference can cancel; so
each corner is held at K3_BOX_ULP ulp of max(|x1|, |x2|) (or of y) of
the reference box, the larger of the two operands' magnitudes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viddet_tpu.ops.nms import _compact_and_pad as jax_compact_and_pad
from viddet_tpu.ops.nms import nms_keep_mask as jax_nms_keep_mask
from viddet_tpu.ops.nms_gather_pallas import anchor_scores as jax_anchor_scores
from viddet_tpu.ops.nms_gather_pallas import gather_decode_pairs as jax_gather_decode_pairs
from viddet_tpu.ops.nms_pallas import compact_and_pad_pallas, nms_keep_mask_pallas
from viddet_tpu.ops.topk_pallas import topk_indices_pallas
from viddet_tpu_torch.ops.nms import _pair_top_k_det
from viddet_tpu_torch.ops.nms_cuda import compact_and_pad, nms_keep_mask
from viddet_tpu_torch.ops.nms_gather_cuda import anchor_scores, gather_decode_pairs
from viddet_tpu_torch.ops.topk_cuda import topk_indices

K1_RTOL = 6e-7
K3_PAIR_RTOL = K1_RTOL
K3_BOX_ULP = 4

# ---------------------------------------------------------------- K1


def _meta(cells_hw, anchors_per_scale=3, strides=(32, 16, 8)):
    anchors = tuple((float(10 * (i + 1)), float(12 * (i + 1))) for i in range(anchors_per_scale))
    return tuple((h * w, w, s, anchors) for (h, w), s in zip(cells_hw, strides))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("num_classes", [4, 80])
def test_anchor_scores_matches_pallas(dtype, num_classes):
    rng = np.random.default_rng(3)
    meta = _meta([(2, 3), (4, 6), (8, 12)])
    na, num_pred = 3, 5 + num_classes
    raws = []
    for cells, *_ in meta:
        x = rng.normal(0, 3, size=(2, cells, na * num_pred)).astype(np.float32)
        raws.append(np.asarray(jnp.asarray(x, dtype).astype(jnp.float32)))  # dtype-exact
    want = np.asarray(jax_anchor_scores(
        tuple(jnp.asarray(r, dtype) for r in raws), meta, interpret=True))
    got = anchor_scores([torch.tensor(r).to(getattr(torch, dtype)) for r in raws], na)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=K1_RTOL, atol=0)


def test_anchor_scores_takes_the_max_in_the_raw_dtype():
    """Two bf16 class logits that are equal in bf16 give one score."""
    x = torch.zeros((1, 1, 3 * 7))
    x[0, 0, 5], x[0, 0, 6] = 1.0, 1.001  # 1.001 rounds to 1.0 in bf16
    s = anchor_scores([x.to(torch.bfloat16)], 3)
    assert s[0, 0].item() == (torch.sigmoid(torch.tensor(0.0)) * torch.sigmoid(torch.tensor(1.0))).item()


# ---------------------------------------------------------------- K3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("num_classes,k", [(4, 17), (80, 64)])
def test_gather_decode_pairs_matches_pallas(dtype, num_classes, k):
    """The extract_m=0 form: winners from every scale, in any order, with
    repeats, and the first and last flat index."""
    rng = np.random.default_rng(5 + k)
    meta = _meta([(2, 3), (4, 6), (8, 12)])
    na, num_pred = 3, 5 + num_classes
    n = sum(m[0] for m in meta) * na
    raws = []
    for cells, *_ in meta:
        x = rng.normal(0, 2, size=(2, cells, na * num_pred)).astype(np.float32)
        raws.append(np.asarray(jnp.asarray(x, dtype).astype(jnp.float32)))  # dtype-exact
    idx = rng.integers(0, n, size=(2, k)).astype(np.int32)
    idx[:, 0], idx[:, 1], idx[1, 2] = 0, n - 1, idx[1, 3]
    w_boxes, w_pairs = jax_gather_decode_pairs(
        tuple(jnp.asarray(r, dtype) for r in raws), jnp.asarray(idx), meta, interpret=True)
    boxes, pairs = gather_decode_pairs(
        [torch.tensor(r).to(getattr(torch, dtype)) for r in raws],
        torch.from_numpy(idx).long(), meta)
    assert boxes.dtype == pairs.dtype == torch.float32
    assert boxes.shape == (2, k, 4) and pairs.shape == (2, k, num_classes)
    np.testing.assert_allclose(pairs.numpy(), np.asarray(w_pairs), rtol=K3_PAIR_RTOL, atol=0)
    w_boxes = np.asarray(w_boxes)
    scale = np.maximum(np.abs(w_boxes[..., :2]), np.abs(w_boxes[..., 2:]))
    ulps = np.abs(boxes.numpy() - w_boxes) / (np.tile(scale, 2) * 2.0**-23)
    assert ulps.max() <= K3_BOX_ULP, ulps.max()


# ---------------------------------------------------------------- K2


def _check_topk(scores, k):
    want = np.asarray(topk_indices_pallas(jnp.asarray(scores), k, interpret=True))
    got = topk_indices(torch.from_numpy(scores), k)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,k", [(10647, 400), (252, 40), (130, 130), (7, 3)])
def test_topk_matches_pallas_random(n, k):
    rng = np.random.default_rng(0)
    _check_topk(rng.uniform(0.0, 1.0, size=(3, n)).astype(np.float32), k)


def test_topk_ties_lowest_index_first():
    scores = np.zeros((2, 500), np.float32)
    scores[:, ::3] = 0.5
    scores[0, 10] = 0.9
    scores[1, 499] = 0.7
    _check_topk(scores, 40)


def test_topk_all_equal():
    _check_topk(np.full((1, 300), 0.25, np.float32), 50)


def test_topk_zeros_subnormals_and_padding():
    rng = np.random.default_rng(1)
    scores = np.zeros((2, 200), np.float32)
    scores[:, :20] = rng.uniform(1e-40, 1e-38, size=(2, 20))
    scores[:, 150::5] = -1.0
    _check_topk(scores, 150)


def test_topk_k_equals_n():
    _check_topk(np.random.default_rng(2).uniform(size=(2, 131)).astype(np.float32), 131)


@pytest.mark.parametrize("k", [0, 11])
def test_topk_rejects_bad_k(k):
    with pytest.raises(ValueError):
        topk_indices(torch.zeros((1, 10)), k)


def test_topk_rejects_too_few_valid_scores():
    scores = torch.full((1, 10), -1.0)
    scores[0, :3] = 0.5
    with pytest.raises(ValueError):
        topk_indices(scores, 4)


def test_pair_top_k_det_matches_lax_top_k():
    """Values AND indices equal lax.top_k, including tie order
    (tests/unit/test_nms_two_stage.py:189)."""
    rng = np.random.default_rng(11)
    n = 1000
    random_s = rng.uniform(0, 1, size=(3, n)).astype(np.float32)
    tied = (rng.integers(0, 4, size=(3, n)) / 4.0).astype(np.float32)
    with_sentinels = random_s.copy()
    with_sentinels[:, ::7] = -1.0
    for arr in (random_s, tied, with_sentinels):
        for k in (1, 17, 400):
            want_v, want_i = jax.lax.top_k(jnp.asarray(arr), k)
            got_v, got_i = _pair_top_k_det(torch.from_numpy(arr), k)
            np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
            np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


# ---------------------------------------------------------------- K5


def _random_boxes(rng, b, k, dup_every=0):
    pts = rng.uniform(0, 100, size=(b, k, 2, 2)).astype(np.float32)
    boxes = np.concatenate([pts.min(2), pts.max(2)], axis=-1)
    if dup_every:
        boxes[:, dup_every::dup_every] = boxes[:, :1]
    return boxes


@pytest.mark.parametrize("k,thresh", [(64, 0.5), (96, 0.45), (200, 0.3)])
def test_nms_keep_mask_matches_pallas(k, thresh):
    rng = np.random.default_rng(k)
    boxes = _random_boxes(rng, 3, k, dup_every=5)
    valid = rng.uniform(size=(3, k)) > 0.2
    valid[2] = False
    want = np.asarray(nms_keep_mask_pallas(
        jnp.asarray(boxes), jnp.asarray(valid), thresh, interpret=True))
    got = nms_keep_mask(torch.from_numpy(boxes), torch.from_numpy(valid), thresh)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # and the JAX package's per-image oracle
    oracle = np.stack([np.asarray(jax_nms_keep_mask(
        jnp.asarray(boxes[i]), None, jnp.asarray(valid[i]), thresh)) for i in range(3)])
    np.testing.assert_array_equal(got.numpy() > 0.5, oracle)


def test_nms_keep_mask_nested_and_identical_boxes():
    k = 40
    half = np.linspace(30, 1, k, dtype=np.float32)[:, None]
    nested = np.concatenate([50 - half, 50 - half, 50 + half, 50 + half], axis=1)
    same = np.tile(np.array([[1, 2, 30, 40]], np.float32), (k, 1))
    boxes = np.stack([nested, same])
    valid = np.ones((2, k), bool)
    want = np.asarray(nms_keep_mask_pallas(
        jnp.asarray(boxes), jnp.asarray(valid), 0.45, interpret=True))
    got = nms_keep_mask(torch.from_numpy(boxes), torch.from_numpy(valid), 0.45)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[1].sum().item() == 1.0


# ---------------------------------------------------------------- K6


@pytest.mark.parametrize("b,k,post", [(5, 96, 24), (8, 128, 100), (7, 64, 8)])
def test_compact_and_pad_matches_pallas(b, k, post):
    """Edge cases of tests/unit/test_nms_two_stage.py:146: more kept than
    post_nms, none kept, all kept."""
    rng = np.random.default_rng(7 + k)
    boxes = _random_boxes(rng, b, k)
    scores = -np.sort(-rng.uniform(size=(b, k)).astype(np.float32), axis=1)
    cls_idx = rng.integers(0, 20, size=(b, k)).astype(np.float32)
    keep = rng.uniform(size=(b, k)) > 0.4
    keep[0] = True
    keep[1] = False
    keep_f = keep.astype(np.float32)
    want = compact_and_pad_pallas(jnp.asarray(keep_f), jnp.asarray(scores),
                                  jnp.asarray(cls_idx), jnp.asarray(boxes), post,
                                  interpret=True)
    oracle = jax.vmap(jax_compact_and_pad, in_axes=(0, 0, 0, 0, None))(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(cls_idx), jnp.asarray(keep), post)
    got = compact_and_pad(torch.from_numpy(keep_f), torch.from_numpy(scores),
                          torch.from_numpy(cls_idx), torch.from_numpy(boxes), post)
    for g, w, o in zip(got, want, oracle):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy(), np.asarray(o))
