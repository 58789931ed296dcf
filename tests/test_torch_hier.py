"""The hierarchical tail of the port against the JAX package.

K3's ``extract_m`` form and K4's plain versions are held to the Pallas
kernels in interpret mode, and the port's hierarchical tail (the default,
``VIDDET_PAIR_TOPK`` unset) to JAX's ``multiclass_nms_late_decode_fused``
with ``backend="pallas_interpret"``, whose stage 2 ranks with
``lax.top_k``, as the port does.

Tolerances: top-m indices, hot-box indices and K4 exact.  The top-m values
and the hot rows are pair scores, which XLA's and PyTorch's CPU sigmoid
put up to a few ulp apart: rtol 6e-7, as the K3 test of
``tests/test_torch_kernels_plain.py``.  The tail holds ids exact, scores
within 1e-6 and boxes within 1e-4, as ``tests/test_torch_yolo3.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_kernels_plain import K3_BOX_ULP
from viddet_tpu.ops.nms import multiclass_nms_late_decode_fused
from viddet_tpu.ops.nms_gather_pallas import finalize_candidates as jax_finalize_candidates
from viddet_tpu.ops.nms_gather_pallas import gather_decode_pairs as jax_gather_decode_pairs
from viddet_tpu_torch.models import yolo3 as torch_yolo3
from viddet_tpu_torch.ops import nms as torch_nms
from viddet_tpu_torch.ops.nms import multiclass_nms_late_decode_cells
from viddet_tpu_torch.ops.nms_gather_cuda import finalize_candidates, gather_decode_pairs

PAIR_RTOL = 6e-7
ANCHORS = (
    ((116, 90), (156, 198), (373, 326)),
    ((30, 61), (62, 45), (59, 119)),
    ((10, 13), (16, 30), (33, 23)),
)
STRIDES = (32, 16, 8)


def _scales(rng, b, img, c, data="random"):
    """Per-scale cell tensors (float32 numpy) and their meta."""
    meta, cells = [], []
    for anc, st in zip(ANCHORS, STRIDES):
        w = img // st
        meta.append((w * w, w, st, tuple((float(x), float(y)) for x, y in anc)))
        x = rng.normal(0, 2, size=(b, w * w, len(anc) * (5 + c))).astype(np.float32)
        if data == "ties":  # coarse levels: many exact score ties
            x = np.round(x * 2) / 2
        cells.append(x)
    return tuple(meta), cells


def _dtype_exact(x, dtype):
    return np.asarray(jnp.asarray(x, dtype).astype(jnp.float32))


# ------------------------------------------------------------------ K3, m > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("num_classes,k,hot_j", [(20, 40, 5), (80, 64, 8)])
def test_gather_decode_top_m_matches_pallas(dtype, num_classes, k, hot_j):
    """Winners from every scale with repeats (equal m-th values, so the hot
    boxes tie and must go lowest winner index first) and the first and
    last flat index."""
    rng = np.random.default_rng(num_classes + k)
    meta, cells = _scales(rng, 2, 64, num_classes)
    cells = [_dtype_exact(x, dtype) for x in cells]
    n = sum(m[0] for m in meta) * 3
    idx = rng.integers(0, n, size=(2, k)).astype(np.int32)
    idx[:, 0], idx[:, 1] = 0, n - 1
    idx[0, k // 2 :] = idx[0, : k - k // 2]  # every winner of image 0 twice
    want = jax_gather_decode_pairs(tuple(jnp.asarray(x, dtype) for x in cells),
                                   jnp.asarray(idx), meta, extract_m=9, hot_j=hot_j,
                                   interpret=True)
    got = gather_decode_pairs([torch.tensor(x).to(getattr(torch, dtype)) for x in cells],
                              torch.from_numpy(idx).long(), meta, 9, hot_j)
    w_boxes, w_v, w_i, w_hot, w_hidx = (np.asarray(t) for t in want)
    boxes, v_m, i_m, hot_flat, hot_idx = got
    assert v_m.shape == (2, k, 9) and v_m.dtype == torch.float32 and i_m.dtype == torch.int64
    assert hot_flat.shape == (2, hot_j, num_classes) and hot_idx.shape == (2, 1, hot_j)
    np.testing.assert_array_equal(i_m.numpy(), w_i)
    np.testing.assert_array_equal(hot_idx.numpy(), w_hidx)
    np.testing.assert_allclose(v_m.numpy(), w_v, rtol=PAIR_RTOL, atol=0)
    np.testing.assert_allclose(hot_flat.numpy(), w_hot, rtol=PAIR_RTOL, atol=0)
    assert (hot_flat.numpy() == -1.0).sum(axis=-1).min() == 8  # top-(m-1) removed
    scale = np.maximum(np.abs(w_boxes[..., :2]), np.abs(w_boxes[..., 2:]))
    ulps = np.abs(boxes.numpy() - w_boxes) / (np.tile(scale, 2) * 2.0**-23)
    assert ulps.max() <= K3_BOX_ULP, ulps.max()


def test_top_m_past_the_row_width():
    """m > C: the steps past C give (-inf, 0), as _extract_top_m does.  (The
    hot boxes are not compared: with every m-th value -inf, the TPU
    kernel's transpose-by-matmul turns -inf * 0 into NaN and its rank
    degenerates; the tail never asks for them there, C > m + 1.)"""
    rng = np.random.default_rng(2)
    meta, cells = _scales(rng, 1, 64, 4)
    idx = rng.integers(0, 252, size=(1, 12)).astype(np.int32)
    want = jax_gather_decode_pairs(tuple(jnp.asarray(x) for x in cells), jnp.asarray(idx),
                                   meta, extract_m=9, hot_j=3, interpret=True)
    got = gather_decode_pairs([torch.from_numpy(x) for x in cells],
                              torch.from_numpy(idx).long(), meta, 9, 3)
    assert bool(torch.isneginf(got[1][..., 4:]).all()) and bool((got[2][..., 4:] == 0).all())
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=PAIR_RTOL, atol=0)


# ------------------------------------------------------------------ K4


@pytest.mark.parametrize("b,k,c,hot_j,topk", [(2, 40, 20, 5, 40), (3, 400, 80, 45, 400)])
def test_finalize_candidates_matches_pallas(b, k, c, hot_j, topk):
    rng = np.random.default_rng(k + c)
    m = 9
    i_m = rng.integers(0, c, size=(b, k, m)).astype(np.int32)
    hot_idx = rng.integers(0, k, size=(b, 1, hot_j)).astype(np.int32)
    width = k * (m - 1)
    q = rng.integers(0, width + hot_j * c, size=(b, topk)).astype(np.int32)
    q[:, 0], q[:, 1], q[:, 2], q[:, 3] = 0, width - 1, width, width + hot_j * c - 1
    boxes_k = rng.uniform(0, 400, size=(b, k, 4)).astype(np.float32)
    w_cls, w_boxes = jax_finalize_candidates(jnp.asarray(i_m), jnp.asarray(hot_idx),
                                             jnp.asarray(q), jnp.asarray(boxes_k),
                                             num_classes=c, interpret=True)
    cls, cand = finalize_candidates(torch.from_numpy(i_m).long(),
                                    torch.from_numpy(hot_idx).long(),
                                    torch.from_numpy(q).long(), torch.from_numpy(boxes_k), c)
    assert cls.dtype == cand.dtype == torch.float32
    assert bool((torch.from_numpy(q) < width).any()) and bool((torch.from_numpy(q) >= width).any())
    np.testing.assert_array_equal(cls.numpy(), np.asarray(w_cls))
    np.testing.assert_array_equal(cand.numpy(), np.asarray(w_boxes))


# ------------------------------------------------------------------ the tail


def _jax_hier_tail(cells, meta, dtype, **kw):
    jax.clear_caches()  # the fused tail reads VIDDET_PAIR_TOPK at trace time
    return multiclass_nms_late_decode_fused(tuple(jnp.asarray(x, dtype) for x in cells), None,
                                            meta, backend="pallas_interpret", **kw)


def _assert_dets(got, want):
    ids, scores, boxes = (np.asarray(t) for t in got)
    w_ids, w_scores, w_boxes = (np.asarray(t) for t in want)
    np.testing.assert_array_equal(ids, w_ids)
    np.testing.assert_allclose(scores, w_scores, rtol=0, atol=1e-6)
    np.testing.assert_allclose(boxes, w_boxes, rtol=0, atol=1e-4)


def _adversarial_hot_box(rng):
    """tests/unit/test_nms_gather_pallas.py:108: one anchor whose 20 tied
    classes all rank in the global top-40; the repair set must bring the
    12 beyond its top 8."""
    meta, cells = _scales(rng, 1, 64, 20)
    cells[0][0, 1, 0:25] = 0.0
    cells[0][0, 1, 4] = 8.0
    cells[0][0, 1, 5:25] = 6.0
    return meta, cells


@pytest.mark.parametrize("case", ["random", "ties", "adversarial", "coco"])
def test_hier_tail_matches_jax_interpret(monkeypatch, case):
    monkeypatch.delenv("VIDDET_PAIR_TOPK", raising=False)
    rng = np.random.default_rng(31)
    dtype, kw = "float32", dict(topk=40, post_nms=30)
    if case == "adversarial":
        meta, cells = _adversarial_hot_box(rng)
        dtype = "bfloat16"
    elif case == "coco":  # the main path's k, topk and class count at 128 px
        meta, cells = _scales(rng, 2, 128, 80)
        kw = dict(topk=400, post_nms=100)
    else:
        meta, cells = _scales(rng, 2, 64, 20, case)
    cells = [_dtype_exact(x, dtype) for x in cells]
    want = _jax_hier_tail(cells, meta, dtype, **kw)
    got = multiclass_nms_late_decode_cells(
        tuple(torch.tensor(x).to(getattr(torch, dtype)) for x in cells), meta, **kw)
    assert int((np.asarray(want[0]) >= 0).sum()) > 10  # a real workload
    _assert_dets(got, want)
    if case == "adversarial":
        assert (got[0][0] >= 0).sum() >= 20 and bool((got[1][0, :20] == got[1][0, 0]).all())


def test_hier_takes_the_hierarchical_path(monkeypatch):
    """The default ranking runs K3's top-m form and K4; det and a small
    class count run the full-width form."""
    calls = []
    real = torch_nms._PLAIN

    def spy(name):
        fn = getattr(real, name)

        def wrapped(*args, **kwargs):
            calls.append((name, len(args) + len(kwargs)))
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(torch_nms, "_PLAIN", real._replace(
        gather_decode_pairs=spy("gather_decode_pairs"),
        finalize_candidates=spy("finalize_candidates")))
    rng = np.random.default_rng(4)
    meta, cells = _scales(rng, 1, 64, 20)
    tcells = tuple(torch.from_numpy(x) for x in cells)
    monkeypatch.delenv("VIDDET_PAIR_TOPK", raising=False)
    multiclass_nms_late_decode_cells(tcells, meta, topk=40, post_nms=10, backend="plain")
    assert calls == [("gather_decode_pairs", 5), ("finalize_candidates", 5)]
    calls.clear()
    monkeypatch.setenv("VIDDET_PAIR_TOPK", "det")
    multiclass_nms_late_decode_cells(tcells, meta, topk=40, post_nms=10, backend="plain")
    assert calls == [("gather_decode_pairs", 3)]
    calls.clear()
    monkeypatch.delenv("VIDDET_PAIR_TOPK")
    meta4, cells4 = _scales(rng, 1, 64, 4)
    multiclass_nms_late_decode_cells(tuple(torch.from_numpy(x) for x in cells4), meta4,
                                     topk=40, post_nms=10, backend="plain")
    assert calls == [("gather_decode_pairs", 3)]


def test_nms_config_passes_the_ranking(monkeypatch):
    seen = []
    monkeypatch.setattr(torch_yolo3, "multiclass_nms_late_decode_cells",
                        lambda cells, meta, **kw: seen.append(kw["ranking"]))

    def model(images):
        return {"raws_cells": (), "meta": ()}

    for ranking in (None, "hier", "det"):
        torch_yolo3.forward_and_postprocess(model, None, torch_yolo3.NMSConfig(ranking=ranking))
    assert seen == [None, "hier", "det"]


def test_hier_equals_det_without_ties():
    """On tie-free float32 data both rankings select and order the same
    candidates, so the detections are equal bit for bit."""
    rng = np.random.default_rng(8)
    meta, cells = _scales(rng, 2, 128, 80)
    tcells = tuple(torch.from_numpy(x) for x in cells)
    hier = multiclass_nms_late_decode_cells(tcells, meta, ranking="hier")
    det = multiclass_nms_late_decode_cells(tcells, meta, ranking="det")
    assert int((hier[0] >= 0).sum()) > 50
    assert all(torch.equal(a, b) for a, b in zip(hier, det))


@pytest.mark.parametrize("value", ["exact", "DET", "hier"])
def test_unknown_ranking_raises(monkeypatch, value):
    monkeypatch.setenv("VIDDET_PAIR_TOPK", value)
    with pytest.raises(ValueError, match="VIDDET_PAIR_TOPK"):
        torch_nms.pair_ranking()
    monkeypatch.setenv("VIDDET_PAIR_TOPK", "approx")
    assert torch_nms.pair_ranking() == "hier"
    with pytest.raises(ValueError):
        torch_nms.pair_ranking("approx")
