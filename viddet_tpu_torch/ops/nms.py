"""Class-aware NMS tail of the YOLO detector (counterpart of
``viddet_tpu/ops/nms.py``), under either of the JAX package's stage-2
rankings.

``VIDDET_PAIR_TOPK`` picks the ranking, with the JAX package's values and
default, read on every call (the port has no trace cache):

* unset or ``"approx"``: the **hierarchical** tail (``nms.py:452-546``),
  the JAX package's default.  K3 in its ``extract_m=9`` form emits each
  stage-1 winner's top-9 pairs and the pigeonhole repair set, stage 2
  ranks their merged array (k*8 + J*C = 6,800 entries at the main path's
  k = 400, C = 80, J = 45, instead of k*C = 32,000) and K4 maps the
  winners back to classes and boxes.  On the TPU, JAX ranks that array
  with ``lax.approx_max_k`` (``nms.py:169-170``), which lowers to the
  TPU's PartialReduce unit and has no Pallas kernel; the port ranks it
  exactly.  So the port's hierarchical tail equals JAX's
  ``backend="pallas_interpret"`` hierarchical tail (``lax.top_k``) bit for
  bit, up to the ulp of sigmoid and exp, not the TPU's order within ties;
  it equals the XLA chain up to ties at the topk-th score.
* ``"det"``: the deterministic tail (``nms.py:438-448``, ``:466``): K3 in
  its ``extract_m=0`` form and a ranking of the full k*C pair width, bit
  for bit the XLA chain's, ties included.

Any other value raises.  Small class counts (C <= 10, such as the golden
recipe's 4) keep the full-width tail under either ranking, as in JAX.

Every ranking here equals ``lax.top_k``'s, ties lowest index first: the
K2 threshold-select kernel (the exact winner set, in ascending index
order) followed by a stable descending sort of the k winners;
``torch.topk`` promises no tie order and is not used.

The dense entry points (``multiclass_nms``, ``multiclass_nms_dense_two_stage``
for SSD, ``multiclass_nms_from_logits``) rank the same way: K2 and a
stable sort for every ``lax.top_k``, then K5 and K6.  Where JAX ranks a
stage 2 with ``lax.approx_max_k`` on the TPU, the port ranks exactly, so
it may order exact ties at the topk-th score differently from the TPU.

Everything is fixed-shape and batched; the result is ``(ids, scores,
boxes)`` padded with -1.  ``backend`` picks the kernels:

* ``"auto"``: each kernel's wrapper, which launches the kernel for a CUDA
  tensor and runs the plain version for a CPU tensor;
* ``"plain"``: the plain PyTorch versions on any device, the chain the
  kernels are held against.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from viddet_tpu_torch.ops import nms_cuda, nms_gather_cuda, topk_cuda
from viddet_tpu_torch.ops.nms_gather_cuda import decode_winners

# The JAX package's plain references, batched (see ops/nms_cuda.py).
nms_keep_mask = nms_cuda.nms_keep_mask_plain
_compact_and_pad = nms_cuda.compact_and_pad_plain

Detections = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

TOP_M = 9  # per-winner pairs of the hierarchical ranking (nms.py:452)


class _Ops(NamedTuple):
    anchor_scores: object
    topk_indices: object
    gather_decode_pairs: object
    finalize_candidates: object
    nms_keep_mask: object
    compact_and_pad: object


_WRAPPERS = _Ops(nms_gather_cuda.anchor_scores, topk_cuda.topk_indices,
                 nms_gather_cuda.gather_decode_pairs, nms_gather_cuda.finalize_candidates,
                 nms_cuda.nms_keep_mask, nms_cuda.compact_and_pad)
_PLAIN = _Ops(nms_gather_cuda.anchor_scores_plain, topk_cuda.topk_indices_plain,
              nms_gather_cuda.gather_decode_pairs_plain,
              nms_gather_cuda.finalize_candidates_plain, nms_cuda.nms_keep_mask_plain,
              nms_cuda.compact_and_pad_plain)


def _ops(backend: str) -> _Ops:
    if backend == "plain":
        return _PLAIN
    if backend != "auto":
        raise ValueError(f"backend {backend!r} is not 'auto' or 'plain'")
    return _WRAPPERS


def pair_ranking(ranking: Optional[str] = None) -> str:
    """``"hier"`` or ``"det"``: ``ranking`` when given, else from
    ``VIDDET_PAIR_TOPK`` (unset, empty or ``"approx"``: hier; ``"det"``:
    det)."""
    if ranking is None:
        env = os.environ.get("VIDDET_PAIR_TOPK") or "approx"
        if env not in ("approx", "det"):
            raise ValueError(f"VIDDET_PAIR_TOPK={env!r} is not 'approx' or 'det'")
        return "det" if env == "det" else "hier"
    if ranking not in ("hier", "det"):
        raise ValueError(f"ranking {ranking!r} is not 'hier' or 'det'")
    return ranking


def _class_offset(cand_boxes: torch.Tensor, cls_idx: torch.Tensor) -> torch.Tensor:
    """Shift each class into a disjoint coordinate region (per image) so
    cross-class IoU is exactly 0: class-aware NMS in one agnostic pass."""
    span = cand_boxes.abs().amax(dim=(1, 2)).clamp_min(1.0) + 1.0  # (B,)
    return cand_boxes + (cls_idx * 2.0 * span[:, None])[..., None]


def _top_k_set(scores: torch.Tensor, k: int, topk_fn) -> torch.Tensor:
    """``topk_fn``'s winner set (ascending indices, ties lowest index
    first) at any row width.  A row wider than K2's ``topk_cuda.MAX_N`` is
    ranked in slices of at most MAX_N columns, then once more over the
    slices' winners, concatenated in ascending index order.  Exact: a
    winner of the row is a winner of its slice, and the concatenation keeps
    every index's order, so ties still go lowest index first.  Each slice
    must hold min(k, its width) non-negative scores (dense probabilities
    always do)."""
    n, width = scores.shape[1], topk_cuda.MAX_N
    if n <= width or k >= width:
        return topk_fn(scores, k)
    idx = torch.cat([topk_fn(scores[:, s:s + width].contiguous(), min(k, n - s)) + s
                     for s in range(0, n, width)], dim=1)
    return idx.gather(1, _top_k_set(scores.gather(1, idx), k, topk_fn))


def _pair_top_k_det(scores: torch.Tensor, k: int,
                    topk_fn=topk_cuda.topk_indices) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k(scores, k)`` exactly (``viddet_tpu/ops/nms.py:174``): the
    threshold-select winner set (K2, at any width), re-ranked by a stable
    descending sort; equal scores keep their ascending-index order,
    lax.top_k's tie order."""
    idx = _top_k_set(scores, k, topk_fn)
    vals = scores.gather(1, idx)
    v_sorted, pos = torch.sort(vals, dim=1, descending=True, stable=True)
    return v_sorted, idx.gather(1, pos)


def _nms_on_candidates(cand_boxes, top_scores, cls_idx, valid, iou_thresh, post_nms,
                       ops: _Ops) -> Detections:
    """Shared tail: class offset -> greedy keep (K5) -> compaction (K6)."""
    offset_boxes = _class_offset(cand_boxes, cls_idx)
    keep = ops.nms_keep_mask(offset_boxes, valid, iou_thresh)
    return ops.compact_and_pad(keep, top_scores, cls_idx, cand_boxes, post_nms)


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, D) at idx (B, k) -> (B, k, D)."""
    return x.gather(1, idx[..., None].expand(*idx.shape, x.shape[-1]))


def _stage2_and_nms(boxes_k, pair_scores, iou_thresh, valid_thresh, topk, post_nms,
                    ops: _Ops) -> Detections:
    """Stage-2 (anchor, class) ranking -> candidate gather -> NMS."""
    b, k, c = pair_scores.shape
    top_scores, p_idx = _pair_top_k_det(pair_scores.reshape(b, k * c), min(topk, k * c),
                                        ops.topk_indices)
    if top_scores.shape[1] < topk:  # k*c < topk: pad (tiny class counts)
        pad = topk - top_scores.shape[1]
        top_scores = torch.nn.functional.pad(top_scores, (0, pad), value=-1.0)
        p_idx = torch.nn.functional.pad(p_idx, (0, pad))
    anchor2 = p_idx // c  # (B, topk) index into boxes_k
    cls_idx = (p_idx % c).float()
    cand_boxes = _gather_rows(boxes_k, anchor2)
    valid = top_scores > valid_thresh
    return _nms_on_candidates(cand_boxes, top_scores, cls_idx, valid, iou_thresh,
                              post_nms, ops)


def multiclass_nms(boxes: torch.Tensor, scores: torch.Tensor, *, iou_thresh: float = 0.45,
                   valid_thresh: float = 0.01, topk: int = 400, post_nms: int = 100,
                   backend: str = "auto") -> Detections:
    """Class-aware NMS over dense per-class scores (``viddet_tpu/ops/nms.py:101``):
    one candidate per (anchor, class), the exact top-k of all N*C (K2 and a
    stable sort), then NMS (K5, K6).

    boxes (B, N, 4) corner boxes shared across classes; scores (B, N, C),
    >= 0 as K2 requires (objectness times class probability).  N*C past
    K2's ``topk_cuda.MAX_N`` is ranked in slices (``_top_k_set``).
    """
    ops = _ops(backend)
    b, n, c = scores.shape
    k = min(topk, n * c)
    top_scores, top_idx = _pair_top_k_det(scores.reshape(b, n * c), k, ops.topk_indices)
    cand_boxes = _gather_rows(boxes, top_idx // c)
    valid = top_scores > valid_thresh
    return _nms_on_candidates(cand_boxes, top_scores, (top_idx % c).float(), valid,
                              iou_thresh, post_nms, ops)


def multiclass_nms_dense_two_stage(boxes: torch.Tensor, scores: torch.Tensor, *,
                                   iou_thresh: float = 0.45, valid_thresh: float = 0.01,
                                   topk: int = 400, post_nms: int = 100,
                                   backend: str = "auto") -> Detections:
    """Two-stage top-k and NMS over dense (B, N, C) probabilities, SSD's tail
    (``viddet_tpu/ops/nms.py:239``): stage 1 ranks the anchors by their
    largest class probability (K2 and a stable sort, exactly ``lax.top_k``,
    so the k winners' order is the XLA chain's), stage 2 ranks their k*C
    pairs (K2 again), padded to ``topk`` where k*C is smaller; then NMS
    (K5, K6).  An anchor outside the stage-1 top-k owns no top-k pair."""
    ops = _ops(backend)
    k = min(topk, scores.shape[1])
    _, a_idx = _pair_top_k_det(scores.amax(dim=-1).float(), k, ops.topk_indices)
    return _stage2_and_nms(_gather_rows(boxes, a_idx), _gather_rows(scores, a_idx).float(),
                           iou_thresh, valid_thresh, topk, post_nms, ops)


def multiclass_nms_from_logits(boxes: torch.Tensor, obj_logits: torch.Tensor,
                               cls_logits: torch.Tensor,
                               cls_max_logits: Optional[torch.Tensor] = None, *,
                               iou_thresh: float = 0.45, valid_thresh: float = 0.01,
                               topk: int = 400, post_nms: int = 100,
                               backend: str = "auto") -> Detections:
    """Two-stage exact top-k and NMS straight from decoded boxes and head
    logits (``viddet_tpu/ops/nms.py:553``): stage 1 ranks the anchors by
    sigmoid(obj) * sigmoid(max class logit), stage 2 the k winners' k*C
    pair scores sigmoid(obj) * sigmoid(cls); K2 and a stable sort for both,
    then NMS (K5, K6).

    boxes (B, N, 4) float32; obj_logits (B, N, 1), cls_logits (B, N, C)
    and cls_max_logits (B, N) in any float dtype.
    """
    ops = _ops(backend)
    k = min(topk, cls_logits.shape[1])
    obj = torch.sigmoid(obj_logits[..., 0].float())
    if cls_max_logits is None:
        cls_max_logits = cls_logits.amax(dim=-1)
    anchor_score = obj * torch.sigmoid(cls_max_logits.float())
    _, a_idx = _pair_top_k_det(anchor_score, k, ops.topk_indices)
    pair_scores = obj.gather(1, a_idx)[..., None] * torch.sigmoid(
        _gather_rows(cls_logits, a_idx).float())
    return _stage2_and_nms(_gather_rows(boxes, a_idx), pair_scores, iou_thresh, valid_thresh,
                           topk, post_nms, ops)


def _stage2_hier_and_nms(boxes_k, v_m, i_m, hot_flat, hot_idx, iou_thresh, valid_thresh,
                         topk, post_nms, ops: _Ops) -> Detections:
    """Hierarchical exact stage 2 (``viddet_tpu/ops/nms.py:491``): rank the
    merged [per-winner top-(m-1) pairs | hot rows] array (K2 and a stable
    sort; its -1.0 dedup sentinels meet K2's precondition), map the winners
    back (K4), then NMS.  Exact by pigeonhole: a pair above the topk-th
    score that is not among its box's top m-1 makes that box one of the
    J = (topk-1)//m + 1 boxes with the highest m-th pair, whose full rows
    the hot rows hold."""
    b, k, m = v_m.shape
    c = hot_flat.shape[-1]
    width = k * (m - 1)
    merged = torch.cat([v_m[..., : m - 1].reshape(b, width), hot_flat.reshape(b, -1)], dim=1)
    top_scores, q = _pair_top_k_det(merged, topk, ops.topk_indices)
    cls_idx, cand_boxes = ops.finalize_candidates(i_m, hot_idx, q, boxes_k, c)
    valid = top_scores > valid_thresh
    return _nms_on_candidates(cand_boxes, top_scores, cls_idx, valid, iou_thresh,
                              post_nms, ops)


def multiclass_nms_late_decode(
    raw_xy, raw_wh, obj_logits, cls_logits, cls_max_logits, grid_xy, anchor_wh, stride_n,
    *, iou_thresh: float = 0.45, valid_thresh: float = 0.01, topk: int = 400,
    post_nms: int = 100, backend: str = "auto",
) -> Detections:
    """Top-k the anchors first, decode the winners second
    (``viddet_tpu/ops/nms.py:280``), ranking the full pair width.

    raw_xy / raw_wh (B, N, 2), obj_logits (B, N, 1), cls_logits (B, N, C),
    cls_max_logits (B, N) in any float dtype; grid_xy / anchor_wh /
    stride_n (N, 2) / (N, 2) / (N, 1) decode constants.
    """
    ops = _ops(backend)
    k = min(topk, cls_logits.shape[1])
    obj = torch.sigmoid(obj_logits[..., 0].float())
    anchor_score = obj * torch.sigmoid(cls_max_logits.float())
    _, a_idx = _pair_top_k_det(anchor_score, k, ops.topk_indices)
    raw_k = torch.cat([_gather_rows(x, a_idx).float()
                       for x in (raw_xy, raw_wh, obj_logits, cls_logits)], dim=-1)
    boxes_k, pair_scores = decode_winners(raw_k, a_idx, grid_xy, anchor_wh, stride_n)
    return _stage2_and_nms(boxes_k, pair_scores, iou_thresh, valid_thresh, topk,
                           post_nms, ops)


def multiclass_nms_late_decode_cells(
    raws_cells: Sequence[torch.Tensor], meta, *, iou_thresh: float = 0.45,
    valid_thresh: float = 0.01, topk: int = 400, post_nms: int = 100,
    backend: str = "auto", ranking: Optional[str] = None,
) -> Detections:
    """The main-path tail on the per-scale cell-layout head tensors
    (``viddet_tpu/ops/nms.py:371`` ``multiclass_nms_late_decode_fused``).

    1. stage-1 anchor scores (K1);
    2. stage-1 winners (K2), in ascending index order; re-ranked stably
       into lax.top_k order only under det (``nms.py:438-448``), since the
       order of ``boxes_k`` sets the hierarchical merged layout and the
       tie order of its hot boxes;
    3. gather, late decode and pair scores of the winners (K3): hier, its
       ``extract_m=9`` form; det, its ``extract_m=0`` form;
    4. stage-2 ranking (K2 again), under hier over the merged array with
       K4 mapping the winners back; then NMS (K5, K6).

    raws_cells: (B, h*w, na*(5+C)) per scale, deepest first.
    meta: per scale ``(cells, width, stride, anchors)``.
    ranking: ``"hier"``, ``"det"`` or None to read ``VIDDET_PAIR_TOPK``.
    """
    ops = _ops(backend)
    det = pair_ranking(ranking) == "det"
    na = len(meta[0][3])
    anchor_score = ops.anchor_scores(raws_cells, na)
    k = min(topk, anchor_score.shape[1])
    if det:
        _, a_idx = _pair_top_k_det(anchor_score, k, ops.topk_indices)
    else:
        a_idx = ops.topk_indices(anchor_score, k)
    c = raws_cells[0].shape[-1] // na - 5
    m = TOP_M
    j = min((topk - 1) // m + 1, k)
    if c > m + 1 and k * (m - 1) >= topk and not det:  # nms.py:466
        outs = ops.gather_decode_pairs(raws_cells, a_idx, meta, m, j)
        return _stage2_hier_and_nms(*outs, iou_thresh, valid_thresh, topk, post_nms, ops)
    boxes_k, pair_scores = ops.gather_decode_pairs(raws_cells, a_idx, meta)
    return _stage2_and_nms(boxes_k, pair_scores, iou_thresh, valid_thresh, topk,
                           post_nms, ops)
