"""Class-aware NMS tail of the YOLO detector (counterpart of
``viddet_tpu/ops/nms.py``), under the deterministic ranking contract.

The JAX package's ``VIDDET_PAIR_TOPK=det`` configuration is the port's
only one: every ranking equals ``lax.top_k``'s, ties lowest index first.
A ranking is the K2 threshold-select kernel (the exact winner set, in
ascending index order) followed by a stable descending sort of the k
winners; ``torch.topk`` promises no tie order and is not used.

Everything is fixed-shape and batched; the result is ``(ids, scores,
boxes)`` padded with -1.  ``backend`` picks the kernels:

* ``"auto"``: each kernel's wrapper, which launches the kernel for a CUDA
  tensor and runs the plain version for a CPU tensor;
* ``"plain"``: the plain PyTorch versions on any device, the chain the
  kernels are held against.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from viddet_tpu_torch.ops import nms_cuda, nms_gather_cuda, topk_cuda
from viddet_tpu_torch.ops.nms_gather_cuda import decode_winners

# The JAX package's plain references, batched (see ops/nms_cuda.py).
nms_keep_mask = nms_cuda.nms_keep_mask_plain
_compact_and_pad = nms_cuda.compact_and_pad_plain

Detections = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


class _Ops(NamedTuple):
    anchor_scores: object
    topk_indices: object
    gather_decode_pairs: object
    nms_keep_mask: object
    compact_and_pad: object


_WRAPPERS = _Ops(nms_gather_cuda.anchor_scores, topk_cuda.topk_indices,
                 nms_gather_cuda.gather_decode_pairs, nms_cuda.nms_keep_mask,
                 nms_cuda.compact_and_pad)
_PLAIN = _Ops(nms_gather_cuda.anchor_scores_plain, topk_cuda.topk_indices_plain,
              nms_gather_cuda.gather_decode_pairs_plain, nms_cuda.nms_keep_mask_plain,
              nms_cuda.compact_and_pad_plain)


def _ops(backend: str) -> _Ops:
    if backend == "plain":
        return _PLAIN
    if backend != "auto":
        raise ValueError(f"backend {backend!r} is not 'auto' or 'plain'")
    return _WRAPPERS


def _class_offset(cand_boxes: torch.Tensor, cls_idx: torch.Tensor) -> torch.Tensor:
    """Shift each class into a disjoint coordinate region (per image) so
    cross-class IoU is exactly 0: class-aware NMS in one agnostic pass."""
    span = cand_boxes.abs().amax(dim=(1, 2)).clamp_min(1.0) + 1.0  # (B,)
    return cand_boxes + (cls_idx * 2.0 * span[:, None])[..., None]


def _pair_top_k_det(scores: torch.Tensor, k: int,
                    topk_fn=topk_cuda.topk_indices) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k(scores, k)`` exactly (``viddet_tpu/ops/nms.py:174``): the
    threshold-select winner set (K2), re-ranked by a stable descending sort;
    equal scores keep their ascending-index order, lax.top_k's tie order."""
    idx = topk_fn(scores, k)
    vals = scores.gather(1, idx)
    v_sorted, pos = torch.sort(vals, dim=1, descending=True, stable=True)
    return v_sorted, idx.gather(1, pos)


def _nms_on_candidates(cand_boxes, top_scores, cls_idx, valid, iou_thresh, post_nms,
                       ops: _Ops) -> Detections:
    """Shared tail: class offset -> greedy keep (K5) -> compaction (K6)."""
    offset_boxes = _class_offset(cand_boxes, cls_idx)
    keep = ops.nms_keep_mask(offset_boxes, valid, iou_thresh)
    return ops.compact_and_pad(keep, top_scores, cls_idx, cand_boxes, post_nms)


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
    cand_boxes = boxes_k.gather(1, anchor2[..., None].expand(b, topk, 4))
    valid = top_scores > valid_thresh
    return _nms_on_candidates(cand_boxes, top_scores, cls_idx, valid, iou_thresh,
                              post_nms, ops)


def multiclass_nms_late_decode(
    raw_xy, raw_wh, obj_logits, cls_logits, cls_max_logits, grid_xy, anchor_wh, stride_n,
    *, iou_thresh: float = 0.45, valid_thresh: float = 0.01, topk: int = 400,
    post_nms: int = 100, backend: str = "auto",
) -> Detections:
    """Top-k the anchors first, decode the winners second
    (``viddet_tpu/ops/nms.py:280``).

    raw_xy / raw_wh (B, N, 2), obj_logits (B, N, 1), cls_logits (B, N, C),
    cls_max_logits (B, N) in any float dtype; grid_xy / anchor_wh /
    stride_n (N, 2) / (N, 2) / (N, 1) decode constants.
    """
    ops = _ops(backend)
    b, n, c = cls_logits.shape
    k = min(topk, n)
    obj = torch.sigmoid(obj_logits[..., 0].float())
    anchor_score = obj * torch.sigmoid(cls_max_logits.float())
    _, a_idx = _pair_top_k_det(anchor_score, k, ops.topk_indices)
    raw_k = torch.cat(
        [raw_xy.gather(1, a_idx[..., None].expand(b, k, 2)).float(),
         raw_wh.gather(1, a_idx[..., None].expand(b, k, 2)).float(),
         obj_logits.gather(1, a_idx[..., None]).float(),
         cls_logits.gather(1, a_idx[..., None].expand(b, k, c)).float()],
        dim=-1,
    )
    boxes_k, pair_scores = decode_winners(raw_k, a_idx, grid_xy, anchor_wh, stride_n)
    return _stage2_and_nms(boxes_k, pair_scores, iou_thresh, valid_thresh, topk,
                           post_nms, ops)


def multiclass_nms_late_decode_cells(
    raws_cells: Sequence[torch.Tensor], meta, *, iou_thresh: float = 0.45,
    valid_thresh: float = 0.01, topk: int = 400, post_nms: int = 100,
    backend: str = "auto",
) -> Detections:
    """The main-path tail on the per-scale cell-layout head tensors
    (``viddet_tpu/ops/nms.py:371`` under ``VIDDET_PAIR_TOPK=det``).

    1. stage-1 anchor scores (K1);
    2. stage-1 winners (K2), re-ranked stably into lax.top_k order;
    3. gather, late decode and pair scores of the winners (K3 in its
       ``extract_m=0`` form);
    4. stage-2 ranking (K2 again) and NMS (K5, K6).

    raws_cells: (B, h*w, na*(5+C)) per scale, deepest first.
    meta: per scale ``(cells, width, stride, anchors)``.
    """
    ops = _ops(backend)
    na = len(meta[0][3])
    anchor_score = ops.anchor_scores(raws_cells, na)
    k = min(topk, anchor_score.shape[1])
    _, a_idx = _pair_top_k_det(anchor_score, k, ops.topk_indices)
    boxes_k, pair_scores = ops.gather_decode_pairs(raws_cells, a_idx, meta)
    return _stage2_and_nms(boxes_k, pair_scores, iou_thresh, valid_thresh, topk,
                           post_nms, ops)
