"""K5 ``nms_keep_mask`` and K6 ``compact_and_pad``: the greedy NMS tail.

Replace ``viddet_tpu/ops/nms_pallas.py:212`` ``nms_keep_mask_pallas``
(``_greedy_rows_kernel``, ``:32``) and ``:156`` ``compact_and_pad_pallas``
(``_compact_kernel``, ``:84``).  The CUDA kernels are in ``csrc/nms.cu``:
K5 is a mask kernel over the whole card and a scan kernel per image, one
wrapper call launching both.
The plain versions are the JAX package's references
(``viddet_tpu/ops/nms.py:38`` ``nms_keep_mask`` and ``:70``
``_compact_and_pad``) written batched; ``ops/nms.py`` exports them under
those names.  Each kernel is a custom op (``viddet::nms_keep_mask``,
``viddet::compact_and_pad``; ``ops/__init__.py``) whose CUDA
implementation launches it, so that ``torch.export`` carries it.
"""

from __future__ import annotations

import torch

from viddet_tpu_torch.kernels import build, on_card, require
from viddet_tpu_torch.ops.boxes import box_iou

# The scan kernel keeps an image's suppression bitmask (ceil(K/64)^2 * 64
# words, 128 KB at K = 1024) in shared memory.
MAX_K = 1024


def mask_shape(b: int, k: int) -> tuple[int, int, int]:
    """Shape of K5's scratch suppression bitmask: (B, ceil(K/64), K) 64-bit
    words, word-major so that the mask kernel's stores are contiguous."""
    return (b, -(-k // 64), k)


def nms_keep_mask_plain(boxes: torch.Tensor, valid: torch.Tensor,
                        iou_thresh: float) -> torch.Tensor:
    """Batched greedy NMS keep mask over score-sorted candidates.

    boxes (B, K, 4) float32 (class-offset for class-aware NMS), valid
    (B, K) bool -> (B, K) float32, 1.0 = kept.  In rank order, a candidate
    is kept iff it is valid and no earlier KEPT candidate overlaps it by
    more than ``iou_thresh``.
    """
    k = boxes.shape[1]
    suppress = box_iou(boxes, boxes) > iou_thresh  # (B, K, K)
    later = torch.arange(k, device=boxes.device)
    keep = valid.bool().clone()
    for i in range(k):
        row = suppress[:, i] & (later > i)
        keep = torch.where(keep[:, i : i + 1], keep & ~row, keep)
    return keep.float()


def nms_keep_mask(boxes: torch.Tensor, valid: torch.Tensor, iou_thresh: float) -> torch.Tensor:
    """K5 wrapper: the kernel for CUDA tensors, the plain version on the CPU.
    It ranks boxes outside autograd (a train step detaches its proposals)."""
    if boxes.requires_grad:
        raise ValueError("nms_keep_mask: boxes must not require grad; detach them")
    if boxes.device.type == "cpu":
        return nms_keep_mask_plain(boxes, valid, iou_thresh)
    on_card(boxes, "nms_keep_mask")
    return torch.ops.viddet.nms_keep_mask(boxes, valid, float(iou_thresh))


@torch.library.custom_op("viddet::nms_keep_mask", mutates_args=(), device_types="cpu")
def _nms_keep_mask_op(boxes: torch.Tensor, valid: torch.Tensor,
                      iou_thresh: float) -> torch.Tensor:
    return nms_keep_mask_plain(boxes, valid, iou_thresh)


@_nms_keep_mask_op.register_kernel("cuda")
def _nms_keep_mask_cuda(boxes: torch.Tensor, valid: torch.Tensor,
                        iou_thresh: float) -> torch.Tensor:
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"nms_keep_mask: boxes must be (B, K, 4), got {tuple(boxes.shape)}")
    b, k, _ = boxes.shape
    if k > MAX_K:
        raise ValueError(f"nms_keep_mask: K={k} exceeds the kernel's {MAX_K}")
    require(boxes, "boxes", torch.float32)
    require(valid, "valid", torch.bool, shape=(b, k), device=boxes.device)
    keep = torch.empty((b, k), dtype=torch.float32, device=boxes.device)
    mask = torch.empty(mask_shape(b, k), dtype=torch.int64, device=boxes.device)
    err = build.library().viddet_nms_keep_mask(
        boxes.data_ptr(), valid.data_ptr(), b, k, float(iou_thresh),
        mask.data_ptr(), keep.data_ptr(), build.stream_of(keep),
    )
    build.check(err, "nms_keep_mask")
    nms_keep_mask.launches += 1
    return keep


@_nms_keep_mask_op.register_fake
def _(boxes: torch.Tensor, valid: torch.Tensor, iou_thresh: float) -> torch.Tensor:
    return boxes.new_empty(boxes.shape[:2], dtype=torch.float32)


nms_keep_mask.launches = 0


def compact_and_pad_plain(keep, scores, cls_idx, boxes, post_nms: int):
    """Kept candidates to the front (in rank order), -1 padded.

    keep / scores / cls_idx (B, K) float32, boxes (B, K, 4) float32 ->
    (ids (B, P), scores (B, P), boxes (B, P, 4)) with P = post_nms: the
    s-th kept candidate lands in slot s; kept ones past P are dropped.
    """
    b, k = keep.shape
    kept_in = keep > 0.5
    pos = torch.cumsum(kept_in, dim=1) - 1
    slot = torch.where(kept_in & (pos < post_nms), pos, post_nms)
    src = torch.arange(k, device=keep.device).expand(b, k)
    take = torch.full((b, post_nms + 1), k, dtype=torch.int64, device=keep.device)
    take = take.scatter(1, slot, src)[:, :post_nms]  # slot P collects the dropped
    kept = take < k
    take = take.clamp_max(k - 1)
    out_ids = torch.where(kept, cls_idx.gather(1, take), -1.0)
    out_scores = torch.where(kept, scores.gather(1, take), -1.0)
    out_boxes = torch.where(
        kept[..., None], boxes.gather(1, take[..., None].expand(b, post_nms, 4)), -1.0
    )
    return out_ids, out_scores, out_boxes


def compact_and_pad(keep, scores, cls_idx, boxes, post_nms: int):
    """K6 wrapper: the kernel for CUDA tensors, the plain version on the CPU."""
    if keep.device.type == "cpu":
        return compact_and_pad_plain(keep, scores, cls_idx, boxes, post_nms)
    on_card(keep, "compact_and_pad")
    return torch.ops.viddet.compact_and_pad(keep, scores, cls_idx, boxes, int(post_nms))


@torch.library.custom_op("viddet::compact_and_pad", mutates_args=(), device_types="cpu")
def _compact_and_pad_op(keep: torch.Tensor, scores: torch.Tensor, cls_idx: torch.Tensor,
                        boxes: torch.Tensor,
                        post_nms: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return tuple(t.contiguous() for t in compact_and_pad_plain(keep, scores, cls_idx, boxes,
                                                                post_nms))


@_compact_and_pad_op.register_kernel("cuda")
def _compact_and_pad_cuda(keep, scores, cls_idx, boxes, post_nms):
    if keep.dim() != 2:
        raise ValueError(f"compact_and_pad: keep must be (B, K), got {tuple(keep.shape)}")
    b, k = keep.shape
    if post_nms <= 0:
        raise ValueError(f"compact_and_pad: post_nms must be > 0, got {post_nms}")
    require(keep, "keep", torch.float32)
    for name, t, shape in (("scores", scores, (b, k)), ("cls_idx", cls_idx, (b, k)),
                           ("boxes", boxes, (b, k, 4))):
        require(t, name, torch.float32, shape=shape, device=keep.device)
    dev = keep.device
    ids = torch.empty((b, post_nms), dtype=torch.float32, device=dev)
    out_scores = torch.empty((b, post_nms), dtype=torch.float32, device=dev)
    out_boxes = torch.empty((b, post_nms, 4), dtype=torch.float32, device=dev)
    err = build.library().viddet_compact_and_pad(
        keep.data_ptr(), scores.data_ptr(), cls_idx.data_ptr(), boxes.data_ptr(),
        b, k, post_nms, ids.data_ptr(), out_scores.data_ptr(), out_boxes.data_ptr(),
        build.stream_of(ids),
    )
    build.check(err, "compact_and_pad")
    compact_and_pad.launches += 1
    return ids, out_scores, out_boxes


@_compact_and_pad_op.register_fake
def _(keep, scores, cls_idx, boxes, post_nms):
    b = keep.shape[0]
    return (keep.new_empty((b, post_nms)), keep.new_empty((b, post_nms)),
            keep.new_empty((b, post_nms, 4)))


compact_and_pad.launches = 0
