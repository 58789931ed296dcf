"""Pascal VOC detection mAP, 11-point (VOC07) and area under the PR curve
(copy of ``viddet_tpu/eval/voc_map.py``, numpy only, so both packages score
the same detections to the same float).

Matching protocol (standard VOC):
* detections sorted by score per class;
* a detection matches the unmatched GT with highest IoU >= iou_thresh;
* matches to `difficult` GT are neither TP nor FP (ignored);
* duplicate matches to an already-matched GT are FP."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def _ap_voc07(recall: np.ndarray, precision: np.ndarray) -> float:
    """11-point interpolated AP."""
    ap = 0.0
    for t in np.arange(0.0, 1.1, 0.1):
        mask = recall >= t
        p = float(np.max(precision[mask])) if mask.any() else 0.0
        ap += p / 11.0
    return ap


def _ap_area(recall: np.ndarray, precision: np.ndarray) -> float:
    """Area under the monotone-envelope PR curve (VOC >= 2010)."""
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


class VOCMApMetric:
    """Accumulates detections and computes per-class AP + mAP.

    Args:
      iou_thresh: match threshold (0.5 for VOC).
      class_names: display names; len == num classes.
      use_07_metric: 11-point interpolation (VOC07) vs area (default False).
    """

    def __init__(
        self,
        iou_thresh: float = 0.5,
        class_names: Optional[Sequence[str]] = None,
        use_07_metric: bool = False,
    ):
        self.iou_thresh = iou_thresh
        self.class_names = list(class_names) if class_names else None
        self.use_07_metric = use_07_metric
        self.reset()

    def reset(self):
        # per class: list of (score, tp, fp); and positive GT count
        self._records: Dict[int, List] = {}
        self._npos: Dict[int, int] = {}

    def update(
        self,
        pred_bboxes,
        pred_ids,
        pred_scores,
        gt_bboxes,
        gt_ids,
        gt_difficults=None,
    ):
        """All args are (B, ...) arrays; padding marked with -1 ids/scores."""
        pred_bboxes = np.asarray(pred_bboxes)
        pred_ids = np.asarray(pred_ids)
        pred_scores = np.asarray(pred_scores)
        gt_bboxes = np.asarray(gt_bboxes)
        gt_ids = np.asarray(gt_ids)
        if gt_difficults is None:
            gt_difficults = np.zeros(gt_ids.shape, np.float32)
        gt_difficults = np.asarray(gt_difficults)

        for b in range(pred_bboxes.shape[0]):
            self._update_single(
                pred_bboxes[b],
                pred_ids[b].reshape(-1),
                pred_scores[b].reshape(-1),
                gt_bboxes[b],
                gt_ids[b].reshape(-1),
                gt_difficults[b].reshape(-1),
            )

    def _update_single(self, pb, pi, ps, gb, gi, gd):
        pvalid = (pi >= 0) & (ps >= 0)
        pb, pi, ps = pb[pvalid], pi[pvalid].astype(int), ps[pvalid]
        gvalid = gi >= 0
        gb, gi, gd = gb[gvalid], gi[gvalid].astype(int), gd[gvalid].astype(bool)

        for c in np.unique(gi):
            self._npos[c] = self._npos.get(c, 0) + int((~gd[gi == c]).sum())

        for c in np.unique(pi):
            sel = pi == c
            boxes_c = pb[sel]
            scores_c = ps[sel]
            order = np.argsort(-scores_c)
            boxes_c, scores_c = boxes_c[order], scores_c[order]
            gsel = gi == c
            gt_c = gb[gsel]
            diff_c = gd[gsel]
            matched = np.zeros(len(gt_c), bool)
            rec = self._records.setdefault(c, [])
            for box, score in zip(boxes_c, scores_c):
                if len(gt_c) == 0:
                    rec.append((score, 0, 1))
                    continue
                ix1 = np.maximum(gt_c[:, 0], box[0])
                iy1 = np.maximum(gt_c[:, 1], box[1])
                ix2 = np.minimum(gt_c[:, 2], box[2])
                iy2 = np.minimum(gt_c[:, 3], box[3])
                inter = np.maximum(ix2 - ix1, 0) * np.maximum(iy2 - iy1, 0)
                area_p = max((box[2] - box[0]) * (box[3] - box[1]), 0)
                area_g = np.maximum(
                    (gt_c[:, 2] - gt_c[:, 0]) * (gt_c[:, 3] - gt_c[:, 1]), 0
                )
                iou = inter / np.maximum(area_p + area_g - inter, 1e-12)
                best = int(np.argmax(iou))
                if iou[best] >= self.iou_thresh:
                    if diff_c[best]:
                        continue  # ignore: neither TP nor FP
                    if not matched[best]:
                        matched[best] = True
                        rec.append((score, 1, 0))
                    else:
                        rec.append((score, 0, 1))
                else:
                    rec.append((score, 0, 1))

    def state_dict(self):
        """Picklable accumulator state, for cross-process merging.

        Sharded evaluation gathers every shard's state and merges it with
        :meth:`merge_state`; ``get()`` sorts per-class
        records by score, so merge order cannot affect the result.
        """
        return {
            "records": {int(c): list(r) for c, r in self._records.items()},
            "npos": {int(c): int(n) for c, n in self._npos.items()},
        }

    def merge_state(self, state) -> None:
        """Merge another accumulator's ``state_dict()`` into this one."""
        for c, rec in state["records"].items():
            self._records.setdefault(int(c), []).extend(
                (float(s), int(tp), int(fp)) for s, tp, fp in rec
            )
        for c, n in state["npos"].items():
            self._npos[int(c)] = self._npos.get(int(c), 0) + int(n)

    def get(self):
        """Returns (names, values): per-class AP then overall mAP."""
        classes = sorted(set(self._records) | set(self._npos))
        aps = {}
        for c in classes:
            npos = self._npos.get(c, 0)
            rec = self._records.get(c, [])
            if npos == 0:
                aps[c] = float("nan")
                continue
            if not rec:
                aps[c] = 0.0
                continue
            rec = sorted(rec, key=lambda r: -r[0])
            tp = np.cumsum([r[1] for r in rec])
            fp = np.cumsum([r[2] for r in rec])
            recall = tp / npos
            precision = tp / np.maximum(tp + fp, 1e-12)
            aps[c] = (
                _ap_voc07(recall, precision)
                if self.use_07_metric
                else _ap_area(recall, precision)
            )
        names = []
        values = []
        for c in classes:
            name = (
                self.class_names[c]
                if self.class_names and c < len(self.class_names)
                else str(c)
            )
            names.append(name)
            values.append(aps[c])
        valid = [v for v in values if not np.isnan(v)]
        names.append("mAP")
        values.append(float(np.mean(valid)) if valid else 0.0)
        return names, values


class VOC07MApMetric(VOCMApMetric):
    def __init__(self, iou_thresh: float = 0.5, class_names=None):
        super().__init__(iou_thresh, class_names, use_07_metric=True)
