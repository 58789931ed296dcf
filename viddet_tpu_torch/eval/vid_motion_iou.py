"""ImageNet-VID evaluation with the motion-IoU protocol (copy of
``viddet_tpu/eval/vid_motion_iou.py``, numpy only): VID-protocol mAP (VOC-style AP at IoU 0.5) reported overall AND per
object-motion category, following the FGFA evaluation protocol:

* each ground-truth object's **motion IoU** is the mean IoU between its box
  and the same track's boxes in frames within ±``motion_window`` frames;
* objects are classed *slow* (motion IoU > 0.9), *medium* (0.7-0.9),
  *fast* (< 0.7);
* the per-category mAP treats out-of-category GT as ignore regions
  (matches to them are neither TP nor FP and they don't count as positives)
  — the same semantics as VOC difficult boxes, which is how it's
  implemented here.

Track identity comes from the VID XML ``trackid`` (label column 6).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from viddet_tpu_torch.eval.voc_map import VOCMApMetric

MOTION_BINS = {"slow": (0.9, 1.01), "medium": (0.7, 0.9), "fast": (-0.01, 0.7)}


def _iou_single(a: np.ndarray, b: np.ndarray) -> float:
    x1 = max(a[0], b[0]); y1 = max(a[1], b[1])
    x2 = min(a[2], b[2]); y2 = min(a[3], b[3])
    inter = max(x2 - x1, 0) * max(y2 - y1, 0)
    ua = max(a[2] - a[0], 0) * max(a[3] - a[1], 0)
    ub = max(b[2] - b[0], 0) * max(b[3] - b[1], 0)
    union = ua + ub - inter
    return inter / union if union > 0 else 0.0


def compute_motion_ious(
    snippet_labels: Sequence[np.ndarray], motion_window: int = 10
) -> List[np.ndarray]:
    """Per-frame, per-object motion IoU for one snippet.

    snippet_labels: list over frames of (M, 7) labels [x1 y1 x2 y2 cls diff
    trackid].  Returns a list of (M,) float arrays aligned with the input.
    """
    num_frames = len(snippet_labels)
    # track -> {frame: box}
    tracks: Dict[float, Dict[int, np.ndarray]] = {}
    for t, label in enumerate(snippet_labels):
        for row in label:
            tracks.setdefault(float(row[6]), {})[t] = row[:4]

    out = []
    for t, label in enumerate(snippet_labels):
        vals = np.ones(len(label), np.float32)
        for i, row in enumerate(label):
            track = tracks[float(row[6])]
            ious = [
                _iou_single(row[:4], track[u])
                for u in range(max(0, t - motion_window), min(num_frames, t + motion_window + 1))
                if u != t and u in track
            ]
            vals[i] = float(np.mean(ious)) if ious else 1.0
        out.append(vals)
    return out


class VIDDetectionMetric:
    """Accumulates detections per frame, reports mAP overall + slow/med/fast.

    Requires an ``ImageNetVidDetection``-style dataset (snippet structure,
    7-column labels with trackid).
    """

    def __init__(self, dataset, class_names: Optional[Sequence[str]] = None,
                 iou_thresh: float = 0.5, motion_window: int = 10):
        self._dataset = dataset
        self._class_names = list(class_names or dataset.classes)
        self._iou_thresh = iou_thresh
        self._motion_window = motion_window
        self._motion_cache: Dict[int, List[np.ndarray]] = {}
        self.reset()

    def reset(self):
        self._records: List[Tuple[int, np.ndarray, np.ndarray, np.ndarray]] = []

    def _frame_motion_ious(self, dataset_idx: int) -> np.ndarray:
        snippet_idx, pos = self._dataset.snippet_and_position(int(dataset_idx))
        if snippet_idx not in self._motion_cache:
            self._motion_cache[snippet_idx] = compute_motion_ious(
                self._dataset.snippet_labels(snippet_idx), self._motion_window
            )
        return self._motion_cache[snippet_idx][pos]

    def update_with_indices(self, pred_bboxes, pred_ids, pred_scores, indices):
        for b, idx in enumerate(indices):
            self._records.append(
                (
                    int(idx),
                    np.asarray(pred_bboxes[b]),
                    np.asarray(pred_ids[b]).reshape(-1),
                    np.asarray(pred_scores[b]).reshape(-1),
                )
            )

    # reference-style positional update is also supported for plain use
    def update(self, pred_bboxes, pred_ids, pred_scores, indices):
        self.update_with_indices(pred_bboxes, pred_ids, pred_scores, indices)

    def state_dict(self):
        """Picklable per-frame detection records (multi-host eval merge).

        Records are keyed by dataset index and replayed against local GT in
        ``get()``; the underlying VOC accumulators sort by score, so merge
        order does not change the result.  Sorted on export so the merged
        record list is identical across processes.
        """
        return {"records": sorted(self._records, key=lambda r: r[0])}

    def merge_state(self, state) -> None:
        self._records.extend(
            (int(i), np.asarray(pb), np.asarray(pi), np.asarray(ps))
            for i, pb, pi, ps in state["records"]
        )

    def get(self):
        metrics = {
            mode: VOCMApMetric(self._iou_thresh, self._class_names)
            for mode in ("all", *MOTION_BINS)
        }
        for idx, pb, pi, ps in self._records:
            label = self._dataset.label(idx)
            gt_boxes = label[:, :4][None]
            gt_ids = label[:, 4][None]
            motion = self._frame_motion_ious(idx)
            for mode, metric in metrics.items():
                if mode == "all":
                    ignore = np.zeros(len(label), np.float32)
                else:
                    lo, hi = MOTION_BINS[mode]
                    ignore = (~((motion > lo) & (motion <= hi))).astype(np.float32)
                metric.update(
                    pb[None], pi[None], ps[None], gt_boxes, gt_ids, ignore[None]
                )
        names, values = [], []
        for mode, metric in metrics.items():
            m_names, m_values = metric.get()
            if mode == "all":
                names.extend(m_names)
                values.extend(m_values)
            else:
                names.append(f"mAP({mode})")
                values.append(m_values[-1])
        return names, values
