"""COCO-protocol bbox evaluation without pycocotools (copy of
``viddet_tpu/eval/coco_eval.py``, numpy only).

Implements the standard COCO detection protocol from its published
definition: 10 IoU thresholds 0.50:0.05:0.95, 101-point interpolated
precision at recall thresholds 0:0.01:1, area ranges all/small/medium/large,
max detections 1/10/100, crowd ground truth as ignore regions (IoU against a
crowd box is intersection / detection-area), detections matched greedily in
score order preferring non-ignored GT.

GT "area" for the S/M/L bins follows the official definition: the
annotation's own ``area`` field (segmentation area) when the dataset supplies
it (``COCODetection.gt_areas``), with a bbox-area fallback for box-only
datasets.  Detection areas are bbox areas, as in pycocotools.  Results on
box-only fixtures match the protocol exactly.

``COCODetectionMetric`` accumulates padded fixed-shape detections, then
``get()`` -> AP / AP50 / AP75 / AP-S/M/L.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
MAX_DETS = (1, 10, 100)
AREA_RNG = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}


def _iou_xyxy(dt: np.ndarray, gt: np.ndarray, crowd: np.ndarray) -> np.ndarray:
    """IoU matrix (D, G); for crowd GT, IoU = inter / det_area.

    Fully vectorized (float64) — identical arithmetic to the scalar
    definition: clamped side lengths, union = D + G - I (or D for crowd),
    0 where the union is empty.
    """
    d, g = len(dt), len(gt)
    if d == 0 or g == 0:
        return np.zeros((d, g))
    dx1, dy1, dx2, dy2 = (dt[:, i, None] for i in range(4))  # (D,1)
    gx1, gy1, gx2, gy2 = (gt[None, :, i] for i in range(4))  # (1,G)
    inter = np.maximum(np.minimum(dx2, gx2) - np.maximum(dx1, gx1), 0.0) * (
        np.maximum(np.minimum(dy2, gy2) - np.maximum(dy1, gy1), 0.0)
    )
    darea = np.maximum(dx2 - dx1, 0.0) * np.maximum(dy2 - dy1, 0.0)
    garea = np.maximum(gx2 - gx1, 0.0) * np.maximum(gy2 - gy1, 0.0)
    union = np.where(crowd[None, :], darea, darea + garea - inter)
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.where(union > 0, inter / np.where(union > 0, union, 1.0), 0.0)
    return out


def _greedy_match(ious: np.ndarray, g_ignore: np.ndarray, crowd: np.ndarray):
    """Greedy score-order matching, all IoU thresholds at once.

    ious: (D, G) with detections in descending-score order and GT in
    ignored-LAST order (the pycocotools scan order).  Returns dtm (T, D)
    matched gt index or -1, identical to the sequential reference scan:
    per detection, the running-max update over gts (last tied index wins)
    restricted to unclaimed-or-crowd gts, a match in the non-ignored
    section short-circuiting the ignored section.

    Greedy in score order means detection i's match depends only on
    detections before it — so a maxDet-truncated evaluation equals a
    prefix slice of this full result (the fact `accumulate` exploits).
    """
    d_n, g_n = ious.shape
    t_n = len(IOU_THRS)
    thr = np.minimum(IOU_THRS, 1 - 1e-10)  # (T,)
    n_real = int((~g_ignore).sum())  # g_ignore is sorted: real gts first
    gtm = -np.ones((t_n, g_n), np.int64)
    dtm = -np.ones((t_n, d_n), np.int64)
    if g_n == 0:
        return dtm  # nothing to claim; every detection stays unmatched
    # A detection whose best IoU over ALL gts is below the lowest threshold
    # can never match (real or ignored) and never claims a gt — skipping it
    # leaves the sequential state identical.  At real-COCO scale most
    # detections of most (image, class) pairs are such noise.
    plausible = np.flatnonzero(ious.max(axis=1) >= thr.min())
    t_idx = np.arange(t_n)
    for di in plausible:
        cand = np.where(
            (gtm < 0) | crowd[None, :], ious[di][None, :], -1.0
        )  # (T, G): claimed non-crowd gts are out
        m = np.full(t_n, -1, np.int64)
        if n_real:
            real = cand[:, :n_real]
            best = real.max(axis=1)
            # last index achieving the max == the sequential running-max pick
            last = n_real - 1 - np.argmax(real[:, ::-1] == best[:, None], axis=1)
            ok = best >= thr
            m = np.where(ok, last, m)
        if g_n > n_real:
            ig = cand[:, n_real:]
            best_i = ig.max(axis=1)
            last_i = (
                g_n - 1 - np.argmax(ig[:, ::-1] == best_i[:, None], axis=1)
            )
            # the ignored section is only reachable when the non-ignored
            # section produced no match (the reference's break)
            m = np.where((m < 0) & (best_i >= thr), last_i, m)
        hit = m >= 0
        dtm[:, di] = m
        gtm[t_idx[hit], m[hit]] = di
    return dtm


class COCOEvalBBox:
    """Protocol evaluator over plain-array ground truth and detections.

    gts: image_id -> (boxes (G,4) xyxy, classes (G,), iscrowd (G,))
    dts: image_id -> (boxes (D,4) xyxy, classes (D,), scores (D,))
    """

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.gts: Dict = {}
        self.dts: Dict = {}

    def add_image(self, image_id, gt_boxes, gt_classes, gt_crowd, dt_boxes,
                  dt_classes, dt_scores, gt_areas=None):
        boxes = np.asarray(gt_boxes, np.float64).reshape(-1, 4)
        if gt_areas is None:
            # bbox-area fallback for box-only datasets; real COCO supplies
            # the annotation's segmentation area (official S/M/L definition)
            gt_areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
        self.gts[image_id] = (
            boxes,
            np.asarray(gt_classes, np.int64).reshape(-1),
            np.asarray(gt_crowd, bool).reshape(-1),
            np.asarray(gt_areas, np.float64).reshape(-1),
        )
        self.dts[image_id] = (
            np.asarray(dt_boxes, np.float64).reshape(-1, 4),
            np.asarray(dt_classes, np.int64).reshape(-1),
            np.asarray(dt_scores, np.float64).reshape(-1),
        )

    def _evaluate_img_cat(self, img_id, cat, gsel, dsel):
        """Evaluate one (image, class) pair for ALL area ranges at once.

        The IoU matrix is computed ONCE per pair; each area range permutes
        GT into ignored-last order and runs the vectorized greedy match at
        the maxDet=100 cap.  Per-maxDet results come from prefix slices in
        ``accumulate`` (exact: greedy score-order matching of a prefix is
        the prefix of the full match — see ``_greedy_match``).

        Returns (scores (D,), per-area list of (matched (T,D), dt_ig (T,D),
        npig)) or None when the pair is empty.
        """
        gt_boxes, gt_cls, gt_crowd, gt_areas = self.gts[img_id]
        dt_boxes, dt_cls, dt_scores = self.dts[img_id]
        gt_b, crowd, g_area = gt_boxes[gsel], gt_crowd[gsel], gt_areas[gsel]
        dt_b, scores = dt_boxes[dsel], dt_scores[dsel]
        if len(gt_b) == 0 and len(dt_b) == 0:
            return None

        d_order = np.argsort(-scores, kind="stable")[: max(MAX_DETS)]
        dt_b, scores = dt_b[d_order], scores[d_order]
        d_area = (dt_b[:, 2] - dt_b[:, 0]) * (dt_b[:, 3] - dt_b[:, 1])
        ious = _iou_xyxy(dt_b, gt_b, crowd)

        per_area = []
        # The greedy match depends ONLY on the GT-ignore pattern; area
        # ranges frequently share it (e.g. every GT of the pair falls in
        # one size bin: "all" and that bin coincide, the other two bins
        # are all-ignored) — cache by pattern, reuse the match.
        match_cache: Dict[bytes, tuple] = {}
        for rng in AREA_RNG.values():
            g_ignore = crowd | (g_area < rng[0]) | (g_area > rng[1])
            key = g_ignore.tobytes()
            hit = match_cache.get(key)
            if hit is None:
                g_order = np.argsort(g_ignore, kind="stable")  # non-ignored first
                gi_sorted = g_ignore[g_order]
                dtm = _greedy_match(ious[:, g_order], gi_sorted, crowd[g_order])
                matched = dtm >= 0
                # ignore status of the matched gt; index -1 -> harmless
                gi_pad = np.append(gi_sorted, False)
                hit = (matched, gi_pad[dtm], int((~gi_sorted).sum()))
                match_cache[key] = hit
            matched, ig_from_gt, npig = hit
            d_out = (d_area < rng[0]) | (d_area > rng[1])
            # ignored detection: matched an ignored GT, or unmatched + out
            dt_ig = np.where(matched, ig_from_gt, d_out[None, :])
            per_area.append((matched, dt_ig, npig))
        return scores, per_area

    def accumulate(self):
        """-> precision (T, R, K, A, M), recall (T, K, A, M); -1 where empty."""
        T, R, K = len(IOU_THRS), len(REC_THRS), self.num_classes
        A, M = len(AREA_RNG), len(MAX_DETS)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))
        img_ids = sorted(self.gts)

        # One pass over (image, present class): evaluate every area range
        # from a single IoU matrix, bucketing results per class.  (The old
        # per-(class, area, maxDet) image sweep recomputed the pure-Python
        # IoU matrix ~960x per image — hours on val2017-scale inputs.)
        results: Dict[int, List] = {k: [] for k in range(K)}
        for img_id in img_ids:
            _, gt_cls, _, _ = self.gts[img_id]
            _, dt_cls, _ = self.dts[img_id]
            for cat in np.union1d(gt_cls, dt_cls):
                cat = int(cat)
                if not 0 <= cat < K:
                    continue
                r = self._evaluate_img_cat(
                    img_id, cat, gt_cls == cat, dt_cls == cat
                )
                if r is not None:
                    results[cat].append(r)

        for k in range(K):
            entries = results[k]
            for a in range(A):
                npig = sum(e[1][a][2] for e in entries)
                if npig == 0:
                    continue
                for m, max_det in enumerate(MAX_DETS):
                    if entries:
                        scores = np.concatenate(
                            [e[0][:max_det] for e in entries]
                        )
                        order = np.argsort(-scores, kind="mergesort")
                        mt = np.concatenate(
                            [e[1][a][0][:, :max_det] for e in entries], axis=1
                        )[:, order]
                        ig = np.concatenate(
                            [e[1][a][1][:, :max_det] for e in entries], axis=1
                        )[:, order]
                    else:
                        mt = np.zeros((T, 0), bool)
                        ig = np.zeros((T, 0), bool)
                    tps = np.cumsum(mt & ~ig, axis=1).astype(np.float64)
                    fps = np.cumsum(~mt & ~ig, axis=1).astype(np.float64)
                    n_d = tps.shape[1]
                    rc = tps / npig
                    pr = tps / np.maximum(tps + fps, np.spacing(1))
                    recall[:, k, a, m] = rc[:, -1] if n_d else 0.0
                    # precision envelope (monotone non-increasing), then
                    # sampled at the 101 recall points — vectorized over T
                    env = np.maximum.accumulate(pr[:, ::-1], axis=1)[:, ::-1]
                    for t in range(T):
                        inds = np.searchsorted(rc[t], REC_THRS, side="left")
                        ok = inds < n_d
                        q = np.zeros(R)
                        q[ok] = env[t][inds[ok]]
                        precision[t, :, k, a, m] = q
        return precision, recall

    def summarize(self) -> Dict[str, float]:
        precision, recall = self.accumulate()

        def ap(iou=None, area="all", max_det=100):
            a = list(AREA_RNG).index(area)
            m = list(MAX_DETS).index(max_det)
            p = precision[:, :, :, a, m]
            if iou is not None:
                t = int(np.argmin(np.abs(IOU_THRS - iou)))
                p = p[t : t + 1]
            p = p[p > -1]
            return float(np.mean(p)) if p.size else -1.0

        def ar(area="all", max_det=100):
            a = list(AREA_RNG).index(area)
            m = list(MAX_DETS).index(max_det)
            r = recall[:, :, a, m]
            r = r[r > -1]
            return float(np.mean(r)) if r.size else -1.0

        return {
            "AP": ap(),
            "AP50": ap(iou=0.5),
            "AP75": ap(iou=0.75),
            "AP_small": ap(area="small"),
            "AP_medium": ap(area="medium"),
            "AP_large": ap(area="large"),
            "AR_1": ar(max_det=1),
            "AR_10": ar(max_det=10),
            "AR_100": ar(max_det=100),
            "AR_small": ar(area="small"),
            "AR_medium": ar(area="medium"),
            "AR_large": ar(area="large"),
        }


class COCODetectionMetric:
    """Streaming metric over a COCODetection dataset (reference surface)."""

    def __init__(self, dataset):
        self._dataset = dataset
        self._eval = COCOEvalBBox(num_classes=len(dataset.classes))

    def reset(self):
        self._eval = COCOEvalBBox(num_classes=len(self._dataset.classes))

    def update_with_indices(self, pred_bboxes, pred_ids, pred_scores, indices):
        """Predictions in ORIGINAL image coords + dataset indices."""
        for b, idx in enumerate(indices):
            label = self._dataset.label(int(idx))
            pb = np.asarray(pred_bboxes[b])
            pi = np.asarray(pred_ids[b]).reshape(-1)
            ps = np.asarray(pred_scores[b]).reshape(-1)
            keep = (pi >= 0) & (ps >= 0)
            areas = (
                self._dataset.gt_areas(int(idx))
                if hasattr(self._dataset, "gt_areas") else None
            )
            self._eval.add_image(
                self._dataset.image_id(int(idx)),
                label[:, :4],
                label[:, 4],
                label[:, 5] > 0,
                pb[keep],
                pi[keep],
                ps[keep],
                gt_areas=areas,
            )

    def state_dict(self):
        """Picklable per-image GT/detection tables (multi-host eval merge).

        Eval shards are disjoint image sets, so the merged state is a plain
        dict union; ``accumulate()`` iterates ``sorted(self.gts)``, making
        the final numbers independent of merge order.
        """
        return {"gts": dict(self._eval.gts), "dts": dict(self._eval.dts)}

    def merge_state(self, state) -> None:
        dup = set(state["gts"]) & set(self._eval.gts)
        if dup:
            # an overlap means some image was evaluated on two shards —
            # refuse loudly rather than silently overwrite one copy
            raise ValueError(
                f"duplicate image ids across eval shards: {sorted(dup)[:5]}"
            )
        self._eval.gts.update(state["gts"])
        self._eval.dts.update(state["dts"])

    def get(self) -> Tuple[List[str], List[float]]:
        stats = self._eval.summarize()
        return list(stats.keys()), list(stats.values())
