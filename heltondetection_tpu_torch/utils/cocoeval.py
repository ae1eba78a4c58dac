"""COCO-style bbox mAP, pycocotools-compatible; the port's own copy of
``DetEval`` in heltondetection_tpu/utils/cocoeval.py.

The same IoU thresholds (.5:.05:.95), 101-point interpolated precision,
area ranges, maxDets, crowd handling (IoU against a crowd gt is the
intersection over the det's area), ignore propagation and stable score
sorting. Host-side numpy: the device hands over fixed-shape det arrays and
this consumes them.

The greedy matcher is the numpy one. The reference's C++ matcher, the
per-class table, the confusion matrix, the P/R/F1 curves, the COCO JSON
export and the PNG savers come with the runner slice.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNG = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
MAX_DETS = (1, 10, 100)


def _iou_xywh(dt: np.ndarray, gt: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """pycocotools' bbox IoU of (x, y, w, h) boxes; against a crowd gt the
    union is the det's own area."""
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)))
    dx1, dy1 = dt[:, 0], dt[:, 1]
    dx2, dy2 = dt[:, 0] + dt[:, 2], dt[:, 1] + dt[:, 3]
    gx1, gy1 = gt[:, 0], gt[:, 1]
    gx2, gy2 = gt[:, 0] + gt[:, 2], gt[:, 1] + gt[:, 3]
    iw = np.clip(np.minimum(dx2[:, None], gx2[None]) -
                 np.maximum(dx1[:, None], gx1[None]), 0, None)
    ih = np.clip(np.minimum(dy2[:, None], gy2[None]) -
                 np.maximum(dy1[:, None], gy1[None]), 0, None)
    inter = iw * ih
    d_area = (dt[:, 2] * dt[:, 3])[:, None]
    g_area = (gt[:, 2] * gt[:, 3])[None, :]
    union = np.where(iscrowd[None, :].astype(bool), d_area,
                     d_area + g_area - inter)
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


@dataclass
class DetEval:
    """Accumulates detections and ground truth, then computes COCO AP stats.

        ev = DetEval(num_classes)
        ev.add_gt(img_id, boxes_xywh, classes, iscrowd=None, areas=None)
        ev.add_det(img_id, boxes_xywh, scores, classes)
        stats = ev.summarize()   # AP, AP50, AP75, APs/m/l, AR...
    """
    num_classes: int
    iou_thrs: np.ndarray = field(default_factory=lambda: IOU_THRS.copy())
    _gts: Dict = field(default_factory=dict)       # (img, cat) -> list
    _dts: Dict = field(default_factory=dict)
    _cat_ids: set = field(default_factory=set)
    _prep_cache: Dict = field(default_factory=dict)  # see _prep_img_cat

    def _iou_index(self, iou: float) -> int:
        """Index of ``iou`` in ``iou_thrs``; a threshold off the grid
        raises."""
        hit = np.isclose(self.iou_thrs, iou)
        if not hit.any():
            raise ValueError(
                f"IoU threshold {iou} is not on the evaluation grid "
                f"{np.round(self.iou_thrs, 2).tolist()}")
        return int(np.argmax(hit))

    def add_gt(self, img_id, boxes_xywh, classes, iscrowd=None, areas=None,
               ignore=None):
        boxes_xywh = np.asarray(boxes_xywh, np.float64).reshape(-1, 4)
        classes = np.asarray(classes, np.int64).reshape(-1)
        n = len(classes)
        iscrowd = (np.zeros(n, np.int64) if iscrowd is None
                   else np.asarray(iscrowd, np.int64))
        areas = (boxes_xywh[:, 2] * boxes_xywh[:, 3] if areas is None
                 else np.asarray(areas, np.float64))
        ignore = (np.zeros(n, np.int64) if ignore is None
                  else np.asarray(ignore, np.int64))
        self._prep_cache.clear()
        for i in range(n):
            key = (img_id, int(classes[i]))
            self._gts.setdefault(key, []).append(
                (boxes_xywh[i], int(iscrowd[i]), float(areas[i]),
                 int(ignore[i]) or int(iscrowd[i])))
            self._cat_ids.add(int(classes[i]))

    def reset_dets(self):
        """Clear the detections and keep the ground truth, so a new set of
        detections can be scored against the same gts."""
        self._dts.clear()
        self._prep_cache.clear()

    def add_det(self, img_id, boxes_xywh, scores, classes):
        boxes_xywh = np.asarray(boxes_xywh, np.float64).reshape(-1, 4)
        scores = np.asarray(scores, np.float64).reshape(-1)
        classes = np.asarray(classes, np.int64).reshape(-1)
        self._prep_cache.clear()
        for i in range(len(scores)):
            key = (img_id, int(classes[i]))
            self._dts.setdefault(key, []).append((boxes_xywh[i],
                                                  float(scores[i])))
            self._cat_ids.add(int(classes[i]))

    # -- core ----------------------------------------------------------------

    def _prep_img_cat(self, img_id, cat, max_det):
        """Per-(img, cat) arrays and IoU matrix, computed once and shared by
        the four area ranges (area changes only the gt-ignore flags). Dets
        are score-sorted and capped at ``max_det``; gts stay in insertion
        order."""
        key = (img_id, cat, max_det)
        cached = self._prep_cache.get(key)
        if cached is not None:
            return cached
        gts = self._gts.get((img_id, cat), [])
        dts = self._dts.get((img_id, cat), [])
        if not gts and not dts:
            prep = None
        else:
            g_boxes = np.array([g[0] for g in gts]).reshape(-1, 4)
            g_crowd = np.array([g[1] for g in gts], np.int64)
            g_areas = np.array([g[2] for g in gts], np.float64)
            g_flag = np.array([g[3] for g in gts], np.int64)  # ignore|crowd
            d_scores_all = np.array([d[1] for d in dts])
            dt_order = np.argsort(-d_scores_all, kind="mergesort")[:max_det]
            d_boxes = np.array([dts[i][0] for i in dt_order]).reshape(-1, 4)
            d_scores = d_scores_all[dt_order] if len(dts) else d_scores_all
            ious = _iou_xywh(d_boxes, g_boxes, g_crowd)
            prep = (g_boxes, g_crowd, g_areas, g_flag, d_boxes, d_scores,
                    ious)
        self._prep_cache[key] = prep
        return prep

    def _evaluate_img(self, img_id, cat, area_rng, max_det):
        """COCOeval.evaluateImg for one (img, cat, area), matched at the
        largest maxDet; accumulate slices the first columns for the smaller
        ones (greedy matching of higher-score dets ignores later dets).

        Among equal-IoU candidates the last gt in (non-ignored-first,
        stable) order wins, and ignored gts are eligible only when no
        non-ignored gt clears the threshold, as in the sequential scan.
        """
        prep = self._prep_img_cat(img_id, cat, max_det)
        if prep is None:
            return None
        g_boxes, g_crowd, g_areas, g_flag, d_boxes, d_scores, ious = prep
        T = len(self.iou_thrs)

        g_ig = (g_flag.astype(bool) | (g_areas < area_rng[0]) |
                (g_areas > area_rng[1])).astype(np.int64)
        gt_order = np.argsort(g_ig, kind="stable")  # non-ignored first
        g_ig = g_ig[gt_order]
        g_crowd = g_crowd[gt_order]
        ious = ious[:, gt_order]

        G, D = len(g_ig), len(d_scores)
        dtm = np.zeros((T, D), np.int64) - 1
        dt_ig = np.zeros((T, D), np.int64)
        nonig = g_ig == 0
        crowd = g_crowd == 1
        for t in range(T if G else 0):     # with no gt nothing matches
            thr = min(self.iou_thrs[t], 1 - 1e-10)
            gtm_t = np.full(G, -1, np.int64)
            for d in range(D):
                iou_d = ious[d]
                avail = (gtm_t < 0) | crowd
                cand = avail & (iou_d >= thr)
                pool = cand & nonig
                if not pool.any():
                    pool = cand & ~nonig
                if not pool.any():
                    continue
                vals = np.where(pool, iou_d, -1.0)
                m = int(np.flatnonzero(vals == vals.max())[-1])
                dtm[t, d] = m
                dt_ig[t, d] = g_ig[m]
                gtm_t[m] = d
        return self._finish_eval(dtm, dt_ig, d_boxes, d_scores, g_ig,
                                 area_rng)

    @staticmethod
    def _finish_eval(dtm, dt_ig, d_boxes, d_scores, g_ig, area_rng):
        D = len(d_scores)
        d_areas = d_boxes[:, 2] * d_boxes[:, 3] if D else np.zeros(0)
        out = (d_areas < area_rng[0]) | (d_areas > area_rng[1])
        dt_ig = np.logical_or(dt_ig, (dtm < 0) & out[None, :]).astype(np.int64)
        return {
            "dt_scores": d_scores,
            "dt_matched": dtm >= 0,
            "dt_ignore": dt_ig.astype(bool),
            "num_gt": int(np.sum(g_ig == 0)),
        }

    def accumulate(self):
        cats = (sorted(self._cat_ids) if self._cat_ids
                else list(range(self.num_classes)))
        T = len(self.iou_thrs)
        R = len(REC_THRS)
        K = len(cats)
        A = len(AREA_RNG)
        M = len(MAX_DETS)
        max_det_full = MAX_DETS[-1]
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))
        # only (img, cat) pairs with any gt or dt contribute (pycocotools
        # skips images absent from both)
        keys_by_cat: Dict[int, list] = {}
        for (img, cat) in set(self._gts) | set(self._dts):
            keys_by_cat.setdefault(cat, []).append(img)
        for k, cat in enumerate(cats):
            imgs = sorted(keys_by_cat.get(cat, []), key=str)
            for a, arng in enumerate(AREA_RNG.values()):
                evals = [self._evaluate_img(i, cat, arng, max_det_full)
                         for i in imgs]
                evals = [e for e in evals if e is not None]
                if not evals:
                    continue
                for m, max_det in enumerate(MAX_DETS):
                    dt_scores = np.concatenate(
                        [e["dt_scores"][:max_det] for e in evals])
                    order = np.argsort(-dt_scores, kind="mergesort")
                    dt_scores = dt_scores[order]
                    matched = np.concatenate(
                        [e["dt_matched"][:, :max_det] for e in evals],
                        axis=1)[:, order]
                    ignored = np.concatenate(
                        [e["dt_ignore"][:, :max_det] for e in evals],
                        axis=1)[:, order]
                    npig = sum(e["num_gt"] for e in evals)
                    if npig == 0:
                        continue
                    tps = matched & ~ignored
                    fps = ~matched & ~ignored
                    tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
                    fp_sum = np.cumsum(fps, axis=1).astype(np.float64)
                    for t in range(T):
                        tp, fp = tp_sum[t], fp_sum[t]
                        nd = len(tp)
                        rc = tp / npig
                        pr = tp / np.maximum(fp + tp, np.spacing(1))
                        recall[t, k, a, m] = rc[-1] if nd else 0
                        # precision envelope, non-increasing from the right
                        pr = np.maximum.accumulate(pr[::-1])[::-1]
                        q = np.zeros(R)
                        inds = np.searchsorted(rc, REC_THRS, side="left")
                        ok = inds < nd
                        q[ok] = pr[inds[ok]]
                        precision[t, :, k, a, m] = q
        self._prep_cache.clear()   # free the per-(img, cat) IoU cache
        return precision, recall

    def summarize(self) -> Dict[str, float]:
        """COCO stats of the gts and dets added so far. It accumulates on
        every call: the reference reuses the first call's result after
        ``reset_dets`` or ``add_det``, and so reports stale stats."""
        p, r = self.accumulate()
        area_names = list(AREA_RNG.keys())

        def ap(iou_thr=None, area="all", max_det=100):
            a = area_names.index(area)
            m = MAX_DETS.index(max_det)
            s = p[:, :, :, a, m]
            if iou_thr is not None:
                s = s[[self._iou_index(iou_thr)]]
            s = s[s > -1]
            return float(np.mean(s)) if s.size else -1.0

        def ar(area="all", max_det=100):
            a = area_names.index(area)
            m = MAX_DETS.index(max_det)
            s = r[:, :, a, m]
            s = s[s > -1]
            return float(np.mean(s)) if s.size else -1.0

        return {
            "AP": ap(),
            "AP50": ap(iou_thr=0.5),
            "AP75": ap(iou_thr=0.75),
            "AP_small": ap(area="small"),
            "AP_medium": ap(area="medium"),
            "AP_large": ap(area="large"),
            "AR1": ar(max_det=1),
            "AR10": ar(max_det=10),
            "AR100": ar(max_det=100),
            "AR_small": ar(area="small"),
            "AR_medium": ar(area="medium"),
            "AR_large": ar(area="large"),
        }


def format_summary(stats: Dict[str, float]) -> str:
    """COCOeval-style printout of :meth:`DetEval.summarize`'s stats."""
    rows = [
        ("Average Precision  (AP) @[ IoU=0.50:0.95 | area=   all | maxDets=100 ]", "AP"),
        ("Average Precision  (AP) @[ IoU=0.50      | area=   all | maxDets=100 ]", "AP50"),
        ("Average Precision  (AP) @[ IoU=0.75      | area=   all | maxDets=100 ]", "AP75"),
        ("Average Precision  (AP) @[ IoU=0.50:0.95 | area= small | maxDets=100 ]", "AP_small"),
        ("Average Precision  (AP) @[ IoU=0.50:0.95 | area=medium | maxDets=100 ]", "AP_medium"),
        ("Average Precision  (AP) @[ IoU=0.50:0.95 | area= large | maxDets=100 ]", "AP_large"),
        ("Average Recall     (AR) @[ IoU=0.50:0.95 | area=   all | maxDets=  1 ]", "AR1"),
        ("Average Recall     (AR) @[ IoU=0.50:0.95 | area=   all | maxDets= 10 ]", "AR10"),
        ("Average Recall     (AR) @[ IoU=0.50:0.95 | area=   all | maxDets=100 ]", "AR100"),
        ("Average Recall     (AR) @[ IoU=0.50:0.95 | area= small | maxDets=100 ]", "AR_small"),
        ("Average Recall     (AR) @[ IoU=0.50:0.95 | area=medium | maxDets=100 ]", "AR_medium"),
        ("Average Recall     (AR) @[ IoU=0.50:0.95 | area= large | maxDets=100 ]", "AR_large"),
    ]
    return "\n".join(f" {name} = {stats[key]:0.3f}" for name, key in rows)
