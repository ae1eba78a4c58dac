"""COCO-style bbox mAP, pycocotools-compatible; the port's own copy of
``DetEval`` in heltondetection_tpu/utils/cocoeval.py.

The same IoU thresholds (.5:.05:.95), 101-point interpolated precision,
area ranges, maxDets, crowd handling (IoU against a crowd gt is the
intersection over the det's area), ignore propagation and stable score
sorting. Host-side numpy: the device hands over fixed-shape det arrays and
this consumes them. The greedy matching of each (image, category, area
range) runs in C++ (``native/cocoeval_core.cpp``) where g++ built it, else
in numpy; both give the same answers.

Beside the COCO stats: the per-class AP table (:meth:`DetEval.per_class_ap`,
:func:`format_classwise`), the confusion matrix, precision, recall and F1
against the confidence threshold, the COCO results JSON
(:meth:`DetEval.to_coco_json`) and three PNG renderings, which need
matplotlib (imported where it is used, so it stays optional).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

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
    _img_ids: set = field(default_factory=set)
    _prep_cache: Dict = field(default_factory=dict)  # see _prep_img_cat
    # (precision, recall, cats) of the gts and dets as they are; every
    # add_gt, add_det and reset_dets drops it
    _acc: Optional[Tuple] = None

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
        self._changed()
        self._img_ids.add(img_id)
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
        self._changed()

    def add_det(self, img_id, boxes_xywh, scores, classes):
        boxes_xywh = np.asarray(boxes_xywh, np.float64).reshape(-1, 4)
        scores = np.asarray(scores, np.float64).reshape(-1)
        classes = np.asarray(classes, np.int64).reshape(-1)
        self._changed()
        self._img_ids.add(img_id)
        for i in range(len(scores)):
            key = (img_id, int(classes[i]))
            self._dts.setdefault(key, []).append((boxes_xywh[i],
                                                  float(scores[i])))
            self._cat_ids.add(int(classes[i]))

    def _changed(self):
        self._prep_cache.clear()
        self._acc = None

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
        if G and D:
            from heltondetection_tpu_torch.native import match_dets_native
            native = match_dets_native(self.iou_thrs, ious, g_ig, g_crowd)
            if native is not None:
                return self._finish_eval(*native, d_boxes, d_scores, g_ig,
                                         area_rng)
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
        self._acc = (precision, recall, cats)
        return precision, recall

    def _accumulated(self) -> Tuple[np.ndarray, np.ndarray, list]:
        """(precision, recall, cats) of the gts and dets as they are now:
        :meth:`accumulate` unless nothing changed since its last call."""
        if self._acc is None:
            self.accumulate()
        return self._acc

    def per_class_ap(self) -> Dict[int, Dict[str, float]]:
        """Per-category AP and AP50 @[all | maxDets=100], the mmdet
        ``classwise`` table; a category with no gt anywhere stays -1, as in
        pycocotools' masked means."""
        p, _, cats = self._accumulated()
        a = list(AREA_RNG.keys()).index("all")
        m = MAX_DETS.index(100)
        t50 = self._iou_index(0.5)
        out: Dict[int, Dict[str, float]] = {}
        for k, cat in enumerate(cats):
            s = p[:, :, k, a, m]
            v = s[s > -1]
            s50 = s[t50][s[t50] > -1]
            out[int(cat)] = {
                "AP": float(np.mean(v)) if v.size else -1.0,
                "AP50": float(np.mean(s50)) if s50.size else -1.0,
            }
        return out

    def confusion_matrix(self, conf_thres: float = 0.25,
                         iou_thres: float = 0.45) -> np.ndarray:
        """(nc+1, nc+1) confusion matrix of the dets and gts, Ultralytics'
        val-time matrix (row: predicted class, column: true class, last
        index: background). Dets at or above ``conf_thres`` match gts at
        IoU ≥ ``iou_thres`` greedily in score order; an unmatched gt counts
        in the background row, an unmatched det in the background column.
        Crowd and ignored gts take part in the matching, but a det they
        absorb counts nowhere and they are never used up."""
        nc = self.num_classes
        mat = np.zeros((nc + 1, nc + 1), np.int64)
        per_g: Dict = {}
        per_d: Dict = {}
        for (img, cat), gts in self._gts.items():
            for box, crowd, _area, ig in gts:
                per_g.setdefault(img, []).append((box, cat, crowd or ig))
        for (img, cat), dts in self._dts.items():
            for box, score in dts:
                if score >= conf_thres:
                    per_d.setdefault(img, []).append((box, cat, score))
        for img in set(per_g) | set(per_d):
            gts = per_g.get(img, [])
            dts = sorted(per_d.get(img, []), key=lambda d: -d[2])
            g_boxes = np.array([g[0] for g in gts]).reshape(-1, 4)
            g_ig = np.array([g[2] for g in gts], bool).reshape(-1)
            d_boxes = np.array([d[0] for d in dts]).reshape(-1, 4)
            ious = _iou_xywh(d_boxes, g_boxes, g_ig.astype(np.int64))
            taken = np.zeros(len(gts), bool)
            for di, (_box, dc, _s) in enumerate(dts):
                if len(gts):
                    ok = ious[di] >= iou_thres
                    # a real gt first: an ignored one never takes a match
                    # from a real gt in the same spot
                    cand = np.where(ok & ~taken & ~g_ig)[0]
                    if cand.size:
                        gi = int(cand[np.argmax(ious[di][cand])])
                        taken[gi] = True
                        mat[dc, gts[gi][1]] += 1
                        continue
                    if (ok & g_ig).any():
                        continue    # absorbed by a crowd or ignored region
                mat[dc, nc] += 1          # FP: background column
            for gi, (_box, gc, ig) in enumerate(gts):
                if not taken[gi] and not ig:
                    mat[nc, gc] += 1      # FN: background row
        return mat

    def prf_at_conf(self, conf_grid: Optional[np.ndarray] = None,
                    iou: float = 0.5) -> Dict[int, Dict[str, np.ndarray]]:
        """Precision, recall and F1 against the confidence threshold at one
        IoU (default 0.5), the data of Ultralytics' P, R and F1 curves:
        ``{cat: {"conf", "P", "R", "F1"}}`` from the COCO matching of
        :meth:`accumulate` (ignored dets count as neither TP nor FP, recall
        is over the non-ignored gts)."""
        if conf_grid is None:
            conf_grid = np.linspace(0.0, 1.0, 101)
        t = self._iou_index(iou)
        area = AREA_RNG["all"]
        max_det = MAX_DETS[-1]
        cats = (sorted(self._cat_ids) if self._cat_ids
                else list(range(self.num_classes)))
        imgs = sorted(self._img_ids, key=str)
        out: Dict[int, Dict[str, np.ndarray]] = {}
        for cat in cats:
            scores, tp, ng = [], [], 0
            for img in imgs:
                e = self._evaluate_img(img, cat, area, max_det)
                if e is None:
                    continue
                keep = ~e["dt_ignore"][t]
                scores.append(e["dt_scores"][keep])
                tp.append(e["dt_matched"][t][keep])
                ng += e["num_gt"]
            if not scores:
                continue
            s = np.concatenate(scores)
            f = np.concatenate(tp)
            order = np.argsort(-s, kind="mergesort")
            s, f = s[order], f[order]
            # dets with score >= c: -s ascends, and s_i >= c ⇔ -s_i <= -c
            n_at = np.searchsorted(-s, -conf_grid, side="right")
            tp_at = np.concatenate([[0], np.cumsum(f)])[n_at]
            P = np.where(n_at > 0, tp_at / np.maximum(n_at, 1), 1.0)
            R = tp_at / max(ng, 1) if ng else np.zeros_like(P)
            F1 = np.where(P + R > 0, 2 * P * R / np.maximum(P + R, 1e-12),
                          0.0)
            out[int(cat)] = {"conf": conf_grid, "P": P, "R": R, "F1": F1}
        self._prep_cache.clear()   # free the per-(img, cat) IoU cache
        return out

    def to_coco_json(self, label_to_cat: Optional[Dict[int, int]] = None
                     ) -> List[Dict]:
        """The detections as a COCO results list (``[{image_id,
        category_id, bbox xywh, score}]``, pycocotools' ``loadRes``
        format). ``label_to_cat`` maps the contiguous labels back to the
        dataset's category ids (``COCODataset.label_to_cat``); identity
        when omitted."""
        out: List[Dict] = []
        for (img_id, cat), dets in self._dts.items():
            cat_id = label_to_cat[cat] if label_to_cat else cat
            for box, score in dets:
                out.append({"image_id": img_id, "category_id": int(cat_id),
                            "bbox": [round(float(v), 3) for v in box],
                            "score": round(float(score), 5)})
        return out

    def summarize(self) -> Dict[str, float]:
        """COCO stats of the gts and dets added so far. It accumulates anew
        after any change: the reference reuses its first ``accumulate``
        after ``reset_dets`` or ``add_det``, and so reports stale stats."""
        p, r, _ = self._accumulated()
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


def format_classwise(per_class: Dict[int, Dict[str, float]],
                     class_names: Optional[Sequence[str]] = None) -> str:
    """:meth:`DetEval.per_class_ap` as the mmdet classwise table (category
    | AP | AP50, three across)."""
    cells = []
    for cat, v in sorted(per_class.items()):
        name = class_names[cat] if class_names and cat < len(class_names) \
            else str(cat)
        cells.append(f"{name[:18]:<18} {v['AP']*100:6.2f} "
                     f"{v['AP50']*100:6.2f}")
    header = f"{'category':<18} {'AP':>6} {'AP50':>6}"
    ncol = 3
    lines = [" | ".join([header] * min(ncol, max(len(cells), 1)))]
    for i in range(0, len(cells), ncol):
        lines.append(" | ".join(cells[i:i + ncol]))
    return "\n".join(lines)


def _pyplot():
    """matplotlib's pyplot on the Agg backend; raises ImportError where
    matplotlib is not installed (the renderings are optional)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def save_confusion_png(mat: np.ndarray,
                       class_names: Optional[Sequence[str]],
                       path: str, normalize: bool = True) -> None:
    """:meth:`DetEval.confusion_matrix` as Ultralytics' heat-map PNG, each
    true-class column normalized to sum to 1."""
    plt = _pyplot()
    n = mat.shape[0]
    cls_names = (list(class_names) if class_names else
                 [str(i) for i in range(n - 1)])
    # the last row and column are background, whatever names were passed
    names = cls_names[:n - 1] + [str(i) for i in
                                 range(len(cls_names), n - 1)] + ["background"]
    m = mat.astype(np.float64)
    if normalize:
        m = m / np.maximum(m.sum(0, keepdims=True), 1e-9)
    fig, ax = plt.subplots(figsize=(max(6, n * 0.35),) * 2, dpi=120)
    im = ax.imshow(m, cmap="Blues", vmin=0.0)
    ax.set_xticks(range(n), names, rotation=90, fontsize=7)
    ax.set_yticks(range(n), names, fontsize=7)
    ax.set_xlabel("True")
    ax.set_ylabel("Predicted")
    if n <= 30:   # cell labels only where they are readable
        for i in range(n):
            for j in range(n):
                if mat[i, j]:
                    ax.text(j, i, f"{m[i, j]:.2f}" if normalize
                            else str(mat[i, j]), ha="center", va="center",
                            fontsize=6,
                            color="white" if m[i, j] > 0.5 else "black")
    fig.colorbar(im, ax=ax, fraction=0.046)
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)


# a fixed categorical palette, in order; hues follow class identity
_SERIES = ("#2a78d6", "#eb6834", "#1baf7a", "#eda100",
           "#e87ba4", "#008300", "#4a3aa7", "#e34948")


def save_pr_curves_png(det: DetEval, class_names: Optional[Sequence[str]],
                       path: str) -> None:
    """Per-class precision-recall curves @IoU 0.5 (area all, maxDets 100),
    Ultralytics' PR_curve.png. Up to 8 classes get a coloured line each
    (the palette in order, with a legend); beyond that every class is a
    thin grey line and only the bold mean curve is drawn in ink."""
    plt = _pyplot()
    precision, _, cats = det._accumulated()
    a = list(AREA_RNG.keys()).index("all")
    m = MAX_DETS.index(100)
    p = precision[det._iou_index(0.5), :, :, a, m]          # (R, K)
    names = list(class_names) if class_names else [str(c) for c in cats]
    fig, ax = plt.subplots(figsize=(7, 5), dpi=120)
    fig.patch.set_facecolor("#fcfcfb")
    ax.set_facecolor("#fcfcfb")
    present = [k for k in range(len(cats)) if (p[:, k] > -1).any()]
    small = len(present) <= len(_SERIES)
    for i, k in enumerate(present):
        y = np.where(p[:, k] > -1, p[:, k], 0.0)
        ap = float(np.mean(p[:, k][p[:, k] > -1]))
        cat = cats[k]
        label = names[cat] if cat < len(names) else str(cat)
        if small:
            ax.plot(REC_THRS, y, color=_SERIES[i], linewidth=2,
                    label=f"{label} {ap:.3f}")
        else:
            ax.plot(REC_THRS, y, color="#c9c8c2", linewidth=0.8)
    if present:
        valid = p[:, present]
        mean = np.where(valid > -1, valid, 0.0).mean(1)
        map50 = float(np.mean([np.mean(p[:, k][p[:, k] > -1])
                               for k in present]))
        ax.plot(REC_THRS, mean, color="#0b0b0b", linewidth=2.5,
                label=f"all classes {map50:.3f} mAP@0.5")
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1.02)
    ax.set_xlabel("Recall", color="#0b0b0b")
    ax.set_ylabel("Precision", color="#0b0b0b")
    ax.set_title("Precision-Recall @ IoU 0.5", color="#0b0b0b")
    ax.grid(True, color="#e8e7e3", linewidth=0.6)
    for sp in ax.spines.values():
        sp.set_color("#c9c8c2")
    ax.tick_params(colors="#52514e")
    ax.legend(loc="lower left", fontsize=7, frameon=False)
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)


def save_prf_curves_png(det: DetEval, class_names: Optional[Sequence[str]],
                        path: str) -> Tuple[float, float]:
    """Precision, recall and F1 against the confidence @IoU 0.5, three
    stacked panels (Ultralytics' P, R and F1 curves in one figure), with
    :func:`save_pr_curves_png`'s colours and the mean F1's peak labelled.
    Returns ``(best_conf, best_f1)``: the confidence where the mean F1
    peaks, a suggestion for ``test.conf_thres``."""
    plt = _pyplot()
    curves = det.prf_at_conf()
    cats = sorted(curves)
    if not cats:
        raise ValueError("no category has a gt or a det to plot")
    names = list(class_names) if class_names else [str(c) for c in cats]
    small = len(cats) <= len(_SERIES)
    fig, axes = plt.subplots(3, 1, figsize=(7, 9), dpi=120, sharex=True)
    fig.patch.set_facecolor("#fcfcfb")
    best = (0.0, 0.0)
    for ax, key, ylab in zip(axes, ("P", "R", "F1"),
                             ("Precision", "Recall", "F1")):
        ax.set_facecolor("#fcfcfb")
        for i, cat in enumerate(cats):
            c = curves[cat]
            label = names[cat] if cat < len(names) else str(cat)
            if small:
                ax.plot(c["conf"], c[key], color=_SERIES[i], linewidth=1.6,
                        label=label if key == "P" else None)
            else:
                ax.plot(c["conf"], c[key], color="#c9c8c2", linewidth=0.8)
        mean = np.mean([curves[cat][key] for cat in cats], axis=0)
        ax.plot(curves[cats[0]]["conf"], mean, color="#0b0b0b",
                linewidth=2.5, label="all classes" if key == "P" else None)
        if key == "F1":
            j = int(np.argmax(mean))
            cbest = float(curves[cats[0]]["conf"][j])
            best = (cbest, float(mean[j]))
            ax.annotate(f"best F1 {mean[j]:.2f} @ conf {cbest:.2f}",
                        (cbest, mean[j]), textcoords="offset points",
                        xytext=(6, 6), fontsize=8, color="#0b0b0b")
            ax.axvline(cbest, color="#c9c8c2", linewidth=0.8)
        ax.set_ylim(0, 1.05)
        ax.set_ylabel(ylab, color="#0b0b0b")
        ax.grid(True, color="#e8e7e3", linewidth=0.6)
        for sp in ax.spines.values():
            sp.set_color("#c9c8c2")
        ax.tick_params(colors="#52514e")
    axes[0].legend(loc="lower left", fontsize=7, frameon=False)
    axes[-1].set_xlim(0, 1)
    axes[-1].set_xlabel("Confidence threshold", color="#0b0b0b")
    axes[0].set_title("Precision / Recall / F1 vs confidence @ IoU 0.5",
                      color="#0b0b0b")
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return best
