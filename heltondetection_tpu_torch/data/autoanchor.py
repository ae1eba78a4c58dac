"""Anchor fitting ("autoanchor"): k-means and genetic evolution over the
dataset's box shapes; counterpart of heltondetection_tpu/data/autoanchor.py.

The YOLOv5 v6.1 trainer checks the best possible recall (BPR) of the
configured anchors against the training labels at train start and refits
them when BPR < 0.98. The default COCO anchors fit small-object sets such
as VisDrone badly.

* The metric is the v6.1 assigner's shape-ratio test, not IoU: a gt of size
  ``wh`` matches anchor ``a`` iff ``max(wh/a, a/wh) < anchor_t``
  elementwise, the rule of train/yolo_loss.py, so "the anchors fit" means
  "the assigner finds positives".
* k-means is seeded Lloyd's on std-whitened sizes; the genetic pass then
  mutates the means under the real fitness.
* Host numpy only, drawing from one ``np.random.default_rng(seed)`` in the
  reference's order: the same labels and seed give the reference's anchors
  exactly.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from heltondetection_tpu_torch.ops.anchors import YOLOV5_ANCHORS

Anchors = Tuple[Tuple[Tuple[float, float], ...], ...]


def flatten_anchors(anchors: Anchors) -> np.ndarray:
    """Per-level ((w,h)×A)×L nested anchors → flat (L*A, 2) float array."""
    return np.asarray([wh for level in anchors for wh in level], np.float64)


def anchors_to_levels(flat: np.ndarray, num_levels: int = 3) -> Anchors:
    """Flat (N,2) anchors → per-level nested tuples, sorted by area so the
    smallest anchors land on the highest-resolution level (stride 8), the
    v6.1 level convention. N must divide evenly into ``num_levels``."""
    n = len(flat)
    if n % num_levels:
        raise ValueError(f"{n} anchors do not split into {num_levels} levels")
    per = n // num_levels
    order = np.argsort(flat[:, 0] * flat[:, 1])
    srt = flat[order]
    return tuple(
        tuple((round(float(w), 2), round(float(h), 2))
              for w, h in srt[i * per:(i + 1) * per])
        for i in range(num_levels))


def ratio_metric(wh: np.ndarray, anchors_flat: np.ndarray) -> np.ndarray:
    """(N,2) gt sizes × (K,2) anchors → (N,) best shape-ratio score.

    score = min(wh/a, a/wh) over both dims, maximised over anchors; a gt
    is assignable iff its score > 1/anchor_t (the v6.1 assigner test of
    train/yolo_loss.py, inverted: ratio < anchor_t).
    """
    r = wh[:, None, :] / anchors_flat[None, :, :]          # (N,K,2)
    x = np.minimum(r, 1.0 / r).min(axis=2)                 # (N,K)
    return x.max(axis=1)                                   # (N,)


def anchor_stats(wh: np.ndarray, anchors: Anchors,
                 anchor_t: float = 4.0) -> dict:
    """BPR + fitness of ``anchors`` against gt sizes ``wh`` (pixels at the
    train resolution). BPR = fraction of gts the assigner CAN match; the
    v6.1 rule of thumb is "re-fit below 0.98"."""
    flat = flatten_anchors(anchors)
    best = ratio_metric(wh, flat)
    thr = 1.0 / anchor_t
    return {
        "bpr": float((best > thr).mean()) if len(best) else 1.0,
        "fitness": float((best * (best > thr)).mean()) if len(best) else 0.0,
        "n_boxes": int(len(best)),
    }


def _fitness(wh: np.ndarray, anchors_flat: np.ndarray,
             anchor_t: float) -> float:
    best = ratio_metric(wh, anchors_flat)
    thr = 1.0 / anchor_t
    return float((best * (best > thr)).mean())


def _kmeans(points: np.ndarray, k: int, rng: np.random.Generator,
            iters: int = 60) -> np.ndarray:
    """Seeded Lloyd's k-means with k-means++ init; returns (k, d) means."""
    n = len(points)
    # k-means++ seeding
    centers = np.empty((k, points.shape[1]), points.dtype)
    centers[0] = points[rng.integers(n)]
    d2 = ((points - centers[0]) ** 2).sum(1)
    for i in range(1, k):
        probs = d2 / d2.sum() if d2.sum() > 0 else np.full(n, 1.0 / n)
        centers[i] = points[rng.choice(n, p=probs)]
        d2 = np.minimum(d2, ((points - centers[i]) ** 2).sum(1))
    for _ in range(iters):
        # (n,k) distances → assignment
        d = ((points[:, None, :] - centers[None]) ** 2).sum(2)
        assign = d.argmin(1)
        new = centers.copy()
        for i in range(k):
            sel = points[assign == i]
            if len(sel):
                new[i] = sel.mean(0)
        if np.allclose(new, centers):
            break
        centers = new
    return centers


def fit_anchors(wh: np.ndarray, *, num_anchors: int = 9,
                anchor_t: float = 4.0, generations: int = 1000,
                seed: int = 0, num_levels: int = 3,
                min_size: float = 2.0) -> Tuple[Anchors, dict]:
    """Fit ``num_anchors`` anchors to gt sizes ``wh`` (pixels at the train
    resolution): whitened k-means init, then genetic evolution under the
    real assigner metric (mutate all coords by ~N(1, 0.1) factors, keep on
    fitness improvement — the v6.1 recipe). Returns (per-level anchors,
    stats dict of the result)."""
    wh = np.asarray(wh, np.float64).reshape(-1, 2)
    wh = wh[(wh >= min_size).all(axis=1)]        # sub-2px boxes are noise
    if len(wh) < num_anchors:
        raise ValueError(
            f"need at least {num_anchors} boxes >= {min_size}px to fit "
            f"anchors, got {len(wh)}")
    rng = np.random.default_rng(seed)
    std = wh.std(0)
    std[std == 0] = 1.0
    k = _kmeans(wh / std, num_anchors, rng) * std
    k = np.maximum(k, min_size)

    fit = _fitness(wh, k, anchor_t)
    shape = k.shape
    for _ in range(generations):
        mut = np.ones(shape)
        while (mut == 1.0).all():                # force a real mutation
            mask = rng.random(shape) < 0.9
            mut = np.clip(mask * rng.normal(1.0, 0.1, shape) +
                          ~mask * 1.0, 0.3, 3.0)
        cand = np.maximum(k * mut, min_size)
        f = _fitness(wh, cand, anchor_t)
        if f > fit:
            fit, k = f, cand
    levels = anchors_to_levels(k, num_levels)
    return levels, anchor_stats(wh, levels, anchor_t)


def dataset_label_wh(ds, img_size: int, *, max_images: Optional[int] = 10000,
                     seed: int = 0) -> np.ndarray:
    """Collect gt (w, h) in pixels AT THE TRAIN RESOLUTION from a dataset
    reader (data/readers.py contract).

    The letterbox scale for a square target is ``img_size / max(h0, w0)``
    (data/letterbox.py). COCO-style readers expose annotation metadata
    (``images`` + ``anns_by_img``), so sizes come without decoding a single
    image; other formats fall back to ``load()`` over a seeded sample of at
    most ``max_images`` images.
    """
    whs = []
    if hasattr(ds, "images") and hasattr(ds, "anns_by_img"):
        for img_id, im in ds.images.items():
            s = img_size / max(im["height"], im["width"])
            for a in ds.anns_by_img.get(img_id, []):
                if a.get("iscrowd", 0):
                    continue
                _, _, w, h = a["bbox"]
                if w > 0 and h > 0:
                    whs.append((w * s, h * s))
    else:
        idx = np.arange(len(ds))
        if max_images is not None and len(idx) > max_images:
            idx = np.random.default_rng(seed).choice(
                len(ds), max_images, replace=False)
        for i in idx:
            raw = ds.load(int(i))
            h0, w0 = raw["image"].shape[:2]
            s = img_size / max(h0, w0)
            b = raw["boxes"]
            if len(b):
                keep = np.ones(len(b), bool)
                if "iscrowd" in raw:
                    keep = raw["iscrowd"] == 0
                wh = (b[keep, 2:4] - b[keep, 0:2]) * s
                whs.extend(wh.tolist())
    return np.asarray(whs, np.float64).reshape(-1, 2)


def check_anchors(ds, *, img_size: int, anchors: Optional[Anchors] = None,
                  anchor_t: float = 4.0, bpr_thresh: float = 0.98,
                  seed: int = 0, generations: int = 1000,
                  max_images: Optional[int] = 10000,
                  ) -> Tuple[Optional[Anchors], dict]:
    """The train-start hook (v6.1 lineage): measure BPR of the configured
    anchors against the dataset; when it is below ``bpr_thresh``, fit new
    anchors and return them IF they beat the current fitness. Returns
    (new_anchors_or_None, stats) — None means "keep what you have"."""
    cur = anchors if anchors is not None else YOLOV5_ANCHORS
    wh = dataset_label_wh(ds, img_size, max_images=max_images, seed=seed)
    if len(wh) == 0:
        return None, {"bpr": 1.0, "fitness": 0.0, "n_boxes": 0}
    stats = anchor_stats(wh, cur, anchor_t)
    if stats["bpr"] >= bpr_thresh:
        return None, stats
    fitted, new_stats = fit_anchors(wh, anchor_t=anchor_t, seed=seed,
                                    generations=generations)
    if new_stats["fitness"] <= stats["fitness"]:
        return None, stats
    new_stats["prev_bpr"] = stats["bpr"]
    new_stats["prev_fitness"] = stats["fitness"]
    return fitted, new_stats
