"""The numbers that decide ``correct``: detections held to the reference's
candidates and detections, and a training step's readings held to the
reference's. Plain torch; nothing of the program."""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from benchmark.reference.common import (median_leaf_gap, moved_leaves,
                                        worst_leaf_gap)

MATCH_DIST = 0.1       # a reference det is found when a det of its class
#                        lies within this distance of it
NEAR_DIST = 0.01       # candidates within this of the nearest are equally
#                        good matches of a det
RECALL_TOP = 50        # reference dets an image that must be found
SCORE_OFF = 0.03       # a det's score is off when it differs from its
#                        candidate's by more than this share of it
POST_DIST = 1e-3       # a det and its counterpart from the same head
POST_SCORE = 1e-3      # logits differ by no more than float rounding
MAP_OFF = 0.3          # a head logit is off when it differs from the
#                        reference's by more than this share of the spread
#                        of its kind (box, objectness, class) on its level


def to_source(boxes: torch.Tensor, scale: float, pad_x: float, pad_y: float,
              h: float, w: float) -> torch.Tensor:
    """Letterbox xyxy pixels → source-frame xyxy, clipped to the frame."""
    x = ((boxes[..., 0::2] - pad_x) / scale).clamp(0, w)
    y = ((boxes[..., 1::2] - pad_y) / scale).clamp(0, h)
    return torch.stack([x[..., 0], y[..., 0], x[..., 1], y[..., 1]], -1)


def inside_frame(boxes: torch.Tensor, scale: float, pad_x: float,
                 pad_y: float, h: float, w: float) -> torch.Tensor:
    """Letterbox xyxy pixels → whether the box lies wholly inside the
    source frame, so that clipping leaves it as it is."""
    x = (boxes[..., 0::2] - pad_x) / scale
    y = (boxes[..., 1::2] - pad_y) / scale
    return (x[..., 0] >= 0) & (y[..., 0] >= 0) & (x[..., 1] <= w) & \
        (y[..., 1] <= h)


def box_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., n, 4) x (..., N, 4) xyxy → (..., n, N): the largest corner
    coordinate difference over 1 + the larger side of ``b``. Unlike IoU it
    is defined for boxes that clipping to the frame flattened."""
    d = (a[..., :, None, :] - b[..., None, :, :]).abs().amax(-1)
    side = torch.maximum(b[..., 2] - b[..., 0], b[..., 3] - b[..., 1])
    return d / (1.0 + side[..., None, :])


def det_gaps(port: Sequence[Dict], ref_dets, cand_boxes: torch.Tensor,
             cand_scores: torch.Tensor, metas: Sequence[Dict]) -> Dict:
    """Per image of a block: ``port[i]`` the program's dets as the
    Evaluator handed them on (``boxes`` xywh in source pixels, ``scores``,
    ``classes``), ``ref_dets`` the reference's (boxes, scores, classes,
    valid) in letterbox pixels, the reference's candidates (B, N, Cb, 4)
    (Cb = 1 when a candidate's box serves every class) with scores
    (B, N, C), ``metas[i]`` the letterbox (scale, pad_x, pad_y, h, w).
    Boxes are compared in source pixels, clipped to the frame, by
    :func:`box_dist`.

    Returns lists: ``score`` (per program det, the relative score gap to
    the nearest reference candidate of its class), ``box`` (that
    distance), ``missed`` and ``wanted`` (per image, of the reference's top
    ``RECALL_TOP`` dets, how many have no program det of their class
    within ``MATCH_DIST``; ``box_missed``: of any class; ``missed10`` and
    ``wanted10``: the same of its top 10), and per image its
    dets' ``score_images`` and ``box_images``; and ``inner``: the relative
    score gap of each det whose nearest candidate of its class lies wholly
    inside the frame, to that one candidate. Clipping to the
    frame flattens boxes near its edge onto each other, so that a det's
    nearest candidate there can be another anchor's; inside, the nearest
    is its own."""
    out = {"score": [], "box": [], "missed": [], "wanted": [],
           "score_images": [], "box_images": [], "box_missed": [],
           "missed10": [], "wanted10": [], "inner": []}
    dev = cand_scores.device
    rb, rs, rcls, rv = ref_dets
    for i, (p, m) in enumerate(zip(port, metas)):
        n0 = len(out["score"])
        geo = (m["scale"], m["pad_x"], m["pad_y"], m["h"], m["w"])
        pb = torch.as_tensor(p["boxes"], device=dev, dtype=torch.float32)
        pb = torch.cat([pb[:, :2], pb[:, :2] + pb[:, 2:]], 1)
        ps = torch.as_tensor(p["scores"], device=dev, dtype=torch.float32)
        pc = torch.as_tensor(p["classes"], device=dev).long()
        cb = to_source(cand_boxes[i], *geo)                    # (N, Cb, 4)
        if len(pb):
            if cb.shape[1] == 1:
                dist = box_dist(pb, cb[:, 0])                  # (n, N)
                inside = inside_frame(cand_boxes[i][:, 0], *geo)[None]
            else:
                dist = box_dist(pb[:, None, :],
                                cb.permute(1, 0, 2)[pc])[:, 0]  # (n, N)
                inside = inside_frame(cand_boxes[i], *geo).t()[pc]
            best, nearest = dist.min(1, keepdim=True)
            near = dist <= best + NEAR_DIST
            cs = cand_scores[i].t()[pc]                        # (n, N)
            gap = (ps[:, None] - cs).abs() / cs.clamp(min=1e-12)
            own = gap.gather(1, nearest)[:, 0]
            own_inside = inside.expand_as(gap).gather(1, nearest)[:, 0]
            out["inner"] += own[own_inside].tolist()
            gap = torch.where(near, gap, torch.full_like(gap, float("inf")))
            out["score"] += gap.amin(1).tolist()
            out["box"] += best[:, 0].tolist()
        out["score_images"].append(out["score"][n0:])
        out["box_images"].append(out["box"][n0:])
        top = min(RECALL_TOP, int(rv[i].sum()))
        want_b = to_source(rb[i][:top], *geo)
        want_c = rcls[i][:top].long()
        missed = box_missed = top
        found = torch.zeros(top, dtype=torch.bool, device=dev)
        if top and len(pb):
            near = (box_dist(pb, want_b) <= MATCH_DIST).t()    # (top, n)
            found = (near & (want_c[:, None] == pc[None, :])).any(1)
            missed = int((~found).sum())
            box_missed = int((~near.any(1)).sum())
        out["missed"].append(missed)
        out["box_missed"].append(box_missed)
        out["missed10"].append(int((~found[:10]).sum()))
        out["wanted10"].append(min(top, 10))
        out["wanted"].append(top)
    return out


def _quantile(xs: List[float], q: float) -> float:
    if not xs:
        return 0.0
    s = sorted(xs)
    return s[min(len(s) - 1, int(q * (len(s) - 1) + 0.5))]


def det_numbers(gaps: Dict) -> Dict[str, float]:
    """The eval cell's numbers from :func:`det_gaps` over every compared
    image: over all dets, the median and 90th percentile of the score and
    box gaps and the share of the reference's top dets missed; over
    images, the largest of each image's median gaps and missed share; and
    ``score_off_share``, over the dets whose candidate lies inside the
    frame, the share whose score is off by more than ``SCORE_OFF`` (1 where
    there are none)."""
    inner = gaps["inner"]
    wanted = max(sum(gaps["wanted"]), 1)
    out = {"recall_gap": sum(gaps["missed"]) / wanted,
           "box_recall_gap": sum(gaps["box_missed"]) / wanted,
           "recall10_gap": sum(gaps["missed10"]) / max(sum(gaps["wanted10"]),
                                                       1),
           "image_recall_gap": max((m / w for m, w in zip(gaps["missed"],
                                                         gaps["wanted"]) if w),
                                   default=0.0),
           "dets_compared": float(len(gaps["score"])),
           "inner_compared": float(len(inner)),
           "score_off_share": sum(v > SCORE_OFF for v in inner) /
           len(inner) if inner else 1.0}
    for k in ("score", "box"):
        out[f"{k}_gap_p50"] = _quantile(gaps[k], 0.5)
        out[f"{k}_gap_p90"] = _quantile(gaps[k], 0.9)
        out[f"image_{k}_gap"] = max((_quantile(v, 0.5) for v in
                                     gaps[f"{k}_images"] if v), default=0.0)
    return out


def post_unmatched(port: Sequence[Dict], ref_dets, metas: Sequence[Dict]
                   ) -> tuple:
    """The program's dets of a block (as :func:`det_gaps` takes them)
    against the reference's decode, selection and NMS of the program's own
    head logits (boxes, scores, classes, valid in letterbox pixels): the
    dets of either side with no counterpart on the other (the same class,
    within ``POST_DIST`` by :func:`box_dist` in source pixels, the score
    within ``POST_SCORE`` of it), and the dets of both."""
    rb, rs, rcls, rv = ref_dets
    unmatched = total = 0
    for i, (p, m) in enumerate(zip(port, metas)):
        geo = (m["scale"], m["pad_x"], m["pad_y"], m["h"], m["w"])
        v = rv[i]
        wb, ws, wc = to_source(rb[i][v], *geo), rs[i][v], rcls[i][v].long()
        pb = torch.as_tensor(p["boxes"], device=rb.device,
                             dtype=torch.float32)
        pb = torch.cat([pb[:, :2], pb[:, :2] + pb[:, 2:]], 1)
        ps = torch.as_tensor(p["scores"], device=rb.device,
                             dtype=torch.float32)
        pc = torch.as_tensor(p["classes"], device=rb.device).long()
        same = (box_dist(pb, wb) <= POST_DIST) & \
            (pc[:, None] == wc[None, :]) & \
            ((ps[:, None] - ws[None, :]).abs() <=
             POST_SCORE * ws[None, :].abs())
        unmatched += int((~same.any(1)).sum()) + int((~same.any(0)).sum())
        total += len(pb) + len(wb)
    return unmatched, total


def map_off_counts(got: Sequence[torch.Tensor], want: Sequence[torch.Tensor]
                   ) -> tuple:
    """Head logits of a block, per level (B, A, HW, 5 + C) in the order
    [tx, ty, tw, th, obj, cls…]: the program's ``got`` and the reference's
    ``want``. Per image, and per level and kind (box, objectness,
    classes), the logits that differ by more than ``MAP_OFF`` of the
    reference's spread of that kind on that level in the block; and the
    logits an image has of each level and kind."""
    offs, sizes = [], []
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        for sl in (slice(0, 4), slice(4, 5), slice(5, None)):
            ws = w[..., sl]
            off = (g[..., sl] - ws).abs() > MAP_OFF * ws.std()
            offs.append(off.flatten(1).sum(1))
            sizes.append(off[0].numel())
    return torch.stack(offs, 1).tolist(), sizes


def map_numbers(offs: Sequence[Sequence[int]], sizes: Sequence[int]
                ) -> Dict[str, float]:
    """From :func:`map_off_counts` over every compared image:
    ``map_off_share``, over the levels and kinds, the largest share of the
    logits that are off; ``image_map_off_share``, the same of the image
    with the most."""
    n = max(len(offs), 1)
    return {"map_off_share": max(sum(r[k] for r in offs) / (s * n)
                                 for k, s in enumerate(sizes)),
            "image_map_off_share": max(r[k] / s for r in offs
                                       for k, s in enumerate(sizes))}


def train_numbers(got: Dict, want: Dict, first_stage=None
                  ) -> Dict[str, float]:
    """A training run's readings against the reference's, both keyed by the
    reference's leaf names: ``loss`` (per step, the terms and ``total``),
    ``grad_norm`` (step 1, before the clip), ``grad`` (per leaf, the norm of
    the first gradient as the optimizer took it), ``change`` and ``ema``
    (per leaf, the norm of the move from the start after the steps).

    ``first_stage`` (a prefix of loss terms, a prefix of leaf names) adds
    ``stage1_term_gap`` and ``stage1_grad_gap``: the same gaps over the
    terms and leaves of a two-stage model's first stage only, whose
    sampling the program and the reference share; the second stage samples
    from proposals that rounding may reorder."""
    loss_gap = max(abs(g["total"] - w["total"]) / abs(w["total"])
                   for g, w in zip(got["loss"], want["loss"]))
    term_gap = max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-3 * abs(w["total"]))
                   for g, w in zip(got["loss"], want["loss"]) for k in w
                   if k != "total")
    names = sorted(want["grad"])
    moved = moved_leaves(want["grad"], names)
    miss = [n for n in names if n not in got["grad"]]
    if miss:
        raise ValueError(f"the program has no gradient for {miss[:3]}")
    out = {
        "loss_gap": loss_gap,
        "term_gap": term_gap,
        "grad_norm_gap": abs(got["grad_norm"] - want["grad_norm"]) /
        want["grad_norm"],
        "grad_gap": worst_leaf_gap(got["grad"], want["grad"], names)[0],
        "grad_gap_median": median_leaf_gap(got["grad"], want["grad"], names),
        "change_gap": worst_leaf_gap(got["change"], want["change"], moved)[0],
        "change_gap_median": median_leaf_gap(got["change"], want["change"],
                                             moved),
        "ema_gap": worst_leaf_gap(got["ema"], want["ema"], moved)[0],
    }
    if first_stage:
        term, leaf = first_stage
        out["stage1_term_gap"] = max(
            abs(g[k] - w[k]) / abs(w[k]) for g, w in zip(got["loss"],
                                                        want["loss"])
            for k in w if k.startswith(term))
        names1 = [n for n in names if n.startswith(leaf)]
        out["stage1_grad_gap"] = worst_leaf_gap(got["grad"], want["grad"],
                                                names1)[0]
    return out
