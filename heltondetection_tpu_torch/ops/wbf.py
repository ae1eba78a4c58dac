"""Weighted Boxes Fusion of TTA views; counterpart of
heltondetection_tpu/ops/wbf.py.

A sequential greedy clustering over score-sorted candidates: each candidate
joins the cluster of its class whose fused box it overlaps most (above
``iou_thres``) or opens a new one; a cluster's box is the score-weighted
mean of its members, its score the mean member score scaled by
min(members, n_views) / n_views.

The reference runs one image under ``jit`` and ``vmap``s it over the batch.
Here the batch dimension is written out: the state is (B, N, …) and one
Python loop of at most N steps serves the whole batch, each step some
thirty small elementwise launches on the boxes' device (the reference's
scatter into one cluster slot is a select over all slots: no indexed
read-modify-write, whose launches cost the host several times more). The
loop runs as far as the image with the most valid candidates needs (one
host read before the loop, none inside it): an invalid candidate changes
no cluster.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from heltondetection_tpu_torch.ops.boxes import bbox_iou
from heltondetection_tpu_torch.ops.nms import _topk


def weighted_boxes_fusion(boxes: torch.Tensor, scores: torch.Tensor,
                          classes: torch.Tensor, valid: torch.Tensor, *,
                          n_views: int, iou_thres: float = 0.55,
                          max_out: int = 300,
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Fuse the candidates of all TTA views, already concatenated.

    boxes (..., N, 4) xyxy, scores (..., N), classes (..., N) int and valid
    (..., N) bool hold every view's dets of one image, or of a batch of
    images with leading dims. ``n_views`` is the T of the score rescale.
    Returns fused (boxes (..., max_out, 4), scores, classes int32, valid),
    sorted by fused score, descending; rows past the clusters are padding
    (zero box, score 0, class −1).
    """
    lead = boxes.shape[:-2]
    n = boxes.shape[-2]
    boxes = boxes.reshape(-1, n, 4).float()
    scores = scores.reshape(-1, n).float()
    classes = classes.reshape(-1, n).to(torch.int32)
    valid = valid.reshape(-1, n).bool()
    nb = boxes.shape[0]
    dev = boxes.device

    key = torch.where(valid, scores, torch.full_like(scores, -1.0))
    order = torch.sort(key, dim=-1, descending=True, stable=True)[1]
    b = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    v = torch.gather(valid, 1, order)
    s = torch.where(v, torch.gather(scores, 1, order),
                    torch.zeros_like(scores))
    c = torch.gather(classes, 1, order)

    # cluster state, one potential cluster slot per candidate
    sum_wb = torch.zeros((nb, n, 4), device=dev)       # Σ score·box
    sum_w = torch.zeros((nb, n), device=dev)           # Σ score
    cnt = torch.zeros((nb, n), device=dev)
    cls = torch.full((nb, n), -1, dtype=torch.int32, device=dev)
    active = torch.zeros((nb, n), dtype=torch.bool, device=dev)
    slots = torch.arange(n, device=dev)
    minus_one = torch.full((), -1.0, device=dev)

    # valid candidates sort first, so steps past the largest valid count
    # only meet invalid candidates, which add nothing
    n_steps = int(v.sum(-1).max()) if nb else 0
    for i in range(n_steps):
        bi = b[:, i:i + 1]                                       # (B, 1, 4)
        ci, vi, wi = c[:, i:i + 1], v[:, i:i + 1], s[:, i:i + 1]  # (B, 1)
        fused = sum_wb / sum_w.clamp(min=1e-9)[..., None]
        iou = bbox_iou(fused, bi)                                # (B, N)
        match = active & (cls == ci) & (iou > iou_thres)
        # best match = highest IoU among matches (first index on ties)
        mi = torch.argmax(torch.where(match, iou, minus_one), dim=-1,
                          keepdim=True)
        slot = torch.where(match.any(-1, keepdim=True), mi, i)
        # the reference scatters into the one slot; here every slot is
        # rewritten and only `slot` changes (selects, so a junk box of an
        # invalid candidate touches its own inactive slot alone)
        hot = slots == slot                                      # (B, N)
        hot_valid = hot & vi
        sum_wb = torch.where(hot[..., None], sum_wb + wi[..., None] * bi,
                             sum_wb)                             # wi: 0 if invalid
        sum_w = torch.where(hot, sum_w + wi, sum_w)
        cnt += hot_valid
        cls = torch.where(hot_valid, ci, cls)
        active |= hot_valid

    fused_boxes = sum_wb / sum_w.clamp(min=1e-9)[..., None]
    mean_score = sum_w / cnt.clamp(min=1.0)
    rescale = cnt.clamp(max=float(n_views)) / float(n_views)
    fused_scores = torch.where(active, mean_score * rescale,
                               torch.zeros_like(mean_score))

    k = min(max_out, n)
    out_s, oi = _topk(fused_scores, k)
    out_v = out_s > 0.0
    out_b = torch.where(
        out_v[..., None],
        torch.gather(fused_boxes, 1, oi[..., None].expand(-1, -1, 4)),
        torch.zeros((), device=dev))
    out_c = torch.where(out_v, torch.gather(cls, 1, oi), -1)
    if k < max_out:
        pad = max_out - k
        out_b = F.pad(out_b, (0, 0, 0, pad))
        out_s = F.pad(out_s, (0, pad))
        out_c = F.pad(out_c, (0, pad), value=-1)
        out_v = F.pad(out_v, (0, pad))
    return (out_b.reshape(lead + (max_out, 4)), out_s.reshape(lead + (max_out,)),
            out_c.reshape(lead + (max_out,)), out_v.reshape(lead + (max_out,)))
