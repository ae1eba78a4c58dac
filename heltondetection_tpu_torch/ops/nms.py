"""Greedy class-aware NMS; counterpart of heltondetection_tpu/ops/nms.py.

Boxes come score-DESC-sorted, (N, 4) xyxy, with the class offset already
added for class-aware NMS; zero rows are inert padding (they overlap
nothing). Box j is suppressed iff some KEPT box i < j overlaps it. All
functions here test the predicate of the Pallas kernels,
``inter > thr * (area_i + area_j - inter + 1e-7)``; the reference's XLA
paths test ``inter / union > thr``, which differs only at exact ties.

* :func:`nms_mask_seq` — the sequential greedy scan over the suppression
  matrix, batched (counterpart of ``nms_mask_jnp``); the plain version of
  the ``nms_mask`` CUDA kernel and the CPU path of :func:`batched_nms`.
* :func:`nms_mask_fixpoint` — iterate K ← [K·S ≤ 0.5] from K = 1 to its
  fixpoint, which is the greedy mask; the plain version of the
  ``nms_fixpoint`` CUDA kernel.
* :func:`nms_mask_fixpoint_batched` — the entry the fused postprocess
  calls, with the contract of ``nms_mask_fixpoint_pallas`` (any N): the
  ``nms_fixpoint`` kernel for CUDA tensors up to its shared-memory limit,
  the ``nms_mask`` kernel above it (:func:`fixpoint_route`), the plain
  version for CPU tensors.
* :func:`nms_mask_batched` — the same for ``nms_mask_pallas``: the
  ``nms_mask`` kernel (any N) for CUDA tensors, :func:`nms_mask_seq` for
  CPU tensors.
* :func:`batched_nms` — score filter → top-k → NMS → fixed ``max_det``
  gather, the whole postprocess stage of the unfused eval path. Every route
  of the reference (``use_pallas``, ``method``) computes the same exact
  greedy mask, so there is no switch: CUDA tensors go through the
  ``nms_mask`` kernel.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from heltondetection_tpu_torch.kernels import nms as nms_kernel
from heltondetection_tpu_torch.kernels import ops as kernel_ops

_MAX_WH = 8192.0  # class-offset stride; > any supported input size


def _topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last dim, ties lower index first (as
    ``jax.lax.top_k`` orders them)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def suppression_matrix(boxes: torch.Tensor, iou_thres: float) -> torch.Tensor:
    """(..., N, 4) → (..., N, N) bool, S[i, j] = i would suppress j (j > i)."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1).clamp(min=0.0) * (y2 - y1).clamp(min=0.0)
    iw = (torch.minimum(x2[..., :, None], x2[..., None, :]) -
          torch.maximum(x1[..., :, None], x1[..., None, :])).clamp(min=0.0)
    ih = (torch.minimum(y2[..., :, None], y2[..., None, :]) -
          torch.maximum(y1[..., :, None], y1[..., None, :])).clamp(min=0.0)
    inter = iw * ih
    union = area[..., :, None] + area[..., None, :] - inter + 1e-7
    n = boxes.shape[-2]
    upper = torch.ones((n, n), dtype=torch.bool, device=boxes.device).triu(1)
    return (inter > iou_thres * union) & upper


def nms_mask_seq(boxes: torch.Tensor, iou_thres: float) -> torch.Tensor:
    """Greedy keep mask (..., N) of sorted boxes (..., N, 4) by the row
    scan: row i removes what it suppresses iff box i is still kept."""
    sup = suppression_matrix(boxes, iou_thres)
    keep = torch.ones(boxes.shape[:-1], dtype=torch.bool,
                      device=boxes.device)
    for i in range(boxes.shape[-2]):
        keep &= ~(sup[..., i, :] & keep[..., i:i + 1])
    return keep


def nms_mask_fixpoint(boxes: torch.Tensor, iou_thres: float) -> torch.Tensor:
    """Greedy keep mask (..., N) of sorted boxes (..., N, 4) by fixpoint
    iteration. S is strictly upper triangular, so the fixpoint is unique and
    equals the greedy scan; it is reached after at most N steps, one per
    link of the deepest suppression chain. The products sum 0/1 values, so
    they are exact in any float mode."""
    sup = suppression_matrix(boxes, iou_thres).float()
    k = torch.ones(boxes.shape[:-1], dtype=torch.float32, device=boxes.device)
    for _ in range(boxes.shape[-2]):
        k_new = ((k.unsqueeze(-2) @ sup).squeeze(-2) <= 0.5).float()
        if torch.equal(k_new, k):
            break
        k = k_new
    return k > 0.5


def fixpoint_route(n: int, fixpoint_max_n: int, mask_max_n: int) -> str:
    """The kernel that :func:`nms_mask_fixpoint_batched` launches for N
    boxes on a card whose ``nms_fixpoint`` takes N up to
    ``fixpoint_max_n`` (a multiple of 32) and whose ``nms_mask`` takes N up
    to ``mask_max_n`` (a multiple of 64; the largest N whose N²/8-byte
    bitmask fits the card's memory): ``"nms_fixpoint"`` while N, padded to
    32, fits the first, else ``"nms_mask"`` while N, padded to 64, fits the
    second. Both compute the same greedy mask under the same predicate. A
    larger N raises ``ValueError``. A route by size only: a kernel that
    fails to build, launch or allocate still raises."""
    if n + (-n) % 32 <= fixpoint_max_n:
        return "nms_fixpoint"
    if n + (-n) % 64 <= mask_max_n:
        return "nms_mask"
    raise ValueError(f"fused NMS at N={n}: nms_fixpoint takes N up to "
                     f"{fixpoint_max_n} and nms_mask up to {mask_max_n}, "
                     f"the largest N whose (N, N) bitmask the card can hold")


def nms_mask_fixpoint_batched(boxes: torch.Tensor,
                              iou_thres: float) -> torch.Tensor:
    """Keep mask (B, N) bool of score-sorted boxes (B, N, 4). On a CUDA
    tensor this launches the ``nms_fixpoint`` kernel (N padded to a
    multiple of 32 with inert zero rows) up to its shared-memory limit
    (2400 on an H100), and the ``nms_mask`` kernel above it
    (:func:`fixpoint_route`); on a CPU tensor the op runs the plain
    :func:`nms_mask_fixpoint`. Both through the custom ops of
    ``kernels/ops.py``; the padding and the route stay here."""
    if boxes.device.type == "cpu":
        return kernel_ops.nms_fixpoint(boxes, iou_thres)
    if boxes.device.type != "cuda":
        raise ValueError(f"no NMS for device {boxes.device}")
    n = boxes.shape[1]
    route = fixpoint_route(n, nms_kernel.nms_fixpoint_max_n(boxes.device),
                           nms_kernel.nms_mask_max_n(boxes.device))
    if route == "nms_mask":
        return nms_mask_batched(boxes, iou_thres)
    pad = (-n) % 32
    nb = F.pad(boxes.float(), (0, 0, 0, pad)).contiguous()
    return kernel_ops.nms_fixpoint(nb, iou_thres)[:, :n]


def nms_mask_batched(boxes: torch.Tensor, iou_thres: float) -> torch.Tensor:
    """Keep mask (B, N) bool of score-sorted boxes (B, N, 4). On a CUDA
    tensor this launches the ``nms_mask`` kernel (N padded to a multiple of
    64 with inert zero rows); on a CPU tensor the op runs the plain
    :func:`nms_mask_seq`. Both through the custom op
    ``heltondetection::nms_mask``."""
    if boxes.device.type == "cpu":
        return kernel_ops.nms_mask(boxes, iou_thres)
    if boxes.device.type != "cuda":
        raise ValueError(f"no NMS for device {boxes.device}")
    n = boxes.shape[1]
    pad = (-n) % 64
    nb = F.pad(boxes.float(), (0, 0, 0, pad)).contiguous()
    return kernel_ops.nms_mask(nb, iou_thres)[:, :n]


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor,
                classes: torch.Tensor, *, iou_thres: float = 0.65,
                score_thres: float = 0.001, pre_nms_topk: int = 1024,
                max_det: int = 300, class_aware: bool = True,
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """Fixed-shape postprocess of a batch of candidates.

    boxes (B, N, 4) xyxy, scores (B, N) (obj·cls for YOLO), classes (B, N)
    int → boxes (B, max_det, 4), scores, classes and valid (B, max_det), in
    score order. Candidates at or below ``score_thres`` drop out, the top
    ``pre_nms_topk`` go through greedy NMS (class-aware through the class
    offset unless ``class_aware=False``), and invalid rows carry score 0,
    class −1 and a zero box.
    """
    b, n, _ = boxes.shape
    s = torch.where(scores > score_thres, scores,
                    torch.full_like(scores, -1.0))
    k = min(pre_nms_topk, n)
    top_s, top_i = _topk(s, k)
    top_boxes = torch.gather(boxes, 1, top_i[..., None].expand(-1, -1, 4))
    top_cls = torch.gather(classes, 1, top_i)
    valid = top_s > 0.0

    nms_boxes = top_boxes
    if class_aware:
        nms_boxes = top_boxes + top_cls.float()[..., None] * _MAX_WH
    # inert padding: invalid rows collapse to zero-area boxes at the origin
    nms_boxes = torch.where(valid[..., None], nms_boxes,
                            torch.zeros_like(nms_boxes))
    keep = nms_mask_batched(nms_boxes, iou_thres) & valid

    # the top max_det kept rows, in score order
    kept_s = torch.where(keep, top_s, torch.full_like(top_s, -1.0))
    if k < max_det:          # fewer candidates than det slots
        pad = max_det - k
        kept_s = F.pad(kept_s, (0, pad), value=-1.0)
        top_boxes = F.pad(top_boxes, (0, 0, 0, pad))
        top_cls = F.pad(top_cls, (0, pad), value=-1)
    out_s, oi = _topk(kept_s, max_det)
    out_valid = out_s > 0.0
    out_boxes = torch.where(
        out_valid[..., None],
        torch.gather(top_boxes, 1, oi[..., None].expand(-1, -1, 4)),
        torch.zeros((), dtype=top_boxes.dtype, device=top_boxes.device))
    out_cls = torch.where(out_valid, torch.gather(top_cls, 1, oi), -1)
    out_s = torch.where(out_valid, out_s, torch.zeros_like(out_s))
    return out_boxes, out_s, out_cls, out_valid
