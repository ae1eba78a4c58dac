"""Greedy class-aware NMS keep masks; counterpart of
heltondetection_tpu/ops/nms.py.

Boxes come score-DESC-sorted, (N, 4) xyxy, with the class offset already
added for class-aware NMS; zero rows are inert padding (they overlap
nothing). Box j is suppressed iff some KEPT box i < j overlaps it. All
functions here test the predicate of the Pallas kernels,
``inter > thr * (area_i + area_j - inter + 1e-7)``; the reference's XLA
paths test ``inter / union > thr``, which differs only at exact ties.

* :func:`nms_mask_seq` — the sequential greedy scan over the suppression
  matrix (counterpart of ``nms_mask_jnp``); a test reference.
* :func:`nms_mask_fixpoint` — iterate K ← [K·S ≤ 0.5] from K = 1 to its
  fixpoint, which is the greedy mask; the plain version of the CUDA kernel
  and the CPU path.
* :func:`nms_mask_fixpoint_batched` — the entry the postprocess calls, with
  the contract of ``nms_mask_fixpoint_pallas``: the CUDA kernel for CUDA
  tensors, the plain version for CPU tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from heltondetection_tpu_torch.kernels import nms as nms_kernel


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
    """Greedy keep mask (N,) of sorted boxes (N, 4) by the row scan."""
    sup = suppression_matrix(boxes, iou_thres)
    keep = torch.ones(boxes.shape[0], dtype=torch.bool, device=boxes.device)
    for i in range(boxes.shape[0]):
        if keep[i]:
            keep &= ~sup[i]
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


def nms_mask_fixpoint_batched(boxes: torch.Tensor,
                              iou_thres: float) -> torch.Tensor:
    """Keep mask (B, N) bool of score-sorted boxes (B, N, 4). On a CUDA
    tensor this launches the ``nms_fixpoint`` kernel (N padded to a
    multiple of 32 with inert zero rows); on a CPU tensor it runs the plain
    :func:`nms_mask_fixpoint`."""
    if boxes.device.type == "cpu":
        return nms_mask_fixpoint(boxes, iou_thres)
    if boxes.device.type != "cuda":
        raise ValueError(f"no NMS for device {boxes.device}")
    n = boxes.shape[1]
    pad = (-n) % 32
    nb = F.pad(boxes.float(), (0, 0, 0, pad)).contiguous()
    return nms_kernel.nms_fixpoint(nb, iou_thres)[:, :n]
