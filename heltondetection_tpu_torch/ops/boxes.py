"""Box geometry; counterpart of heltondetection_tpu/ops/boxes.py.

``xyxy`` is (x1, y1, x2, y2) in absolute pixels, ``cxcywh`` (cx, cy, w, h),
``xywh`` COCO's (x_min, y_min, w, h). Every function takes any leading batch
dims with the box dim last. :func:`encode_deltas` and
:func:`decode_deltas` are FasterRCNN's box coder (torchvision's
``BoxCoder``), :func:`box_ioa_matrix` COCO's crowd overlap.

:func:`iou_matrix` is the public op of the ``iou_matrix`` CUDA kernel
(``csrc/iou_matrix.cu``, counterpart of ``iou_matrix_pallas``); its plain
version is :func:`box_iou_matrix`.
"""

from __future__ import annotations

import math

import torch

from heltondetection_tpu_torch.kernels import ops as kernel_ops

EPS = 1e-7


def cxcywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - w * 0.5, cy - h * 0.5,
                        cx + w * 0.5, cy + h * 0.5], dim=-1)


def xyxy_to_cxcywh(b: torch.Tensor) -> torch.Tensor:
    x1, y1, x2, y2 = b.unbind(-1)
    return torch.stack([(x1 + x2) * 0.5, (y1 + y2) * 0.5,
                        x2 - x1, y2 - y1], dim=-1)


def xywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    x, y, w, h = b.unbind(-1)
    return torch.stack([x, y, x + w, y + h], dim=-1)


def xyxy_to_xywh(b: torch.Tensor) -> torch.Tensor:
    x1, y1, x2, y2 = b.unbind(-1)
    return torch.stack([x1, y1, x2 - x1, y2 - y1], dim=-1)


def clip_boxes(b: torch.Tensor, h: float, w: float) -> torch.Tensor:
    """Clip xyxy boxes to the image bounds [0, w] x [0, h]."""
    x1, y1, x2, y2 = b.unbind(-1)
    return torch.stack([x1.clamp(0.0, w), y1.clamp(0.0, h),
                        x2.clamp(0.0, w), y2.clamp(0.0, h)], dim=-1)


def box_area(b: torch.Tensor) -> torch.Tensor:
    """Area of xyxy boxes; negative extents clamp to 0."""
    return ((b[..., 2] - b[..., 0]).clamp(min=0.0) *
            (b[..., 3] - b[..., 1]).clamp(min=0.0))


def bbox_iou(box1: torch.Tensor, box2: torch.Tensor, *, fmt: str = "xyxy",
             kind: str = "iou") -> torch.Tensor:
    """Elementwise IoU between broadcast-compatible boxes, ``kind`` one of
    iou, giou, diou and ciou. CIoU is the YOLOv5 v6.1 formula: the
    aspect-ratio term v = (4/π²)(atan(w2/h2) − atan(w1/h1))² with
    alpha = v / (1 − iou + v) computed in the graph."""
    if kind not in ("iou", "giou", "diou", "ciou"):
        raise ValueError(f"unknown IoU kind: {kind}")
    if fmt == "cxcywh":
        box1, box2 = cxcywh_to_xyxy(box1), cxcywh_to_xyxy(box2)
    # x and y ride together as (..., 2) halves: the same arithmetic per
    # element as the reference's per-coordinate form, in half the launches
    lo1, hi1, lo2, hi2 = box1[..., :2], box1[..., 2:], box2[..., :2], \
        box2[..., 2:]
    wh = (torch.minimum(hi1, hi2) - torch.maximum(lo1, lo2)).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    wh1, wh2 = hi1 - lo1, hi2 - lo2
    union = wh1[..., 0] * wh1[..., 1] + wh2[..., 0] * wh2[..., 1] - inter + EPS
    iou = inter / union
    if kind == "iou":
        return iou

    c = torch.maximum(hi1, hi2) - torch.minimum(lo1, lo2)      # enclosing box
    if kind == "giou":
        c_area = c[..., 0] * c[..., 1] + EPS
        return iou - (c_area - union) / c_area

    c2 = c[..., 0] * c[..., 0] + c[..., 1] * c[..., 1] + EPS   # diagonal²
    d = (lo2 + hi2 - lo1 - hi1) ** 2
    rho2 = (d[..., 0] + d[..., 1]) * 0.25
    if kind == "diou":
        return iou - rho2 / c2

    v = (4.0 / math.pi ** 2) * (
        torch.atan(wh2[..., 0] / (wh2[..., 1] + EPS)) -
        torch.atan(wh1[..., 0] / (wh1[..., 1] + EPS))) ** 2
    alpha = v / (v - iou + (1.0 + EPS))
    return iou - (rho2 / c2 + v * alpha)


def box_iou_matrix(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of xyxy boxes: (..., N, 4) x (..., M, 4) → (..., N, M)."""
    a = boxes1[..., :, None, :]
    b = boxes2[..., None, :, :]
    iw = (torch.minimum(a[..., 2], b[..., 2]) -
          torch.maximum(a[..., 0], b[..., 0])).clamp(min=0.0)
    ih = (torch.minimum(a[..., 3], b[..., 3]) -
          torch.maximum(a[..., 1], b[..., 1])).clamp(min=0.0)
    inter = iw * ih
    area_a = box_area(boxes1)[..., :, None]
    area_b = box_area(boxes2)[..., None, :]
    return inter / (area_a + area_b - inter + EPS)


def box_ioa_matrix(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise intersection over the area of ``boxes1``: (..., N, 4) x
    (..., M, 4) → (..., N, M)."""
    a = boxes1[..., :, None, :]
    b = boxes2[..., None, :, :]
    iw = (torch.minimum(a[..., 2], b[..., 2]) -
          torch.maximum(a[..., 0], b[..., 0])).clamp(min=0.0)
    ih = (torch.minimum(a[..., 3], b[..., 3]) -
          torch.maximum(a[..., 1], b[..., 1])).clamp(min=0.0)
    return iw * ih / (box_area(boxes1)[..., :, None] + EPS)


def encode_deltas(anchors: torch.Tensor, gt: torch.Tensor,
                  weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """xyxy anchors and xyxy targets → (dx, dy, dw, dh), torchvision's
    ``BoxCoder`` (weights (1, 1, 1, 1) for the RPN, (10, 10, 5, 5) for the
    box head)."""
    wa = anchors[..., 2] - anchors[..., 0]
    ha = anchors[..., 3] - anchors[..., 1]
    xa = anchors[..., 0] + 0.5 * wa
    ya = anchors[..., 1] + 0.5 * ha
    wg = gt[..., 2] - gt[..., 0]
    hg = gt[..., 3] - gt[..., 1]
    xg = gt[..., 0] + 0.5 * wg
    yg = gt[..., 1] + 0.5 * hg
    wx, wy, ww, wh = weights
    return torch.stack([
        wx * (xg - xa) / (wa + EPS),
        wy * (yg - ya) / (ha + EPS),
        ww * torch.log(wg.clamp(min=EPS) / (wa + EPS)),
        wh * torch.log(hg.clamp(min=EPS) / (ha + EPS)),
    ], dim=-1)


def decode_deltas(anchors: torch.Tensor, deltas: torch.Tensor,
                  weights=(1.0, 1.0, 1.0, 1.0),
                  clamp: float = 4.135166556742356) -> torch.Tensor:
    """The inverse of :func:`encode_deltas`; dw and dh are clamped from
    above at ``clamp`` = log(1000/16), as torchvision does."""
    wa = anchors[..., 2] - anchors[..., 0]
    ha = anchors[..., 3] - anchors[..., 1]
    xa = anchors[..., 0] + 0.5 * wa
    ya = anchors[..., 1] + 0.5 * ha
    wx, wy, ww, wh = weights
    dx = deltas[..., 0] / wx
    dy = deltas[..., 1] / wy
    dw = (deltas[..., 2] / ww).clamp(max=clamp)
    dh = (deltas[..., 3] / wh).clamp(max=clamp)
    cx = dx * wa + xa
    cy = dy * ha + ya
    w = torch.exp(dw) * wa
    h = torch.exp(dh) * ha
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h,
                        cx + 0.5 * w, cy + 0.5 * h], dim=-1)


def iou_matrix(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU (N, M) f32 of xyxy boxes (N, 4) × (M, 4), any N and M.
    Through the custom op ``heltondetection::iou_matrix``: on CUDA tensors
    it launches the ``iou_matrix`` kernel, on CPU tensors it runs the plain
    :func:`box_iou_matrix`."""
    return kernel_ops.iou_matrix(boxes1.float().contiguous(),
                                 boxes2.float().contiguous())
