"""Box geometry; counterpart of heltondetection_tpu/ops/boxes.py.

``xyxy`` is (x1, y1, x2, y2) in absolute pixels, ``cxcywh`` (cx, cy, w, h),
``xywh`` COCO's (x_min, y_min, w, h). Every function takes any leading batch
dims with the box dim last. ``bbox_iou``, the delta codecs and
``box_ioa_matrix`` come with the training and FasterRCNN slices.

:func:`iou_matrix` is the public op of the ``iou_matrix`` CUDA kernel
(``csrc/iou_matrix.cu``, counterpart of ``iou_matrix_pallas``); its plain
version is :func:`box_iou_matrix`.
"""

from __future__ import annotations

import torch

from heltondetection_tpu_torch.kernels import iou as iou_kernel

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


def box_area(b: torch.Tensor) -> torch.Tensor:
    """Area of xyxy boxes; negative extents clamp to 0."""
    return ((b[..., 2] - b[..., 0]).clamp(min=0.0) *
            (b[..., 3] - b[..., 1]).clamp(min=0.0))


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


def iou_matrix(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU (N, M) f32 of xyxy boxes (N, 4) × (M, 4), any N and M.
    On CUDA tensors this launches the ``iou_matrix`` kernel; on CPU
    tensors it runs the plain :func:`box_iou_matrix`."""
    if boxes1.device.type == "cpu" and boxes2.device.type == "cpu":
        return box_iou_matrix(boxes1.float(), boxes2.float())
    return iou_kernel.iou_matrix(boxes1.float().contiguous(),
                                 boxes2.float().contiguous())
