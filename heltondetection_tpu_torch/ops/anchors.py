"""YOLOv5 anchors and grids, and FasterRCNN's RPN anchors; counterpart of
heltondetection_tpu/ops/anchors.py.

The RPN anchors follow torchvision's ``AnchorGenerator``: per cell, one
anchor per (size, ratio) with h = size·√ratio and w = size/√ratio, centred
at (x·stride, y·stride) with no half-cell offset, in (h, w, a) row order.
They are built in numpy, as the reference builds them.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

# YOLOv5 v6.1 anchors in input pixels, per level (strides 8/16/32)
YOLOV5_ANCHORS = (
    ((10, 13), (16, 30), (33, 23)),      # P3 / stride 8
    ((30, 61), (62, 45), (59, 119)),     # P4 / stride 16
    ((116, 90), (156, 198), (373, 326)), # P5 / stride 32
)
YOLOV5_STRIDES = (8, 16, 32)


def normalize_anchors(anchors) -> Tuple[Tuple[Tuple[float, float], ...], ...]:
    """Config/user anchors (lists, arrays, tuples) → the canonical nested-tuple
    form. Hashable, because the decode tables are cached on the anchor values
    (ops/postprocess.py)."""
    out = tuple(tuple((float(w), float(h)) for w, h in level)
                for level in anchors)
    for level in out:
        if len(level) != len(out[0]):
            raise ValueError(f"ragged anchors per level: {out}")
    return out


def yolo_grid(h: int, w: int, device=None) -> torch.Tensor:
    """(h, w, 2) float32 grid of cell indices (x, y)."""
    ys = torch.arange(h, dtype=torch.float32, device=device)
    xs = torch.arange(w, dtype=torch.float32, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1)


def yolo_level_anchors(level: int, anchors=YOLOV5_ANCHORS) -> torch.Tensor:
    """(A, 2) anchor (w, h) in pixels of one pyramid level."""
    return torch.tensor(anchors[level], dtype=torch.float32)


def rpn_cell_anchors(sizes: Sequence[float],
                     ratios: Sequence[float]) -> np.ndarray:
    """Zero-centred xyxy anchors of one cell, (len(sizes)·len(ratios), 4)
    float32, sizes outer and ratios inner."""
    out = []
    for s in sizes:
        for r in ratios:
            h = s * np.sqrt(r)
            w = s / np.sqrt(r)
            out.append([-w / 2, -h / 2, w / 2, h / 2])
    return np.asarray(out, np.float32)


def rpn_level_anchors(feat_h: int, feat_w: int, stride: int,
                      sizes: Sequence[float],
                      ratios: Sequence[float] = (0.5, 1.0, 2.0)) -> np.ndarray:
    """Every anchor of one pyramid level, (feat_h·feat_w·A, 4) float32 xyxy
    in input pixels, rows in (h, w, a) order."""
    cell = rpn_cell_anchors(sizes, ratios)
    xs = np.arange(feat_w, dtype=np.float32) * stride
    ys = np.arange(feat_h, dtype=np.float32) * stride
    cx, cy = np.meshgrid(xs, ys)
    shifts = np.stack([cx, cy, cx, cy], axis=-1).reshape(-1, 1, 4)
    return (shifts + cell[None]).reshape(-1, 4).astype(np.float32)


def rpn_pyramid_anchors(img_size: int,
                        strides: Sequence[int] = (4, 8, 16, 32, 64),
                        base_sizes: Sequence[float] = (32, 64, 128, 256, 512),
                        ratios: Sequence[float] = (0.5, 1.0, 2.0),
                        ) -> Tuple[np.ndarray, Tuple[int, ...]]:
    """The anchors of every level of a square input, concatenated low
    stride first, and each level's count: one size per level times the
    ratios (torchvision's FPN default)."""
    per_level = [rpn_level_anchors(img_size // s, img_size // s, s, (size,),
                                   ratios)
                 for s, size in zip(strides, base_sizes)]
    return (np.concatenate(per_level, axis=0),
            tuple(a.shape[0] for a in per_level))
