"""YOLOv5 anchors and grids; counterpart of heltondetection_tpu/ops/anchors.py.

The RPN anchor functions come with the FasterRCNN slice.
"""

from __future__ import annotations

from typing import Tuple

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
