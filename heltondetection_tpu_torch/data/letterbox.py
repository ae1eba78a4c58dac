"""Letterbox resize+pad; counterpart of ``letterbox_np`` in
heltondetection_tpu/data/augment.py, without OpenCV.

The resize is PyTorch's bilinear (half-pixel centres, no antialias), the
geometry of cv2's INTER_LINEAR. cv2 interpolates uint8 in fixed point, so
the two may differ by one grey level; ``scale`` and the pads are identical.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def resize_bilinear(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """(H, W, C) image → (h, w, C), same dtype (uint8 rounds and clips)."""
    t = torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)[None]
    y = F.interpolate(t.float(), size=(h, w), mode="bilinear",
                      align_corners=False, antialias=False)[0]
    if img.dtype == np.uint8:
        y = y.round().clamp(0, 255)
    return y.permute(1, 2, 0).numpy().astype(img.dtype)


def letterbox_np(img: np.ndarray, boxes: np.ndarray, dst: int,
                 pad_value: int = 114) -> Tuple[np.ndarray, np.ndarray, Dict]:
    """Aspect-preserving resize+pad to (dst, dst). Returns (img, boxes, meta)
    with meta = {scale, pad_x, pad_y}."""
    h, w = img.shape[:2]
    scale = min(dst / h, dst / w)
    nw, nh = int(round(w * scale)), int(round(h * scale))
    if (nw, nh) != (w, h):
        img = resize_bilinear(img, nh, nw)
    top = (dst - nh) // 2
    left = (dst - nw) // 2
    out = np.full((dst, dst, 3), pad_value, img.dtype)
    out[top:top + nh, left:left + nw] = img
    if len(boxes):
        boxes = boxes * scale + np.array([left, top, left, top], np.float32)
    return out, boxes.astype(np.float32), {
        "scale": scale, "pad_x": float(left), "pad_y": float(top)}
