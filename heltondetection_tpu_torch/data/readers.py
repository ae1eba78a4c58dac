"""Image reading; counterpart of ``imread_rgb`` in
heltondetection_tpu/data/readers.py. The dataset readers (COCO, YOLO, DOTA,
VOC, VisDrone) come with the data slice. OpenCV is imported where it is
used, so importing this module does not need it."""

from __future__ import annotations

import numpy as np


def imread_rgb(path: str) -> np.ndarray:
    """An image file → (H, W, 3) uint8 RGB."""
    import cv2
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
