"""Labeled-box rendering; counterpart of ``draw_boxes`` in
heltondetection_tpu/utils/vis.py. Host-side OpenCV and numpy; OpenCV is
imported where it is used, so importing this module does not need it. The
per-level heat-map panels come with ``run_test``."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def _color(i: int):
    rng = np.random.default_rng(i * 7919 + 13)
    c = rng.integers(64, 255, 3)
    return int(c[0]), int(c[1]), int(c[2])


def draw_boxes(img: np.ndarray, boxes_xyxy: np.ndarray, scores: np.ndarray,
               classes: np.ndarray, class_names: Optional[Sequence[str]] = None,
               thickness: int = 2) -> np.ndarray:
    """Draw class+score labeled boxes (RGB in, RGB out)."""
    import cv2
    out = img.copy()
    for b, s, c in zip(boxes_xyxy, scores, classes):
        c = int(c)
        x1, y1, x2, y2 = (int(round(v)) for v in b)
        color = _color(c)
        cv2.rectangle(out, (x1, y1), (x2, y2), color, thickness)
        name = class_names[c] if class_names and 0 <= c < len(class_names) \
            else str(c)
        label = f"{name} {float(s):.2f}"
        (tw, th), _ = cv2.getTextSize(label, cv2.FONT_HERSHEY_SIMPLEX,
                                      0.5, 1)
        cv2.rectangle(out, (x1, max(y1 - th - 4, 0)), (x1 + tw + 2, y1),
                      color, -1)
        cv2.putText(out, label, (x1 + 1, y1 - 3), cv2.FONT_HERSHEY_SIMPLEX,
                    0.5, (255, 255, 255), 1, cv2.LINE_AA)
    return out
