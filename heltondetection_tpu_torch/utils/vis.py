"""Visualization; counterpart of heltondetection_tpu/utils/vis.py: labeled
boxes, and the per-level heat-map and score-map panels of ``--mode test``.

``draw_boxes`` renders with OpenCV, imported where it is used. The panels
need no OpenCV: the colour map is a 256-entry table equal to cv2's
``COLORMAP_JET``, the resize is the port's bilinear
(``data/letterbox.py:resize_bilinear``, the geometry of cv2's INTER_LINEAR,
within one grey level of it), and :func:`write_png` writes them with zlib.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional, Sequence

import numpy as np

from heltondetection_tpu_torch.data.letterbox import resize_bilinear

# cv2.applyColorMap(np.arange(256, dtype=np.uint8), cv2.COLORMAP_JET), as
# RGB rows, 256 x 3 bytes
_JET = np.frombuffer(bytes.fromhex(
    "00008000008400008800008c00009000009400009800009c0000a00000a40000a80000ac"
    "0000b00000b40000b80000bc0000c00000c40000c80000cc0000d00000d40000d80000dc"
    "0000e00000e40000e80000ec0000f00000f40000f80000fc0000ff0004ff0008ff000cff"
    "0010ff0014ff0018ff001cff0020ff0024ff0028ff002cff0030ff0034ff0038ff003cff"
    "0040ff0044ff0048ff004cff0050ff0054ff0058ff005cff0060ff0064ff0068ff006cff"
    "0070ff0074ff0078ff007cff0080ff0084ff0088ff008cff0090ff0094ff0098ff009cff"
    "00a0ff00a4ff00a8ff00acff00b0ff00b4ff00b8ff00bcff00c0ff00c4ff00c8ff00ccff"
    "00d0ff00d4ff00d8ff00dcff00e0ff00e4ff00e8ff00ecff00f0ff00f4ff00f8ff00fcff"
    "02fffe06fffa0afff60efff212ffee16ffea1affe61effe222ffde26ffda2affd62effd2"
    "32ffce36ffca3affc63effc242ffbe46ffba4affb64effb252ffae56ffaa5affa65effa2"
    "62ff9e66ff9a6aff966eff9272ff8e76ff8a7aff867eff8282ff7e86ff7a8aff768eff72"
    "92ff6e96ff6a9aff669eff62a2ff5ea6ff5aaaff56aeff52b2ff4eb6ff4abaff46beff42"
    "c2ff3ec6ff3acaff36ceff32d2ff2ed6ff2adaff26deff22e2ff1ee6ff1aeaff16eeff12"
    "f2ff0ef6ff0afaff06feff01fffc00fff800fff400fff000ffec00ffe800ffe400ffe000"
    "ffdc00ffd800ffd400ffd000ffcc00ffc800ffc400ffc000ffbc00ffb800ffb400ffb000"
    "ffac00ffa800ffa400ffa000ff9c00ff9800ff9400ff9000ff8c00ff8800ff8400ff8000"
    "ff7c00ff7800ff7400ff7000ff6c00ff6800ff6400ff6000ff5c00ff5800ff5400ff5000"
    "ff4c00ff4800ff4400ff4000ff3c00ff3800ff3400ff3000ff2c00ff2800ff2400ff2000"
    "ff1c00ff1800ff1400ff1000ff0c00ff0800ff0400ff0000fc0000f80000f40000f00000"
    "ec0000e80000e40000e00000dc0000d80000d40000d00000cc0000c80000c40000c00000"
    "bc0000b80000b40000b00000ac0000a80000a40000a000009c0000980000940000900000"
    "8c0000880000840000800000"
), np.uint8).reshape(256, 3)


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


def write_png(path: str, img: np.ndarray) -> None:
    """Write an RGB (H, W, 3) uint8 image as a PNG (8 bits a sample, no
    filter, zlib level 6)."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"write_png takes (H, W, 3) uint8, got "
                         f"{img.shape} {img.dtype}")
    h, w = img.shape[:2]

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data +
                struct.pack(">I", zlib.crc32(tag + data)))

    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img.reshape(h, -1)], axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0,
                                           0)))
        f.write(chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(chunk(b"IEND", b""))


def _colorize(m: np.ndarray, size) -> np.ndarray:
    """A map (h, w) → its JET colouring, min to max, resized to ``size``
    (W, H): (H, W, 3) uint8 RGB."""
    m = m - m.min()
    m = m / (m.max() + 1e-9)
    cm = _JET[(m * 255).astype(np.uint8)]
    return resize_bilinear(cm, size[1], size[0])


def _overlay(img: np.ndarray, m: np.ndarray, alpha: float) -> np.ndarray:
    h, w = img.shape[:2]
    hm = _colorize(m, (w, h))
    return (img * (1 - alpha) + hm * alpha).astype(np.uint8)


def feature_heatmaps(img: np.ndarray, feats: Sequence[np.ndarray],
                     alpha: float = 0.5) -> np.ndarray:
    """Per-level mean-activation heat maps over the image, tiled across:
    feats (H_l, W_l, C) each → (H, W·levels, 3) uint8."""
    return np.concatenate([
        _overlay(img, np.abs(np.asarray(f)).mean(axis=-1), alpha)
        for f in feats], axis=1)


def objectness_maps(img: np.ndarray, raw_levels: Sequence[np.ndarray],
                    num_classes: int, num_anchors: int = 3,
                    alpha: float = 0.5, kind: str = "obj") -> np.ndarray:
    """Per-level objectness maps (``kind="obj"``, the best anchor's σ(obj))
    or best class-score maps (else) of raw YOLO head maps (H, W,
    A·(5+C)), tiled across."""

    def sigmoid(x):
        return 1.0 / (1.0 + np.exp(-x))

    panels = []
    for raw in raw_levels:
        r = np.asarray(raw)
        hh, ww = r.shape[:2]
        r = r.reshape(hh, ww, num_anchors, 5 + num_classes)
        if kind == "obj":
            m = sigmoid(r[..., 4]).max(axis=-1)
        else:
            m = (sigmoid(r[..., 4:5]) * sigmoid(r[..., 5:])).max(axis=(-1, -2))
        panels.append(_overlay(img, m, alpha))
    return np.concatenate(panels, axis=1)


def rpn_objectness_maps(img: np.ndarray, level_hw: Sequence,
                        obj_concat: np.ndarray, a_per_cell: int = 3,
                        alpha: float = 0.5) -> np.ndarray:
    """Per-level RPN objectness panels of a FasterRCNN, the two-stage
    counterpart of :func:`objectness_maps`: ``obj_concat`` (N,) are the RPN
    logits level-major (the RPN head's layout), ``level_hw`` [(H_l, W_l),
    ...]; each cell shows σ of its best anchor."""
    panels = []
    start = 0
    for hh, ww in level_hw:
        n = hh * ww * a_per_cell
        lv = np.asarray(obj_concat[start:start + n]).reshape(hh, ww,
                                                             a_per_cell)
        start += n
        panels.append(_overlay(img, 1.0 / (1.0 + np.exp(-lv.max(axis=-1))),
                               alpha))
    return np.concatenate(panels, axis=1)


def rcnn_class_score_maps(img: np.ndarray, level_hw: Sequence,
                          strides: Sequence[int], rois: np.ndarray,
                          probs: np.ndarray, valid: np.ndarray,
                          num_pooled: int = 4, canonical_level: int = 2,
                          canonical_size: float = 224.0,
                          alpha: float = 0.5) -> np.ndarray:
    """The box head's class-score panels of a FasterRCNN: each proposal's
    best foreground score, splatted (elementwise max) over its footprint on
    the level RoIAlign pooled it from (torchvision's level rule, as
    ``ops/roi_align.py``); levels that are not pooled (P6) stay empty.

    ``rois`` (R, 4) xyxy input pixels; ``probs`` (R, nc) foreground softmax
    or (R,) scores; ``valid`` (R,)."""
    rois = np.asarray(rois, np.float64).reshape(-1, 4)
    score = np.asarray(probs, np.float64)
    if score.ndim == 2:
        score = score.max(axis=-1)
    score = score * np.asarray(valid, np.float64).reshape(-1)
    bw = np.maximum(rois[:, 2] - rois[:, 0], 0.0)
    bh = np.maximum(rois[:, 3] - rois[:, 1], 0.0)
    lvl = np.clip(np.floor(canonical_level +
                           np.log2(np.sqrt(bw * bh) / canonical_size + 1e-8)),
                  0, num_pooled - 1).astype(np.int64)
    panels = []
    for li, (hh, ww) in enumerate(level_hw):
        m = np.zeros((hh, ww), np.float64)
        if li < num_pooled:
            s = float(strides[li])
            for i in np.nonzero((lvl == li) & (score > 0))[0]:
                x1 = int(np.clip(np.floor(rois[i, 0] / s), 0, ww - 1))
                y1 = int(np.clip(np.floor(rois[i, 1] / s), 0, hh - 1))
                x2 = int(np.clip(np.ceil(rois[i, 2] / s), x1 + 1, ww))
                y2 = int(np.clip(np.ceil(rois[i, 3] / s), y1 + 1, hh))
                reg = m[y1:y2, x1:x2]
                np.maximum(reg, score[i], out=reg)
        panels.append(_overlay(img, m, alpha))
    return np.concatenate(panels, axis=1)
