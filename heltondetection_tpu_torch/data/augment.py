"""Host-side augmentation: mosaic-4, random affine, HSV, flip, mixup,
letterbox, and the host half of the on-device augmentation
(:class:`DeviceAugPipeline`); counterpart of
heltondetection_tpu/data/augment.py.

Every op draws from an explicit ``np.random.Generator`` seeded per (seed,
epoch, index), in the reference's order, so the same seed gives the same
mosaic coins and offsets, affine parameters, flips and mixup partners, and
boxes, classes and masks equal to the reference's to float rounding.

No OpenCV: the reference's cv2 calls are rewritten in numpy and CPU torch.
The resize is torch's bilinear (``data.letterbox``), the warp a bilinear
``grid_sample`` with a constant border, both in floating point where cv2
interpolates in fixed point, so pixels may differ from the reference's by a
few grey levels. The RGB↔HSV conversion follows cv2's uint8 definition (H
in [0, 180)): forward with its fixed-point tables, equal to cv2; back in
cv2's scalar float32 arithmetic, equal to cv2 on narrow rows and within 1
grey level of the vectorized path it takes on wide ones. The rotation
matrix is ``cv2.getRotationMatrix2D``'s formula.
"""

from __future__ import annotations

import logging
import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from heltondetection_tpu_torch.data.letterbox import (letterbox_np,
                                                      resize_bilinear)
from heltondetection_tpu_torch.data.readers import drop_ignore_boxes

_HSV_SHIFT = 12
_I = np.arange(1, 256, dtype=np.float64)
# cv2's RGB2HSV_b division tables (saturate_cast rounds to nearest)
_SDIV = torch.from_numpy(np.concatenate(
    [[0], np.rint((255 << _HSV_SHIFT) / _I)]).astype(np.int32))
_HDIV = torch.from_numpy(np.concatenate(
    [[0], np.rint((180 << _HSV_SHIFT) / (6.0 * _I))]).astype(np.int32))
# HSV2RGB sector → which of (v, p, q, t) is each of (b, g, r)
_SECTORS = torch.tensor([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1],
                         [0, 1, 3], [2, 1, 0]])


def _rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) uint8 RGB → (..., 3) int32 HSV, cv2's RGB2HSV_b."""
    x = rgb.int()
    r, g, b = x.unbind(-1)
    v = x.amax(-1)
    diff = v - x.amin(-1)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    h = torch.where(v == r, g - b,
                    torch.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + half) >> _HSV_SHIFT
    h = torch.where(h < 0, h + 180, h)
    return torch.stack([h, s, v], -1)


def _hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    """(..., 3) HSV (H in [0, 180)) → uint8 RGB, cv2's HSV2RGB_b: float32
    arithmetic, the two ``1 − s·x`` terms each with one rounding (cv2's
    fused multiply-add; a float64 product rounded once to float32)."""
    f = hsv.float()
    h = f[..., 0] * np.float32(6.0 / 180.0)
    s = f[..., 1] * np.float32(1.0 / 255.0)
    v = f[..., 2] * np.float32(1.0 / 255.0)
    sector = torch.floor(h)
    h = h - sector
    sd = s.double()
    tab = torch.stack([v, v * (1.0 - s), v * (1.0 - sd * h.double()).float(),
                       v * (1.0 - sd * (1.0 - h).double()).float()], -1)
    bgr = torch.gather(tab, -1, _SECTORS[sector.long() % 6])
    bgr = torch.where((s == 0)[..., None], v[..., None], bgr)
    return (bgr.flip(-1) * 255.0).round().clamp(0, 255).to(torch.uint8)


def rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """uint8 RGB → uint8 HSV with H in [0, 180), equal to
    ``cv2.cvtColor(img, cv2.COLOR_RGB2HSV)``."""
    return _rgb_to_hsv(torch.from_numpy(img)).to(torch.uint8).numpy()


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """uint8 HSV (H in [0, 180)) → uint8 RGB, as
    ``cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)`` (see the module docstring)."""
    return _hsv_to_rgb(torch.from_numpy(hsv)).numpy()


def hsv_params(rng: np.random.Generator, h_gain: float = 0.015,
               s_gain: float = 0.7, v_gain: float = 0.4) -> np.ndarray:
    """HSV jitter gain draws."""
    return rng.uniform(-1, 1, 3) * [h_gain, s_gain, v_gain] + 1


def random_hsv(img: np.ndarray, rng: np.random.Generator,
               h_gain: float = 0.015, s_gain: float = 0.7,
               v_gain: float = 0.4) -> np.ndarray:
    """Ultralytics-style HSV jitter through lookup tables (uint8 in and
    out)."""
    r = hsv_params(rng, h_gain, s_gain, v_gain)
    x = np.arange(256)
    luts = torch.from_numpy(np.stack([
        ((x * r[0]) % 180).astype(np.uint8),
        np.clip(x * r[1], 0, 255).astype(np.uint8),
        np.clip(x * r[2], 0, 255).astype(np.uint8)]).astype(np.int64))
    hsv = _rgb_to_hsv(torch.from_numpy(img))
    hsv = torch.stack([luts[c][hsv[..., c]] for c in range(3)], -1)
    return _hsv_to_rgb(hsv).numpy()


def flip_boxes(boxes: np.ndarray, w: int) -> np.ndarray:
    """Box transform of :func:`horizontal_flip`."""
    if len(boxes):
        boxes = boxes.copy()
        x1 = boxes[:, 0].copy()
        boxes[:, 0] = w - boxes[:, 2]
        boxes[:, 2] = w - x1
    return boxes


def horizontal_flip(img: np.ndarray, boxes: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
    return np.ascontiguousarray(img[:, ::-1]), flip_boxes(boxes, img.shape[1])


def mosaic_placement(i: int, nw: int, nh: int, xc: int, yc: int, s: int
                     ) -> Tuple[int, int, int, int, int, int]:
    """Quadrant placement of tile ``i``: (x1a, y1a, x2a, y2a, x1b, y1b), the
    canvas rect and the matching origin in the resized tile."""
    if i == 0:   # top-left quadrant, anchored at (xc, yc)
        x1a, y1a = max(xc - nw, 0), max(yc - nh, 0)
        x2a, y2a = xc, yc
    elif i == 1:  # top-right
        x1a, y1a = xc, max(yc - nh, 0)
        x2a, y2a = min(xc + nw, 2 * s), yc
    elif i == 2:  # bottom-left
        x1a, y1a = max(xc - nw, 0), yc
        x2a, y2a = xc, min(yc + nh, 2 * s)
    else:         # bottom-right
        x1a, y1a = xc, yc
        x2a, y2a = min(xc + nw, 2 * s), min(yc + nh, 2 * s)
    cw, ch = x2a - x1a, y2a - y1a
    x1b = nw - cw if i in (0, 2) else 0
    y1b = nh - ch if i in (0, 1) else 0
    return x1a, y1a, x2a, y2a, x1b, y1b


def mosaic_boxes(samples: Sequence[Dict], s: int, xc: int, yc: int,
                 min_box: float = 2.0) -> Tuple[np.ndarray, np.ndarray]:
    """Box and class transform of :func:`mosaic4`."""
    all_boxes, all_cls = [], []
    for i, sample in enumerate(samples[:4]):
        boxes = sample["boxes"]
        h, w = sample["image"].shape[:2]
        scale = min(s / h, s / w)
        nw, nh = int(round(w * scale)), int(round(h * scale))
        x1a, y1a, _, _, x1b, y1b = mosaic_placement(i, nw, nh, xc, yc, s)
        if len(boxes):
            b = boxes * scale
            b = b + np.array([x1a - x1b, y1a - y1b, x1a - x1b, y1a - y1b],
                             np.float32)
            all_boxes.append(b)
            all_cls.append(sample["classes"])
    if all_boxes:
        boxes = np.concatenate(all_boxes, 0)
        classes = np.concatenate(all_cls, 0)
    else:
        boxes = np.zeros((0, 4), np.float32)
        classes = np.zeros((0,), np.int32)
    off = s // 2
    if len(boxes):
        boxes -= off
        boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, s)
        boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, s)
        keep = ((boxes[:, 2] - boxes[:, 0]) > min_box) & \
               ((boxes[:, 3] - boxes[:, 1]) > min_box)
        boxes, classes = boxes[keep], classes[keep]
    return boxes.astype(np.float32), classes


def mosaic4(samples: Sequence[Dict], dst: int, rng: np.random.Generator,
            pad_value: int = 114, min_box: float = 2.0
            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """4-image mosaic (YOLOv5): a random centre on a 2dst canvas, each
    quadrant filled with one letterbox-scaled image, then the centre crop
    to dst. Returns (img (dst, dst, 3), boxes xyxy, classes); boxes clipped
    below ``min_box`` px are dropped."""
    s = dst
    yc = int(rng.uniform(0.5 * s, 1.5 * s))
    xc = int(rng.uniform(0.5 * s, 1.5 * s))
    off = s // 2
    canvas = np.full((s, s, 3), pad_value, np.uint8)   # the crop, directly
    for i, sample in enumerate(samples[:4]):
        img = sample["image"]
        h, w = img.shape[:2]
        scale = min(s / h, s / w)
        nw, nh = int(round(w * scale)), int(round(h * scale))
        x1a, y1a, x2a, y2a, x1b, y1b = mosaic_placement(i, nw, nh, xc, yc, s)
        # the part of the quadrant inside the crop window [off, off + s)
        cx1, cy1 = max(x1a, off), max(y1a, off)
        cx2, cy2 = min(x2a, off + s), min(y2a, off + s)
        if cx2 <= cx1 or cy2 <= cy1:
            continue
        if (nw, nh) != (w, h):
            img = resize_bilinear(img, nh, nw)
        canvas[cy1 - off:cy2 - off, cx1 - off:cx2 - off] = img[
            y1b + cy1 - y1a:y1b + cy2 - y1a, x1b + cx1 - x1a:x1b + cx2 - x1a]
    boxes, classes = mosaic_boxes(samples, s, xc, yc, min_box)
    return canvas, boxes, classes


def rotation_matrix_2d(center: Tuple[float, float], angle: float,
                       scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D``: (2, 3) float64, angle in degrees."""
    a = math.radians(angle)
    alpha, beta = scale * math.cos(a), scale * math.sin(a)
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def affine_params(rng: np.random.Generator, w: int, h: int, *,
                  degrees: float = 0.0, translate: float = 0.1,
                  scale: float = 0.5, shear: float = 0.0
                  ) -> Tuple[np.ndarray, float]:
    """Random-affine draws, in the reference's order. Returns (2x3 forward
    matrix, scale)."""
    a = rng.uniform(-degrees, degrees)
    s = rng.uniform(1 - scale, 1 + scale)
    rot = rotation_matrix_2d((w / 2, h / 2), a, s)
    rot[0, 2] += rng.uniform(0.5 - translate, 0.5 + translate) * w - w / 2
    rot[1, 2] += rng.uniform(0.5 - translate, 0.5 + translate) * h - h / 2
    if shear:
        sh_x = np.tan(np.radians(rng.uniform(-shear, shear)))
        sh_y = np.tan(np.radians(rng.uniform(-shear, shear)))
        shear_m = np.array([[1, sh_x, 0], [sh_y, 1, 0]], np.float64)
        rot = shear_m @ np.vstack([rot, [0, 0, 1]])
    return rot, s


def affine_boxes(boxes: np.ndarray, classes: np.ndarray, rot: np.ndarray,
                 s: float, w: int, h: int, min_box: float = 2.0):
    """Box transform of :func:`random_affine`: the 4 corners mapped, their
    axis-aligned hull, then the size and area-ratio candidate filter."""
    if len(boxes) == 0:
        return boxes, classes
    n = len(boxes)
    corners = np.ones((n * 4, 3))
    corners[:, :2] = boxes[:, [0, 1, 2, 1, 2, 3, 0, 3]].reshape(n * 4, 2)
    warped = (corners @ rot.T).reshape(n, 8)
    xs = warped[:, [0, 2, 4, 6]]
    ys = warped[:, [1, 3, 5, 7]]
    new = np.stack([xs.min(1), ys.min(1), xs.max(1), ys.max(1)], 1)
    new[:, [0, 2]] = new[:, [0, 2]].clip(0, w)
    new[:, [1, 3]] = new[:, [1, 3]].clip(0, h)
    w_new = new[:, 2] - new[:, 0]
    h_new = new[:, 3] - new[:, 1]
    w_old = (boxes[:, 2] - boxes[:, 0]) * s
    h_old = (boxes[:, 3] - boxes[:, 1]) * s
    ar = np.maximum(w_new / (h_new + 1e-9), h_new / (w_new + 1e-9))
    keep = (w_new > min_box) & (h_new > min_box) & \
           (w_new * h_new / (w_old * h_old + 1e-9) > 0.1) & (ar < 100)
    return new[keep].astype(np.float32), classes[keep]


def warp_affine(img: np.ndarray, m: np.ndarray, w: int, h: int,
                border: int = 114) -> np.ndarray:
    """``cv2.warpAffine(img, m, (w, h), borderValue=(border,) * 3)`` in
    floating point: each output pixel samples the input bilinearly at
    ``m⁻¹ · (x, y, 1)`` (pixel centres at integers), taps outside the image
    reading ``border``."""
    a, b, c = m[0]
    d, e, f = m[1]
    det = a * e - b * d
    det = 1.0 / det if det else 0.0
    ia, ib, id_, ie = e * det, -b * det, -d * det, a * det
    ic, if_ = -ia * c - ib * f, -id_ * c - ie * f
    hi, wi = img.shape[:2]
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float64),
                            torch.arange(w, dtype=torch.float64),
                            indexing="ij")
    sx = ia * xs + ib * ys + ic
    sy = id_ * xs + ie * ys + if_
    grid = torch.stack([(2 * sx + 1) / wi - 1, (2 * sy + 1) / hi - 1],
                       -1).float()[None]
    src = torch.from_numpy(img).permute(2, 0, 1)[None].float() - border
    out = F.grid_sample(src, grid, mode="bilinear", padding_mode="zeros",
                        align_corners=False)[0] + border
    return out.round().clamp(0, 255).permute(1, 2, 0).to(torch.uint8).numpy()


def random_affine(img: np.ndarray, boxes: np.ndarray, classes: np.ndarray,
                  rng: np.random.Generator, *, degrees: float = 0.0,
                  translate: float = 0.1, scale: float = 0.5,
                  shear: float = 0.0, pad_value: int = 114,
                  min_box: float = 2.0):
    """YOLOv5-style random affine (rotate, scale, translate, shear) after
    mosaic; boxes through their 4 corners' hull, then filtered."""
    h, w = img.shape[:2]
    rot, s = affine_params(rng, w, h, degrees=degrees, translate=translate,
                           scale=scale, shear=shear)
    out = warp_affine(img, rot, w, h, pad_value)
    boxes, classes = affine_boxes(boxes, classes, rot, s, w, h, min_box)
    return out, boxes, classes


def mixup_blend(a: np.ndarray, b: np.ndarray, r: float) -> np.ndarray:
    """Pixel blend of two augmented uint8 images (Ultralytics mixup:
    truncate after the float mix)."""
    return (a.astype(np.float32) * r +
            b.astype(np.float32) * (1.0 - r)).astype(np.uint8)


def mixup_draws(rng: np.random.Generator, mixup_p: float, n: int):
    """The mixup draws, in the reference's order: coin, partner index,
    beta(32, 32) weight. Returns (partner or None, r). Drawn only when the
    knob is on, so ``mixup_p=0`` leaves the stream as it was."""
    if mixup_p <= 0.0 or n < 2:
        return None, 1.0
    mix = rng.uniform() < mixup_p
    j = int(rng.integers(0, n))
    r = float(rng.beta(32.0, 32.0))
    return (j if mix else None), r


# seed-sequence tag of a mixup partner's stream, apart from the same
# index's own (seed, epoch, idx) stream
MIXUP_STREAM_TAG = 1


class TrainPipeline:
    """Per-sample train augmentation: mosaic(p) → affine → HSV → flip(p)
    (letterbox on the non-mosaic path) → optional mixup(p) with a second
    fully augmented sample → cxcywh targets in input pixels, padded to
    ``max_boxes`` with a mask."""

    _mixup_trunc_warned = False  # once-per-process truncation notice

    def __init__(self, dataset, img_size: int, *, mosaic_p: float = 0.5,
                 hsv: bool = True, flip_p: float = 0.5, max_boxes: int = 128,
                 seed: int = 0, affine: bool = True,
                 affine_scale: float = 0.5, affine_translate: float = 0.1,
                 degrees: float = 0.0, mixup_p: float = 0.0):
        self.ds = dataset
        self.img_size = img_size
        self.mosaic_p = mosaic_p
        self.hsv = hsv
        self.flip_p = flip_p
        self.max_boxes = max_boxes
        self.seed = seed
        self.affine = affine
        self.affine_scale = affine_scale
        self.affine_translate = affine_translate
        self.degrees = degrees
        self.mixup_p = mixup_p

    def __len__(self):
        return len(self.ds)

    def _augment_one(self, idx: int, rng: np.random.Generator
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """One fully augmented (img, boxes, classes) drawing from ``rng``."""
        s = self.img_size
        if rng.uniform() < self.mosaic_p and len(self.ds) >= 4:
            others = rng.integers(0, len(self.ds), 3)
            samples = [drop_ignore_boxes(self.ds.load(idx))] + [
                drop_ignore_boxes(self.ds.load(int(j))) for j in others]
            img, boxes, classes = mosaic4(samples, s, rng)
            if self.affine:
                img, boxes, classes = random_affine(
                    img, boxes, classes, rng, degrees=self.degrees,
                    translate=self.affine_translate,
                    scale=self.affine_scale)
        else:
            raw = drop_ignore_boxes(self.ds.load(idx))
            img, boxes, _ = letterbox_np(raw["image"], raw["boxes"], s)
            classes = raw["classes"]
        if self.hsv:
            img = random_hsv(img, rng)
        if rng.uniform() < self.flip_p:
            img, boxes = horizontal_flip(img, boxes)
        return img, np.asarray(boxes, np.float32).reshape(-1, 4), \
            np.asarray(classes).reshape(-1)

    def sample(self, idx: int, epoch: int = 0) -> Dict:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch, idx]))
        partner, r = mixup_draws(rng, self.mixup_p, len(self.ds))
        img, boxes, classes = self._augment_one(idx, rng)
        if partner is not None:
            # blend with a second fully augmented sample (its own stream)
            # and take the union of the labels
            rng2 = np.random.default_rng(np.random.SeedSequence(
                [self.seed, epoch, partner, MIXUP_STREAM_TAG]))
            img2, boxes2, classes2 = self._augment_one(partner, rng2)
            img = mixup_blend(img, img2, r)
            boxes = np.concatenate([boxes, boxes2], axis=0)
            classes = np.concatenate([classes, classes2], axis=0)
            if len(classes) > self.max_boxes:
                # a seeded shuffle, so truncation does not always drop the
                # partner's boxes
                perm = rng.permutation(len(classes))
                boxes, classes = boxes[perm], classes[perm]
                if not TrainPipeline._mixup_trunc_warned:
                    TrainPipeline._mixup_trunc_warned = True
                    logging.getLogger("heltondetection_tpu_torch").warning(
                        "mixup label union (%d boxes) exceeds max_boxes=%d;"
                        " keeping a seeded random subset. Raise "
                        "data.max_boxes if this is frequent.",
                        len(classes), self.max_boxes)
        m = self.max_boxes
        gt = np.zeros((m, 4), np.float32)
        cl = np.zeros((m,), np.int32)
        mask = np.zeros((m,), bool)
        n = min(len(classes), m)
        if n:
            b = boxes[:n]
            gt[:n, 0] = (b[:, 0] + b[:, 2]) / 2
            gt[:n, 1] = (b[:, 1] + b[:, 3]) / 2
            gt[:n, 2] = b[:, 2] - b[:, 0]
            gt[:n, 3] = b[:, 3] - b[:, 1]
            cl[:n] = classes[:n]
            mask[:n] = True
        return {"image": img, "gt_boxes": gt, "gt_cls": cl, "gt_mask": mask}


class DeviceAugPipeline:
    """The host half of the on-device augmentation (``data.device_aug``):
    per sample, the mosaic coin, then the sample itself and, when the
    mosaic fires, three seeded-random others, each letterboxed to the
    train size, as raw uint8 tiles with their boxes. Every other random
    choice (crop offset, flip, colour jitter, mixup) is made on the card.
    Tiles 1–3 are read only when the mosaic fires: reading images is the
    host's main cost, so at ``mosaic_p`` 0.5 this halves it."""

    def __init__(self, dataset, img_size: int, *, max_boxes: int = 32,
                 seed: int = 0, mosaic_p: float = 1.0):
        self.ds = dataset
        self.img_size = img_size
        self.max_boxes = max_boxes
        self.seed = seed
        self.mosaic_p = mosaic_p

    def __len__(self):
        return len(self.ds)

    def sample(self, idx: int, epoch: int = 0) -> Dict:
        """``images4`` (4, S, S, 3) uint8 (unused tiles grey 114),
        ``boxes4`` (4, M, 4) xyxy in tile pixels, ``cls4``, ``mask4`` (4,
        M) and ``mosaic4``, the coin, for sample ``idx`` of ``epoch``."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch, idx]))
        s, m = self.img_size, self.max_boxes
        use_mosaic = bool(rng.uniform() < self.mosaic_p)
        ids = [idx]
        if use_mosaic:
            ids += [int(j) for j in rng.integers(0, len(self.ds), 3)]
        images = np.full((4, s, s, 3), 114, np.uint8)
        boxes4 = np.zeros((4, m, 4), np.float32)
        cls4 = np.zeros((4, m), np.int32)
        mask4 = np.zeros((4, m), bool)
        for t, j in enumerate(ids):
            raw = drop_ignore_boxes(self.ds.load(j))
            img, b, _ = letterbox_np(raw["image"], raw["boxes"], s)
            images[t] = img
            n = min(len(raw["classes"]), m)
            if n:
                boxes4[t, :n] = b[:n]
                cls4[t, :n] = raw["classes"][:n]
                mask4[t, :n] = True
        return {"images4": images, "boxes4": boxes4, "cls4": cls4,
                "mask4": mask4, "mosaic4": np.asarray(use_mosaic)}


class EvalPipeline:
    """Eval preprocessing: letterbox only, with the metadata of its inverse
    that the evaluator needs."""

    def __init__(self, dataset, img_size: int):
        self.ds = dataset
        self.img_size = img_size

    def __len__(self):
        return len(self.ds)

    def sample(self, idx: int) -> Dict:
        raw = self.ds.load(idx)
        img, _, meta = letterbox_np(raw["image"], np.zeros((0, 4)),
                                    self.img_size)
        h, w = raw["image"].shape[:2]
        return {"image": img, "img_id": raw["img_id"], "scale": meta["scale"],
                "pad_x": meta["pad_x"], "pad_y": meta["pad_y"],
                "orig_hw": (h, w)}
