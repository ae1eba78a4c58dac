"""Dataset readers: COCO-JSON, YOLO-txt, DOTA horizontal boxes, Pascal-VOC
XML and native VisDrone-DET; counterpart of heltondetection_tpu/data/
readers.py.

A reader maps an index to a raw sample ``{image (H, W, 3) uint8 RGB, boxes
(N, 4) xyxy float32, classes (N,) int32, iscrowd (N,), img_id, file}``, and
offers ``num_classes``, ``gt_for_eval(det_eval)`` and ``label_to_cat``.
COCO keeps its integer image ids; the other readers use the file stem, a
string, as the reference's do. ``COCODataset.load_encoded`` (the native
loader's input) is not ported yet (ROADMAP A6). OpenCV, the image decoder,
is imported where an image is read (:func:`imread_rgb`), so importing this
module does not need it; a reader of in-memory frames needs no decoder at
all.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, Optional, Sequence

import numpy as np


def drop_ignore_boxes(raw: Dict) -> Dict:
    """Train-time gt without the ignore boxes (COCO ``iscrowd=1``, VOC
    ``difficult``, VisDrone's ignored regions and ``others``): they reach
    ``gt_for_eval`` as ignore regions instead."""
    crowd = raw.get("iscrowd")
    if crowd is None or len(crowd) == 0 or not np.any(crowd):
        return raw
    keep = np.asarray(crowd) == 0
    out = dict(raw)
    out["boxes"] = raw["boxes"][keep]
    out["classes"] = raw["classes"][keep]
    out["iscrowd"] = raw["iscrowd"][keep]
    return out


def imread_rgb(path: str) -> np.ndarray:
    """An image file → (H, W, 3) uint8 RGB."""
    import cv2
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


class COCODataset:
    """COCO-JSON detection reader. Category ids map to a contiguous
    [0, num_classes) label space; ``label_to_cat`` is the inverse."""

    def __init__(self, ann_file: str, img_dir: str,
                 keep_empty: bool = True):
        with open(ann_file) as f:
            coco = json.load(f)
        self.img_dir = img_dir
        cats = sorted(coco["categories"], key=lambda c: c["id"])
        self.cat_ids = [c["id"] for c in cats]
        self.class_names = [c["name"] for c in cats]
        self.cat_to_label = {cid: i for i, cid in enumerate(self.cat_ids)}
        self.label_to_cat = {i: cid for i, cid in enumerate(self.cat_ids)}

        self.images = {im["id"]: im for im in coco["images"]}
        anns_by_img: Dict = {i: [] for i in self.images}
        for a in coco.get("annotations", []):
            if a.get("ignore", 0):
                continue
            anns_by_img.setdefault(a["image_id"], []).append(a)
        self.ids = [i for i in self.images
                    if keep_empty or anns_by_img.get(i)]
        self.anns_by_img = anns_by_img

    def __len__(self):
        return len(self.ids)

    @property
    def num_classes(self):
        return len(self.cat_ids)

    def meta(self, idx: int) -> Dict:
        im = self.images[self.ids[idx]]
        return {"img_id": im["id"], "height": im["height"],
                "width": im["width"], "file": im["file_name"]}

    def load(self, idx: int) -> Dict:
        img_id = self.ids[idx]
        im = self.images[img_id]
        img = imread_rgb(os.path.join(self.img_dir, im["file_name"]))
        boxes, classes, crowd = [], [], []
        for a in self.anns_by_img.get(img_id, []):
            x, y, w, h = a["bbox"]
            if w <= 0 or h <= 0:
                continue
            boxes.append([x, y, x + w, y + h])
            classes.append(self.cat_to_label[a["category_id"]])
            crowd.append(a.get("iscrowd", 0))
        return {
            "image": img,
            "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
            "classes": np.asarray(classes, np.int32),
            "iscrowd": np.asarray(crowd, np.int32),
            "img_id": img_id,
            "file": im["file_name"],
        }

    def gt_for_eval(self, det_eval):
        """Register all ground truth (xywh and crowd flags) with a
        DetEval."""
        for idx in range(len(self)):
            img_id = self.ids[idx]
            boxes, classes, crowd, areas = [], [], [], []
            for a in self.anns_by_img.get(img_id, []):
                x, y, w, h = a["bbox"]
                boxes.append([x, y, w, h])
                classes.append(self.cat_to_label[a["category_id"]])
                crowd.append(a.get("iscrowd", 0))
                areas.append(a.get("area", w * h))
            if boxes:
                det_eval.add_gt(img_id, boxes, classes, iscrowd=crowd,
                                areas=areas)


def _xyxy_to_xywh(boxes) -> np.ndarray:
    b = np.asarray(boxes, np.float32).reshape(-1, 4)
    return np.stack([b[:, 0], b[:, 1], b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]],
                    1)


def _sample(img, boxes, classes, iscrowd, img_id, fname) -> Dict:
    return {"image": img,
            "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
            "classes": np.asarray(classes, np.int32),
            "iscrowd": np.asarray(iscrowd, np.int32),
            "img_id": img_id, "file": fname}


IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def _image_files(img_dir: str):
    return sorted(f for f in os.listdir(img_dir)
                  if os.path.splitext(f)[1].lower() in IMG_EXTS)


class YOLODataset:
    """YOLO-txt reader: per image a ``.txt`` of the same stem under
    ``label_dir`` with lines ``cls cx cy w h`` normalized to [0, 1]. Labels
    are already contiguous, so ``label_to_cat`` is None; the eval side
    (``gt_for_eval``) is the reference's extension over its own upstream."""

    IMG_EXTS = IMG_EXTS

    def __init__(self, img_dir: str, label_dir: str,
                 class_names: Optional[Sequence[str]] = None):
        self.img_dir = img_dir
        self.label_dir = label_dir
        self.files = _image_files(img_dir)
        self.class_names = list(class_names) if class_names else None
        self.label_to_cat = None

    def __len__(self):
        return len(self.files)

    @property
    def num_classes(self):
        return len(self.class_names) if self.class_names else 0

    def load(self, idx: int) -> Dict:
        fname = self.files[idx]
        img = imread_rgb(os.path.join(self.img_dir, fname))
        h, w = img.shape[:2]
        stem = os.path.splitext(fname)[0]
        lpath = os.path.join(self.label_dir, stem + ".txt")
        boxes, classes = [], []
        if os.path.exists(lpath):
            with open(lpath) as f:
                for line in f:
                    parts = line.split()
                    if len(parts) < 5:
                        continue
                    c, cx, cy, bw, bh = (float(v) for v in parts[:5])
                    cx, cy, bw, bh = cx * w, cy * h, bw * w, bh * h
                    boxes.append([cx - bw / 2, cy - bh / 2,
                                  cx + bw / 2, cy + bh / 2])
                    classes.append(int(c))
        return _sample(img, boxes, classes, np.zeros(len(boxes)), stem, fname)

    def gt_for_eval(self, det_eval):
        for idx in range(len(self)):
            s = self.load(idx)
            if len(s["classes"]):
                det_eval.add_gt(s["img_id"], _xyxy_to_xywh(s["boxes"]),
                                s["classes"])


class DOTADataset:
    """DOTA horizontal-box reader (DOTAv1.0-h): per image a ``.txt`` whose
    lines are ``x1 y1 x2 y2 x3 y3 x4 y4 category difficult``; each quad
    becomes its axis-aligned hull, the ``imagesource:``/``gsd:`` header
    lines and unknown categories are skipped."""

    def __init__(self, img_dir: str, label_dir: str,
                 class_names: Sequence[str]):
        self.img_dir = img_dir
        self.label_dir = label_dir
        self.class_names = list(class_names)
        self.name_to_label = {n: i for i, n in enumerate(self.class_names)}
        self.files = _image_files(img_dir)
        self.label_to_cat = None

    def __len__(self):
        return len(self.files)

    @property
    def num_classes(self):
        return len(self.class_names)

    def load(self, idx: int) -> Dict:
        fname = self.files[idx]
        img = imread_rgb(os.path.join(self.img_dir, fname))
        stem = os.path.splitext(fname)[0]
        lpath = os.path.join(self.label_dir, stem + ".txt")
        boxes, classes = [], []
        if os.path.exists(lpath):
            with open(lpath) as f:
                for line in f:
                    parts = line.split()
                    if len(parts) < 9 or parts[0].startswith(("imagesource",
                                                              "gsd")):
                        continue
                    name = parts[8]
                    if name not in self.name_to_label:
                        continue
                    quad = np.asarray([float(v) for v in parts[:8]],
                                      np.float32).reshape(4, 2)
                    x1, y1 = quad.min(0)
                    x2, y2 = quad.max(0)
                    boxes.append([x1, y1, x2, y2])
                    classes.append(self.name_to_label[name])
        return _sample(img, boxes, classes, np.zeros(len(boxes)), stem, fname)

    def gt_for_eval(self, det_eval):
        for idx in range(len(self)):
            s = self.load(idx)
            if len(s["classes"]):
                det_eval.add_gt(s["img_id"], _xyxy_to_xywh(s["boxes"]),
                                s["classes"])


VISDRONE_CLASSES = (
    "pedestrian", "people", "bicycle", "car", "van", "truck", "tricycle",
    "awning-tricycle", "bus", "motor")


class VisDroneDataset:
    """VisDrone2019-DET reader: per image a ``.txt`` of the same stem with
    CSV lines ``left,top,width,height,score,category,truncation,
    occlusion``. Categories 1..10 become labels 0..9 (``label_to_cat`` is
    i → i + 1). Rows with ``score == 0``, the ignored regions (category 0)
    and ``others`` (category 11), become ``iscrowd=1``: training drops them
    (:func:`drop_ignore_boxes`) and eval treats them as ignore regions, a
    class-agnostic one for every class."""

    def __init__(self, img_dir: str, label_dir: str,
                 class_names: Optional[Sequence[str]] = None):
        self.img_dir = img_dir
        self.label_dir = label_dir
        self.class_names = list(class_names) if class_names \
            else list(VISDRONE_CLASSES)
        self.files = _image_files(img_dir)
        self.label_to_cat = {i: i + 1 for i in range(len(self.class_names))}

    def __len__(self):
        return len(self.files)

    @property
    def num_classes(self):
        return len(self.class_names)

    def _parse(self, stem: str):
        """(boxes xyxy, labels with −1 for a class-agnostic ignore row,
        ignore flags) of one image's annotation file."""
        lpath = os.path.join(self.label_dir, stem + ".txt")
        boxes, classes, ignore = [], [], []
        nc = len(self.class_names)
        if os.path.exists(lpath):
            with open(lpath) as f:
                for line in f:
                    parts = line.strip().rstrip(",").split(",")
                    if len(parts) < 6:
                        continue
                    x, y, w, h = (float(v) for v in parts[:4])
                    if w <= 0 or h <= 0:
                        continue
                    score, cat = int(parts[4]), int(parts[5])
                    label = cat - 1
                    boxes.append([x, y, x + w, y + h])
                    if score == 0 or not 0 <= label < nc:
                        classes.append(-1)
                        ignore.append(1)
                    else:
                        classes.append(label)
                        ignore.append(0)
        return boxes, classes, ignore

    def load(self, idx: int) -> Dict:
        fname = self.files[idx]
        img = imread_rgb(os.path.join(self.img_dir, fname))
        stem = os.path.splitext(fname)[0]
        boxes, classes, ignore = self._parse(stem)
        # the −1 of an ignore row becomes label 0; training drops the row
        cls = np.maximum(np.asarray(classes, np.int32), 0)
        return _sample(img, boxes, cls, ignore, stem, fname)

    def gt_for_eval(self, det_eval):
        nc = len(self.class_names)
        for idx in range(len(self)):
            stem = os.path.splitext(self.files[idx])[0]
            boxes, classes, ignore = self._parse(stem)
            if not boxes:
                continue
            out_b, out_c, out_i = [], [], []
            for bb, c, ig in zip(_xyxy_to_xywh(boxes), classes, ignore):
                # COCO ignore matching is per class: a class-agnostic
                # ignore region is registered once for every class
                for k in (range(nc) if c < 0 else (c,)):
                    out_b.append(bb)
                    out_c.append(k)
                    out_i.append(1 if c < 0 else ig)
            det_eval.add_gt(stem, out_b, out_c, iscrowd=out_i)


VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor")


class VOCDataset:
    """Pascal-VOC XML reader. ``ann`` is the Annotations/ directory (every
    ``.xml`` a sample) or an ImageSets/Main split file (one stem per line,
    Annotations/ at ``../../Annotations``, the VOCdevkit layout). Boxes are
    1-based inclusive in the files and 0-based here; ``difficult`` objects
    become ``iscrowd=1`` (dropped in training, ignore regions in eval)."""

    def __init__(self, ann: str, img_dir: str,
                 class_names: Optional[Sequence[str]] = None):
        self.img_dir = img_dir
        self.class_names = list(class_names) if class_names \
            else list(VOC_CLASSES)
        self.name_to_label = {n: i for i, n in enumerate(self.class_names)}
        self.label_to_cat = None
        if os.path.isdir(ann):
            self.ann_dir = ann
            self.stems = sorted(os.path.splitext(f)[0]
                                for f in os.listdir(ann)
                                if f.endswith(".xml"))
        else:
            self.ann_dir = os.path.normpath(
                os.path.join(os.path.dirname(ann), "..", "..",
                             "Annotations"))
            with open(ann) as f:
                # "stem" or "stem 1/-1" (the per-class split files)
                self.stems = [ln.split()[0] for ln in f if ln.strip()]

    def __len__(self):
        return len(self.stems)

    @property
    def num_classes(self):
        return len(self.class_names)

    def _parse(self, stem: str):
        import xml.etree.ElementTree as ET
        root = ET.parse(os.path.join(self.ann_dir, stem + ".xml")).getroot()
        fname = root.findtext("filename") or (stem + ".jpg")
        boxes, classes, difficult = [], [], []
        for obj in root.iter("object"):
            name = (obj.findtext("name") or "").strip()
            if name not in self.name_to_label:
                continue
            bb = obj.find("bndbox")
            x1, y1, x2, y2 = (float(bb.findtext(k)) - 1.0
                              for k in ("xmin", "ymin", "xmax", "ymax"))
            if x2 <= x1 or y2 <= y1:
                continue
            boxes.append([x1, y1, x2, y2])
            classes.append(self.name_to_label[name])
            difficult.append(int(obj.findtext("difficult") or 0))
        return fname, boxes, classes, difficult

    def load(self, idx: int) -> Dict:
        stem = self.stems[idx]
        fname, boxes, classes, difficult = self._parse(stem)
        img = imread_rgb(os.path.join(self.img_dir, fname))
        return _sample(img, boxes, classes, difficult, stem, fname)

    def gt_for_eval(self, det_eval):
        for stem in self.stems:
            _, boxes, classes, difficult = self._parse(stem)
            if boxes:
                det_eval.add_gt(stem, _xyxy_to_xywh(boxes), classes,
                                iscrowd=difficult)

class CachedDataset:
    """RAM cache around any reader (Ultralytics' ``--cache ram``): ``load``
    results are kept up to a byte budget, since decoding every epoch is the
    dominant host cost. Threads may race on a first load (the double
    decode is harmless); the budget is checked and charged under a lock."""

    def __init__(self, ds, max_bytes: int = 8 << 30):
        self.ds = ds
        self.max_bytes = max_bytes
        self._cache: Dict[int, Dict] = {}
        self._bytes = 0
        self._lock = threading.Lock()

    def __len__(self):
        return len(self.ds)

    def __getattr__(self, name):
        return getattr(self.ds, name)

    def load(self, idx: int) -> Dict:
        hit = self._cache.get(idx)
        if hit is not None:
            return hit
        s = self.ds.load(idx)
        size = s["image"].nbytes
        with self._lock:
            if idx not in self._cache and \
                    self._bytes + size <= self.max_bytes:
                self._cache[idx] = s
                self._bytes += size
        return s
