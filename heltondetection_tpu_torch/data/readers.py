"""Dataset readers; counterpart of ``drop_ignore_boxes``, ``imread_rgb``,
``COCODataset`` and ``CachedDataset`` in heltondetection_tpu/data/readers.py.

A reader maps an index to a raw sample ``{image (H, W, 3) uint8 RGB, boxes
(N, 4) xyxy float32, classes (N,) int32, iscrowd (N,), img_id, file}``, and
offers ``num_classes``, ``gt_for_eval(det_eval)`` and ``label_to_cat``. The
YOLO, DOTA, VOC and VisDrone readers and ``load_encoded`` (the native
loader's input) are not ported yet (ROADMAP A6). OpenCV, the image decoder,
is imported where an image is read, so importing this module does not need
it; a reader of in-memory frames needs no decoder at all.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict

import numpy as np


def drop_ignore_boxes(raw: Dict) -> Dict:
    """Train-time gt without the ignore boxes (COCO ``iscrowd=1``): they
    reach :meth:`COCODataset.gt_for_eval` as ignore regions instead."""
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
