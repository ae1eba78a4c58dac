"""YOLOv5s VOC0712 640², mosaic p=1.0 — the reference's always-mosaic
ablation row (README.md:119: AP50 63.649 / mAP 35.859 — mosaic every
sample HURTS; the table's point is that p=0.5 is the sweet spot)."""

import dataclasses as _dc

from heltondetection_tpu_torch.configs.yolov5_s_voc_640 import config as _base

config = _dc.replace(
    _base, name="yolov5_s_voc_640_mosaic1",
    train=_dc.replace(_base.train, mosaic_p=1.0))
