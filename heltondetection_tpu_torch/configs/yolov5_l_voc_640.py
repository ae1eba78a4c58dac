"""YOLOv5l VOC0712 640² — the reference's best VOC YOLO row
(README.md:121: AP50 74.341 / mAP 50.417)."""

import dataclasses as _dc

from heltondetection_tpu_torch.configs.yolov5_s_voc_640 import config as _base

config = _dc.replace(
    _base, name="yolov5_l_voc_640",
    model=_dc.replace(_base.model, variant="l"))
