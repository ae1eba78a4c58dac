"""YOLOv5s COCO2017 640², mosaic OFF — the reference's no-mosaic COCO
row (README.md:129: AP50 47.401 / mAP 29.663)."""

import dataclasses as _dc

from heltondetection_tpu_torch.configs.yolov5_s_coco_640 import config as _base

config = _dc.replace(
    _base, name="yolov5_s_coco_640_mosaic0",
    train=_dc.replace(_base.train, mosaic_p=0.0))
