"""YOLOv5s VOC0712 640², mosaic OFF — the reference's no-mosaic ablation
row (README.md:115: AP50 69.324 / mAP 44.595)."""

import dataclasses as _dc

from heltondetection_tpu_torch.configs.yolov5_s_voc_640 import config as _base

config = _dc.replace(
    _base, name="yolov5_s_voc_640_mosaic0",
    train=_dc.replace(_base.train, mosaic_p=0.0))
