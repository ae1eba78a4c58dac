"""YOLOv5s-focalloss(root) VOC0712 640² — the reference's focal 'root'
ablation row (README.md:117: AP50 72.709 / mAP 46.741)."""

import dataclasses as _dc

from heltondetection_tpu_torch.configs.yolov5_s_voc_640 import config as _base

config = _dc.replace(
    _base, name="yolov5_s_voc_640_focal_root",
    train=_dc.replace(_base.train, focal="root"))
