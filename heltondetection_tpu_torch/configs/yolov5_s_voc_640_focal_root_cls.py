"""YOLOv5s-focalloss(root_cls) VOC0712 640² — the reference's focal
'root_cls' ablation row (README.md:118: AP50 73.095 / mAP 46.017)."""

import dataclasses as _dc

from heltondetection_tpu_torch.configs.yolov5_s_voc_640 import config as _base

config = _dc.replace(
    _base, name="yolov5_s_voc_640_focal_root_cls",
    train=_dc.replace(_base.train, focal="root_cls"))
