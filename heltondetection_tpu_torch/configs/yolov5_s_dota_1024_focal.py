"""YOLOv5s-focalloss(root) DOTAv1.0-h 1024² — the reference's DOTA focal
row (README.md:154: AP50 65.174 / mAP 39.257, the table's best AP50)."""

import dataclasses as _dc

from heltondetection_tpu_torch.configs.yolov5_s_dota_1024 import config as _base

config = _dc.replace(
    _base, name="yolov5_s_dota_1024_focal_root",
    train=_dc.replace(_base.train, focal="root"))
