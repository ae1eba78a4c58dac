"""YOLOv5s-focalloss(root) VisDrone2019 1280² (README.md:144: AP50
33.050 / mAP 18.131)."""

import dataclasses as _dc

from heltondetection_tpu_torch.configs.yolov5_l_visdrone_1280_focal import \
    config as _base

config = _dc.replace(
    _base, name="yolov5_s_visdrone_1280_focal_root",
    model=_dc.replace(_base.model, variant="s"),
    train=_dc.replace(_base.train, batch_size=16))
