"""YOLOv5s COCO2017 640² + DropBlock(0.5), backbone NOT frozen — the
reference's plain-dropBlock ablation row (README.md:131: AP50 49.773 /
mAP 31.227; freezing the backbone on top recovers it, README.md:132 —
see yolov5_s_coco_640_dropblock_frozen.py)."""

import dataclasses as _dc

from heltondetection_tpu_torch.configs.yolov5_s_coco_640_dropblock_frozen import \
    config as _base

config = _dc.replace(
    _base, name="yolov5_s_coco_640_dropblock",
    model=_dc.replace(_base.model, freeze_backbone=False),
    train=_dc.replace(_base.train, pretrain_ckpt=None))
