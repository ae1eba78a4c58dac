"""FasterRCNN-PAFPN-DecoupledHead COCO2017 640² + DropBlock(0.5) on the
pooled head features — the reference's DDP_dropBlock0.5 row
(README.md:97: AP50 57.848 / mAP 39.202)."""

import dataclasses as _dc

from heltondetection_tpu_torch.configs.faster_rcnn_pafpn_decoupled_coco_640 \
    import config as _base

config = _dc.replace(
    _base, name="faster_rcnn_coco_640_dropblock",
    model=_dc.replace(_base.model, dropblock_p=0.5))
