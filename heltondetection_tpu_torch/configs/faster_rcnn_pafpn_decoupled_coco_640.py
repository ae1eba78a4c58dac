"""FasterRCNN-PAFPN-DecoupledHead COCO2017 640², mosaic p=0.5 — the
reference's 640² two-stage rows (README.md:95: AP50 59.047 / mAP 40.001
single-card; README.md:96 the same config under DDP → 58.136 / 39.103).
Data-parallel scale-out is a LAUNCH mode here, not a config fork: the
runner shards the batch over every visible chip (parallel/mesh.py), so
this one file covers both rows."""

import dataclasses as _dc

from heltondetection_tpu_torch.configs.faster_rcnn_pafpn_decoupled_coco_832 \
    import config as _base

config = _dc.replace(
    _base, name="faster_rcnn_pafpn_decoupled_coco_640",
    model=_dc.replace(_base.model, img_size=640))
