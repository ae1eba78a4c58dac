"""FasterRCNN-PAFPNP2-DecoupledHead COCO2017 832², mosaic OFF — the
reference's P2-only COCO row (README.md:87: AP50 58.064 / mAP 39.377)."""

import dataclasses as _dc

from heltondetection_tpu_torch.configs.faster_rcnn_pafpn_decoupled_coco_832 \
    import config as _base

config = _dc.replace(
    _base, name="faster_rcnn_pafpnp2_decoupled_coco_832",
    model=_dc.replace(_base.model, roi_levels=1),
    train=_dc.replace(_base.train, mosaic_p=0.0))
