"""FasterRCNN-PAFPNP2-DecoupledHead VOC0712 832², mosaic OFF — the
reference's decoupled-head-vs-coupled ablation row (README.md:76:
AP50 79.668 / mAP 55.152; +1.1 mAP over the coupled README.md:75 row)."""

import dataclasses as _dc

from heltondetection_tpu_torch.configs.faster_rcnn_pafpnp2_decoupled_voc_832 \
    import config as _base

config = _dc.replace(
    _base, name="faster_rcnn_pafpnp2_decoupled_voc_832_mosaic0",
    train=_dc.replace(_base.train, mosaic_p=0.0))
