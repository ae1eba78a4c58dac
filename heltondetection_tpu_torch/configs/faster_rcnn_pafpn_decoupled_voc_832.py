"""FasterRCNN-PAFPN-DecoupledHead VOC0712 832², full-pyramid head,
mosaic p=0.5 — the reference's best from-scratch VOC two-stage row
(README.md:78: AP50 81.784 / mAP 58.527). The COCOPretrain variant on
top of this is faster_rcnn_voc_832_cocopretrain.py (README.md:79)."""

import dataclasses as _dc

from heltondetection_tpu_torch.configs.faster_rcnn_pafpnp2_decoupled_voc_832 \
    import config as _base

config = _dc.replace(
    _base, name="faster_rcnn_pafpn_decoupled_voc_832",
    model=_dc.replace(_base.model, roi_levels=4))
