"""FasterRCNN-PAFPNP2 (coupled head) VOC0712 832² — the reference's
PAFPN-vs-FPN ablation row (README.md:75: AP50 78.887 / mAP 54.085,
bs 12)."""

import dataclasses as _dc

from heltondetection_tpu_torch.configs.faster_rcnn_pafpnp2_decoupled_voc_832 \
    import config as _base

config = _dc.replace(
    _base, name="faster_rcnn_pafpnp2_voc_832",
    model=_dc.replace(_base.model, head="coupled"),
    train=_dc.replace(_base.train, batch_size=12, mosaic_p=0.0))
