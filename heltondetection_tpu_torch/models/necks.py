"""YOLOv5 PAFPN neck; counterpart of ``PAFPNv5`` in
heltondetection_tpu/models/necks.py. FPN and PAFPNv8 come with the
FasterRCNN slice."""

from __future__ import annotations

import torch
import torch.nn as nn

from heltondetection_tpu_torch.models.common import (C3, ConvBnAct, depth,
                                                     scaled, upsample2x)


class PAFPNv5(nn.Module):
    """YOLOv5 v6.1 head neck: top-down then bottom-up CSP path.

    Input (c3, c4, c5) from CSPDarknet; output (p3, p4, p5) with channels
    (256w, 512w, 1024w).
    """

    def __init__(self, depth_multiple: float = 0.33,
                 width_multiple: float = 0.50,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        w, dt = width_multiple, dtype
        n = depth(3, depth_multiple)
        c3, c4, c5 = scaled(256, w), scaled(512, w), scaled(1024, w)
        self.lat5 = ConvBnAct(c5, c4, 1, dtype=dt)
        self.td4 = C3(c4 + c4, c4, n, shortcut=False, dtype=dt)
        self.lat4 = ConvBnAct(c4, c3, 1, dtype=dt)
        self.td3 = C3(c3 + c3, c3, n, shortcut=False, dtype=dt)
        self.bu3 = ConvBnAct(c3, c3, 3, 2, dtype=dt)
        self.bu4 = C3(c3 + c3, c4, n, shortcut=False, dtype=dt)
        self.bu5 = ConvBnAct(c4, c4, 3, 2, dtype=dt)
        self.bu6 = C3(c4 + c4, c5, n, shortcut=False, dtype=dt)

    def forward(self, feats):
        c3, c4, c5 = feats
        lat5 = self.lat5(c5)
        t4 = self.td4(torch.cat([upsample2x(lat5), c4], dim=1))
        lat4 = self.lat4(t4)
        p3 = self.td3(torch.cat([upsample2x(lat4), c3], dim=1))
        p4 = self.bu4(torch.cat([self.bu3(p3), lat4], dim=1))
        p5 = self.bu6(torch.cat([self.bu5(p4), lat5], dim=1))
        return p3, p4, p5
