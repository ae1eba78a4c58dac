"""CSPDarknet backbone (YOLOv5 v6.1 topology); counterpart of
heltondetection_tpu/models/cspdarknet.py.

Returns the pyramid features C3 (stride 8), C4 (stride 16) and C5 (stride
32, after SPPF). DropBlock, remat and frozen stages are training features
and come with the training slice.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from heltondetection_tpu_torch.models.common import (C3, SPPF, ConvBnAct,
                                                     depth, scaled)

# (depth_multiple, width_multiple) per variant
VARIANTS = {
    "n": (0.33, 0.25),
    "s": (0.33, 0.50),
    "m": (0.67, 0.75),
    "l": (1.00, 1.00),
    "x": (1.33, 1.25),
}


class CSPDarknet(nn.Module):

    def __init__(self, depth_multiple: float = 0.33,
                 width_multiple: float = 0.50,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        w, d, dt = width_multiple, depth_multiple, dtype
        # stem: 6x6 stride-2 conv, pad 2 (v6.0+)
        self.stem = ConvBnAct(3, scaled(64, w), 6, 2, pad=2, dtype=dt)
        self.down1 = ConvBnAct(scaled(64, w), scaled(128, w), 3, 2, dtype=dt)
        self.c3_1 = C3(scaled(128, w), scaled(128, w), depth(3, d), dtype=dt)
        self.down2 = ConvBnAct(scaled(128, w), scaled(256, w), 3, 2, dtype=dt)
        self.c3_2 = C3(scaled(256, w), scaled(256, w), depth(6, d), dtype=dt)
        self.down3 = ConvBnAct(scaled(256, w), scaled(512, w), 3, 2, dtype=dt)
        self.c3_3 = C3(scaled(512, w), scaled(512, w), depth(9, d), dtype=dt)
        self.down4 = ConvBnAct(scaled(512, w), scaled(1024, w), 3, 2,
                               dtype=dt)
        self.c3_4 = C3(scaled(1024, w), scaled(1024, w), depth(3, d),
                       dtype=dt)
        self.sppf = SPPF(scaled(1024, w), scaled(1024, w), 5, dtype=dt)

    def forward(self, x):
        x = self.c3_1(self.down1(self.stem(x)))
        c3 = self.c3_2(self.down2(x))
        c4 = self.c3_3(self.down3(c3))
        c5 = self.sppf(self.c3_4(self.down4(c4)))
        return c3, c4, c5
