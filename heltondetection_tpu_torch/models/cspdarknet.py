"""CSPDarknet backbone (YOLOv5 v6.1 topology); counterpart of
heltondetection_tpu/models/cspdarknet.py.

Returns the pyramid features C3 (stride 8), C4 (stride 16) and C5 (stride
32, after SPPF), and with ``include_c2`` first C2 (stride 4, after c3_1), as
a FasterRCNN FPN over the backbone registry needs; ``channels`` holds their
widths. Training freezes the backbone through the optimizer
(``train.schedule``). ``dropblock_p`` > 0 applies one :class:`DropBlock` to
C3, C4 and C5 in training mode, a fresh draw each; ``remat`` checkpoints
each stage (stem, downsamples, C3s, SPPF) in training, so the backward pass
runs its forward again instead of keeping its activations: the same
parameters, state dict and numbers, for about a third more backbone FLOPs.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from heltondetection_tpu_torch.models.common import (C3, SPPF, ConvBnAct,
                                                     checkpointed, depth,
                                                     scaled)
from heltondetection_tpu_torch.models.dropblock import DropBlock

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
                 width_multiple: float = 0.50, dropblock_p: float = 0.0,
                 remat: bool = False, include_c2: bool = False):
        super().__init__()
        w, d = width_multiple, depth_multiple
        self.include_c2 = include_c2
        self.channels = tuple(scaled(c, w) for c in (128, 256, 512, 1024)
                              )[0 if include_c2 else 1:]
        # stem: 6x6 stride-2 conv, pad 2 (v6.0+)
        self.stem = ConvBnAct(3, scaled(64, w), 6, 2, pad=2)
        self.down1 = ConvBnAct(scaled(64, w), scaled(128, w), 3, 2)
        self.c3_1 = C3(scaled(128, w), scaled(128, w), depth(3, d))
        self.down2 = ConvBnAct(scaled(128, w), scaled(256, w), 3, 2)
        self.c3_2 = C3(scaled(256, w), scaled(256, w), depth(6, d))
        self.down3 = ConvBnAct(scaled(256, w), scaled(512, w), 3, 2)
        self.c3_3 = C3(scaled(512, w), scaled(512, w), depth(9, d))
        self.down4 = ConvBnAct(scaled(512, w), scaled(1024, w), 3, 2)
        self.c3_4 = C3(scaled(1024, w), scaled(1024, w), depth(3, d))
        self.sppf = SPPF(scaled(1024, w), scaled(1024, w), 5)
        self.dropblock = DropBlock(dropblock_p) if dropblock_p > 0 else None
        self.remat = remat

    def forward(self, x):
        remat = self.remat and self.training and torch.is_grad_enabled()

        def stage(m, x):
            return checkpointed(m, x) if remat else m(x)

        for name in ("stem", "down1", "c3_1"):
            x = stage(getattr(self, name), x)
        c2 = x
        c3 = stage(self.c3_2, stage(self.down2, c2))
        c4 = stage(self.c3_3, stage(self.down3, c3))
        x = stage(self.c3_4, stage(self.down4, c4))
        c5 = stage(self.sppf, x)
        if self.dropblock is not None:
            c3, c4, c5 = (self.dropblock(c) for c in (c3, c4, c5))
        return (c2, c3, c4, c5) if self.include_c2 else (c3, c4, c5)
