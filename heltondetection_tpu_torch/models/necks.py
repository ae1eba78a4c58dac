"""Necks; counterpart of heltondetection_tpu/models/necks.py: the YOLOv5
PAFPN, and FasterRCNN's classic FPN and YOLOv8-style PAFPN, both with 256
output channels and a P6 level for the RPN (a 1x1 max-pool of stride 2,
i.e. every other row and column of the last level). Tensors are NCHW."""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn

from heltondetection_tpu_torch.models.common import (C3, CastConv2d,
                                                     ConvBnAct, depth, q_cat,
                                                     scaled, upsample2x)


def _p6(x: torch.Tensor) -> torch.Tensor:
    """flax ``max_pool(x, (1, 1), strides=(2, 2))``: a 1x1 window takes
    every other row and column."""
    return x[:, :, ::2, ::2]


class PAFPNv5(nn.Module):
    """YOLOv5 v6.1 head neck: top-down then bottom-up CSP path.

    Input (c3, c4, c5) from CSPDarknet (or the widths ``in_channels`` of
    another backbone); output (p3, p4, p5) with channels (256w, 512w,
    1024w). Its four joins are :func:`q_cat`, which keeps the int8 flow's
    activations int8 through them (a plain concat otherwise).
    """

    def __init__(self, depth_multiple: float = 0.33,
                 width_multiple: float = 0.50, in_channels=None):
        super().__init__()
        w = width_multiple
        n = depth(3, depth_multiple)
        c3, c4, c5 = scaled(256, w), scaled(512, w), scaled(1024, w)
        i3, i4, i5 = in_channels or (c3, c4, c5)
        self.lat5 = ConvBnAct(i5, c4, 1)
        self.td4 = C3(c4 + i4, c4, n, shortcut=False)
        self.lat4 = ConvBnAct(c4, c3, 1)
        self.td3 = C3(c3 + i3, c3, n, shortcut=False)
        self.bu3 = ConvBnAct(c3, c3, 3, 2)
        self.bu4 = C3(c3 + c3, c4, n, shortcut=False)
        self.bu5 = ConvBnAct(c4, c4, 3, 2)
        self.bu6 = C3(c4 + c4, c5, n, shortcut=False)

    def forward(self, feats):
        c3, c4, c5 = feats
        lat5 = self.lat5(c5)
        t4 = self.td4(q_cat([upsample2x(lat5), c4]))
        lat4 = self.lat4(t4)
        p3 = self.td3(q_cat([upsample2x(lat4), c3]))
        p4 = self.bu4(q_cat([self.bu3(p3), lat4]))
        p5 = self.bu6(q_cat([self.bu5(p4), lat5]))
        return p3, p4, p5


class FPN(nn.Module):
    """Classic FPN: lateral 1x1 convs, a top-down sum of the upsampled level
    above, a 3x3 smoothing conv per level (every conv with a bias, in the
    input's dtype), and P6 when ``extra_pool``."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 extra_pool: bool = True):
        super().__init__()
        self.n = len(in_channels)
        for i, c in enumerate(in_channels):
            self.add_module(f"lat{i}", CastConv2d(c, out_channels, 1))
            self.add_module(f"smooth{i}",
                            CastConv2d(out_channels, out_channels, 3, 1, 1))
        self.extra_pool = extra_pool

    def forward(self, feats) -> List[torch.Tensor]:
        lat = [getattr(self, f"lat{i}")(f) for i, f in enumerate(feats)]
        for i in range(self.n - 2, -1, -1):
            lat[i] = lat[i] + upsample2x(lat[i + 1])
        outs = [getattr(self, f"smooth{i}")(lat[i]) for i in range(self.n)]
        if self.extra_pool:
            outs.append(_p6(outs[-1]))
        return outs


class PAFPNv8(nn.Module):
    """YOLOv8-style PAFPN with every level at ``out_channels``: a 1x1
    ConvBnAct per input, a top-down path (concat of the upsampled level
    above, then a C3) and a bottom-up path (a strided 3x3 ConvBnAct, concat,
    C3), and P6 when ``extra_pool``."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 n_blocks: int = 1, extra_pool: bool = True):
        super().__init__()
        self.n = n = len(in_channels)
        c = out_channels
        for i, cin in enumerate(in_channels):
            self.add_module(f"in{i}", ConvBnAct(cin, c, 1))
        for i in range(n - 1):
            self.add_module(f"td{i}", C3(2 * c, c, n_blocks, shortcut=False))
        for i in range(1, n):
            self.add_module(f"bu{i}", ConvBnAct(c, c, 3, 2))
            self.add_module(f"out{i}", C3(2 * c, c, n_blocks, shortcut=False))
        self.extra_pool = extra_pool

    def forward(self, feats) -> List[torch.Tensor]:
        n = self.n
        xs = [getattr(self, f"in{i}")(f) for i, f in enumerate(feats)]
        td = [None] * n
        td[n - 1] = xs[n - 1]
        for i in range(n - 2, -1, -1):
            td[i] = getattr(self, f"td{i}")(
                torch.cat([upsample2x(td[i + 1]), xs[i]], dim=1))
        outs = [td[0]]
        for i in range(1, n):
            x = getattr(self, f"bu{i}")(outs[i - 1])
            outs.append(getattr(self, f"out{i}")(
                torch.cat([x, td[i]], dim=1)))
        if self.extra_pool:
            outs.append(_p6(outs[-1]))
        return outs
