"""ResNet backbone (torchvision v1 topology); counterpart of
heltondetection_tpu/models/resnet.py.

Bottleneck 1-3-1 with expansion 4 and the stride in the 3x3 (resnet50/101),
or two 3x3s (resnet18/34); a 7x7/2 stem and a 3x3/2 max-pool with pad 1.
BatchNorm uses torchvision's eps 1e-5 and momentum 0.1 (flax 0.9). Module
names follow the reference's flax scopes (``stem_conv``, ``stem_bn``,
``layer{s}_{b}.conv1/bn1/…/ds_conv/ds_bn``), so ``utils.convert`` maps its
weights by name and freezing can match the same prefixes. Tensors are NCHW
and the convs cast their float32 weights to the input's dtype. Each
conv/BN pair runs through ``models.common.conv_bn``, the W8A8 hooks of the
reference's ``_cbn``.

``norm_eval``, ``frozen_stages``, ``remat`` and ``dropblock_p`` shape
training only, as in the reference: BatchNorm on running statistics in
training (``norm_eval``, and always in the frozen stages), no gradient
through the stem and the first ``frozen_stages`` stages, each block
checkpointed (``remat``), DropBlock on C3–C5. In eval mode the network is
the same function whatever they are.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from heltondetection_tpu_torch.models.common import (BatchNorm2d, autopad,
                                                     checkpointed, conv_bn)
from heltondetection_tpu_torch.models.dropblock import DropBlock

RESNET_STAGES = {
    "resnet18": ((2, 2, 2, 2), "basic"),
    "resnet34": ((3, 4, 6, 3), "basic"),
    "resnet50": ((3, 4, 6, 3), "bottleneck"),
    "resnet101": ((3, 4, 23, 3), "bottleneck"),
}
WIDTHS = (64, 128, 256, 512)


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, autopad(k), bias=False)


def _bn(c: int) -> BatchNorm2d:
    return BatchNorm2d(c, eps=1e-5, momentum=0.1)


class Bottleneck(nn.Module):
    """1x1 → 3x3 (stride) → 1x1 to ``features``·4 channels, with a 1x1
    strided projection of the input where ``downsample``."""
    expansion = 4

    def __init__(self, cin: int, features: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1, self.bn1 = _conv(cin, features, 1), _bn(features)
        self.conv2, self.bn2 = _conv(features, features, 3, stride), \
            _bn(features)
        self.conv3, self.bn3 = _conv(features, features * 4, 1), \
            _bn(features * 4)
        if downsample:
            self.ds_conv = _conv(cin, features * 4, 1, stride)
            self.ds_bn = _bn(features * 4)
        self.downsample = downsample

    def forward(self, x):
        y = F.relu(conv_bn(self, "conv1", x))
        y = F.relu(conv_bn(self, "conv2", y))
        y = conv_bn(self, "conv3", y)
        res = conv_bn(self, "ds_conv", x) if self.downsample else x
        return F.relu(y + res)


class BasicBlock(nn.Module):
    """Two 3x3s (the first strided), with a 1x1 strided projection of the
    input where ``downsample`` (torchvision's BasicBlock)."""
    expansion = 1

    def __init__(self, cin: int, features: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1, self.bn1 = _conv(cin, features, 3, stride), _bn(features)
        self.conv2, self.bn2 = _conv(features, features, 3), _bn(features)
        if downsample:
            self.ds_conv = _conv(cin, features, 1, stride)
            self.ds_bn = _bn(features)
        self.downsample = downsample

    def forward(self, x):
        y = F.relu(conv_bn(self, "conv1", x))
        y = conv_bn(self, "conv2", y)
        res = conv_bn(self, "ds_conv", x) if self.downsample else x
        return F.relu(y + res)


class ResNet(nn.Module):
    """``forward(x (B, 3, H, W))`` → (C2, C3, C4, C5) at strides 4 to 32;
    ``channels`` holds their widths."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 block: str = "bottleneck", dropblock_p: float = 0.0,
                 norm_eval: bool = False, frozen_stages: int = 0,
                 remat: bool = False):
        super().__init__()
        blk = Bottleneck if block == "bottleneck" else BasicBlock
        self.stem_conv, self.stem_bn = _conv(3, 64, 7, 2), _bn(64)
        self.stage_sizes = tuple(stage_sizes)
        cin = 64
        for si, (n_blocks, w) in enumerate(zip(stage_sizes, WIDTHS)):
            for bi in range(n_blocks):
                stride = 2 if (bi == 0 and si > 0) else 1
                down = bi == 0 and (block == "bottleneck" or si > 0)
                self.add_module(f"layer{si + 1}_{bi}",
                                blk(cin, w, stride, down))
                cin = w * blk.expansion
        self.channels = tuple(w * blk.expansion for w in WIDTHS)
        self.dropblock = DropBlock(dropblock_p) if dropblock_p > 0 else None
        self.norm_eval = norm_eval
        self.frozen_stages = frozen_stages
        self.remat = remat

    def train(self, mode: bool = True):
        """Training mode, with BatchNorm left on its running statistics
        where ``norm_eval`` says so, or in a frozen stage (the stem freezes
        with the first)."""
        super().train(mode)
        if mode:
            for name, m in self.named_modules():
                stage = 1 if name.startswith("stem_") else (
                    int(name[5]) if name.startswith("layer") else None)
                if isinstance(m, BatchNorm2d) and (
                        self.norm_eval or (stage is not None
                                           and stage <= self.frozen_stages)):
                    m.eval()
        return self

    def forward(self, x) -> Tuple[torch.Tensor, ...]:
        remat = self.remat and self.training and torch.is_grad_enabled()
        x = F.relu(conv_bn(self, "stem_conv", x))
        x = F.max_pool2d(x, 3, 2, 1)
        if self.frozen_stages >= 1:
            x = x.detach()
        outs = []
        for si, n_blocks in enumerate(self.stage_sizes):
            for bi in range(n_blocks):
                m = getattr(self, f"layer{si + 1}_{bi}")
                x = checkpointed(m, x) if remat else m(x)
            if si + 1 <= self.frozen_stages:
                x = x.detach()
            outs.append(x)
        if self.dropblock is not None:
            outs = outs[:1] + [self.dropblock(o) for o in outs[1:]]
        return tuple(outs)
