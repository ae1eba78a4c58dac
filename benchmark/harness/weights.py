"""Seeded weights, made on the device in one draw."""

from __future__ import annotations

import math

import torch
import torch.nn as nn


@torch.no_grad()
def fill_seeded(model: nn.Module, gen: torch.Generator,
                bn_bias: float) -> None:
    """Every conv and dense weight from N(0, 1/fan_in) (the scale of
    lecun_normal), one ``randn`` over all of them on the generator's
    device, in module order; biases zero; BatchNorm's scale 1, its shift
    ``bn_bias``, fresh statistics."""
    weights = []
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            weights.append(m.weight)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.weight.fill_(1.0)
            m.bias.fill_(bn_bias)
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
            m.num_batches_tracked.zero_()
    total = sum(w.numel() for w in weights)
    flat = torch.randn(total, generator=gen, device=gen.device)
    start = 0
    for w in weights:
        n = w.numel()
        w.copy_(flat[start:start + n].view_as(w) / math.sqrt(w[0].numel()))
        start += n
