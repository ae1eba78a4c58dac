"""Shared conv blocks (YOLOv5 v6.1 Conv/Bottleneck/C3/SPPF); counterpart of
the float path of heltondetection_tpu/models/common.py.

Tensors are NCHW (the serve step feeds channels_last memory). Every
parameter and statistic is float32, as the reference keeps float32 master
variables; ``dtype`` is the compute dtype only: a conv casts its weight to
the dtype of its input when it runs, so a bfloat16 model trains float32
weights. BN uses the Ultralytics eps 1e-3 and torch momentum 0.03 (flax
momentum 0.97), and in training mode updates its running variance with the
biased batch variance, as flax does (:class:`BatchNorm2d`). The int8 and
calibration hooks come with the int8 slice.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def make_divisible(x: float, divisor: int = 8) -> int:
    return max(divisor, int(math.ceil(x / divisor) * divisor))


def autopad(k: int) -> int:
    return k // 2


def scaled(c: int, w: float) -> int:
    """Channel count under a width multiple (YOLOv5 variant scaling)."""
    return make_divisible(c * w, 8)


def depth(n: int, d: float) -> int:
    """Block count under a depth multiple."""
    return max(round(n * d), 1)


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Random init from ``generator`` alone, in module order: conv and dense
    weights from N(0, 1/fan_in) (the scale of flax's lecun_normal), biases
    zero, BatchNorm the identity with fresh statistics. Runs on CPU
    parameters, so one seed gives the same weights whatever device the
    model moves to."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
            elif isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                w = torch.empty(m.weight.shape, dtype=torch.float32)
                w.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
                m.weight.copy_(w)
                if m.bias is not None:
                    m.bias.zero_()


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm whose training mode is flax's ``nn.BatchNorm``: it
    normalizes with the batch mean and biased variance (statistics in
    float32 whatever the input dtype, the output in the input dtype) and
    moves the running statistics toward the batch mean and the *biased*
    batch variance; ``torch.nn.BatchNorm2d`` moves them toward the unbiased
    one. Eval mode, and training with ``momentum=None`` (the cumulative
    average that ``models.yolov5.calibrate_bn`` uses), are torch's own.

    ``hold_stats`` (set by :func:`checkpointed` while the backward pass
    re-runs a forward) keeps the running statistics and
    ``num_batches_tracked`` where they are: a recomputed forward normalizes
    with the same batch statistics but must not move them a second time."""

    hold_stats = False

    def forward(self, x):
        if not self.training or self.momentum is None:
            return super().forward(x)
        if not self.hold_stats:
            with torch.no_grad():
                var, mean = torch.var_mean(x.float(), dim=(0, 2, 3),
                                           correction=0)
                self.running_mean.lerp_(mean, self.momentum)
                self.running_var.lerp_(var, self.momentum)
                self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)


@contextlib.contextmanager
def _held_stats(module: nn.Module):
    bns = [m for m in module.modules() if isinstance(m, BatchNorm2d)]
    for m in bns:
        m.hold_stats = True
    try:
        yield
    finally:
        for m in bns:
            m.hold_stats = False


def checkpointed(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``module(x)`` without keeping its activations for the backward pass,
    which runs the forward again to get them (activation checkpointing, the
    reference's ``nn.remat``). The rerun holds the BatchNorm running
    statistics (:class:`BatchNorm2d` ``hold_stats``), so they move once per
    step, as without checkpointing. The modules draw no random numbers, so
    the RNG state is not saved for the rerun."""
    return checkpoint(module, x, use_reentrant=False,
                      preserve_rng_state=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          _held_stats(module)))


class CastConv2d(nn.Conv2d):
    """A conv whose float32 weight and bias are cast to the dtype of its
    input where it runs (flax's ``nn.Conv(dtype=…)``)."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), bias, self.stride,
                        self.padding, self.dilation, self.groups)


class CastLinear(nn.Linear):
    """A dense layer whose float32 weight and bias are cast to the dtype of
    its input where it runs (flax's ``nn.Dense(dtype=…)``)."""

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class ConvBnAct(nn.Module):
    """Conv → BN → SiLU, the universal YOLOv5 block ("Conv"). The conv's
    float32 weight is cast to the input's dtype where it is used."""

    def __init__(self, cin: int, cout: int, kernel: int = 1, stride: int = 1,
                 groups: int = 1, act: bool = True, pad: int | None = None):
        super().__init__()
        p = autopad(kernel) if pad is None else pad
        self.conv = nn.Conv2d(cin, cout, kernel, stride, p, groups=groups,
                              bias=False)
        self.bn = BatchNorm2d(cout, eps=1e-3, momentum=0.03)
        self.act = act

    def forward(self, x):
        c = self.conv
        x = F.conv2d(x, c.weight.to(x.dtype), None, c.stride, c.padding,
                     c.dilation, c.groups)
        x = self.bn(x)
        return F.silu(x) if self.act else x


class Bottleneck(nn.Module):
    """1x1 → 3x3 with optional residual add (YOLOv5 Bottleneck)."""

    def __init__(self, cin: int, cout: int, shortcut: bool = True,
                 expansion: float = 0.5):
        super().__init__()
        hidden = int(cout * expansion)
        self.cv1 = ConvBnAct(cin, hidden, 1)
        self.cv2 = ConvBnAct(hidden, cout, 3)
        self.add = shortcut and cin == cout

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C3(nn.Module):
    """CSP bottleneck with 3 convs (YOLOv5 C3): split → n bottlenecks →
    merge. The bottlenecks are registered as ``m0``, ``m1``, … like the
    reference's flax scopes."""

    def __init__(self, cin: int, cout: int, n: int = 1, shortcut: bool = True,
                 expansion: float = 0.5):
        super().__init__()
        hidden = int(cout * expansion)
        self.cv1 = ConvBnAct(cin, hidden, 1)
        self.n = n
        for i in range(n):
            self.add_module(f"m{i}", Bottleneck(hidden, hidden, shortcut, 1.0))
        self.cv2 = ConvBnAct(cin, hidden, 1)
        self.cv3 = ConvBnAct(2 * hidden, cout, 1)

    def forward(self, x):
        y1 = self.cv1(x)
        for i in range(self.n):
            y1 = getattr(self, f"m{i}")(y1)
        return self.cv3(torch.cat([y1, self.cv2(x)], dim=1))


class SPPF(nn.Module):
    """Spatial pyramid pooling — fast (3 chained 5x5 max-pools)."""

    def __init__(self, cin: int, cout: int, pool: int = 5):
        super().__init__()
        hidden = cin // 2
        self.cv1 = ConvBnAct(cin, hidden, 1)
        self.cv2 = ConvBnAct(4 * hidden, cout, 1)
        self.pool = pool

    def forward(self, x):
        x = self.cv1(x)
        p = self.pool // 2
        y1 = F.max_pool2d(x, self.pool, 1, p)
        y2 = F.max_pool2d(y1, self.pool, 1, p)
        y3 = F.max_pool2d(y2, self.pool, 1, p)
        return self.cv2(torch.cat([x, y1, y2, y3], dim=1))


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsample of an NCHW tensor."""
    return F.interpolate(x, scale_factor=2, mode="nearest")
