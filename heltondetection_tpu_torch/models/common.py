"""Shared conv blocks (YOLOv5 v6.1 Conv/Bottleneck/C3/SPPF); counterpart of
the float path of heltondetection_tpu/models/common.py.

Tensors are NCHW (the serve step feeds channels_last memory). Every
parameter and statistic is float32, as the reference keeps float32 master
variables; ``dtype`` is the compute dtype only: a conv casts its weight to
the dtype of its input when it runs, so a bfloat16 model trains float32
weights. BN uses the Ultralytics eps 1e-3 and torch momentum 0.03 (flax
momentum 0.97), and in training mode updates its running variance with the
biased batch variance, as flax does (:class:`BatchNorm2d`).

W8A8 serving (``ops/quant.py``) rides on the same blocks, counterparts of
the reference's hooks:

* calibration (:func:`calibration_mode`): each ``ConvBnAct`` records its
  input's and its activated output's per-channel ``[amax, p999]``, each
  residual ``Bottleneck`` its sum's, each ResNet conv/BN pair its input's
  (:func:`conv_bn`), keyed by module, max-reduced within the pass;
* the per-layer mode: a ``quant`` submodule (:class:`LayerQuant`) on a
  ``ConvBnAct`` or a pair's conv runs conv+BN as an int8 conv with the BN
  folded, activations float between convs;
* the int8 activation flow (YOLOv5): a :class:`FlowQuant` on a
  ``ConvBnAct`` runs conv, BN and SiLU and emits a :class:`QT` (int8 and
  per-channel scales) that the next quantized conv folds into its weights;
  concats (:func:`q_cat`), SPPF's pools, :func:`upsample2x` and residual
  adds carry it.

A model holds those submodules only in the copy ``ops/quant.attach_quant``
makes; the float model is never changed.

Under spatial sharding (``parallel/spatial.py``: ``module.spatial`` set on
the trunk by the train step or ``spatial_forward``) every float operation
with a window on H, the convolutions (:func:`conv2d`) and SPPF's pools,
first takes its halo rows from the neighbouring ranks.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from heltondetection_tpu_torch.ops.int8_conv import int8_conv2d
from heltondetection_tpu_torch.parallel.mesh import all_reduce_sum_grad
from heltondetection_tpu_torch.parallel.spatial import windowed

# The calibration pass's recorder: {module: {name: (2, C) stats}} while
# calibration_mode() is active, else None. A contextvar, so no model code
# threads it.
_CALIBRATE: contextvars.ContextVar = contextvars.ContextVar(
    "heltondetection_torch_quant_calibrate", default=None)


@contextlib.contextmanager
def calibration_mode():
    """Record activation statistics while active; yields the recorder
    ``{module: {name: (2, C) float32 tensor}}`` (see :func:`sow`)."""
    rec = {}
    tok = _CALIBRATE.set(rec)
    try:
        yield rec
    finally:
        _CALIBRATE.reset(tok)


def _quantile_linear(a: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.quantile(a, q, axis=0)`` with its linear interpolation, in
    its float32 arithmetic: position q·(n−1), weights 1−frac and frac, and
    ``low·w_low + high·w_high`` with the first product fused into the add,
    as XLA compiles it (the float64 sum of an exact product rounds once)."""
    n = a.shape[0]
    pos = np.float32(q) * np.float32(n - 1)
    low, high = np.floor(pos), np.ceil(pos)
    w_high = np.float32(pos - low)
    w_low = np.float32(np.float32(1.0) - w_high)
    s = torch.sort(a, dim=0).values
    lo = int(min(max(low, 0), n - 1))
    hi = int(min(max(high, 0), n - 1))
    return (s[lo].double() * float(w_low)
            + (s[hi] * float(w_high)).double()).float()


def _act_stats(x: torch.Tensor) -> torch.Tensor:
    """Per-channel calibration statistics of an NCHW activation, (2, C) =
    ``[amax_c, p999_c]``: the channel abs-max and the 99.9th percentile of
    |x| on a strided subsample of at most about 2²⁰ elements, its rows taken
    in NHWC order as the reference takes them."""
    c = x.shape[1]
    ax = x.detach().float().abs().permute(0, 2, 3, 1).reshape(-1, c)
    stride = max(1, ax.shape[0] // max(1, (1 << 20) // max(c, 1)))
    p999 = _quantile_linear(ax[::stride], 0.999)
    return torch.stack([ax.amax(0), p999])


def sow(module: nn.Module, name: str, x: torch.Tensor) -> None:
    """In :func:`calibration_mode`, record ``x``'s statistics under
    (``module``, ``name``), max-reduced with an earlier record there."""
    rec = _CALIBRATE.get()
    if rec is None:
        return
    stats = _act_stats(x)
    mine = rec.setdefault(module, {})
    mine[name] = stats if name not in mine else torch.maximum(mine[name],
                                                                stats)


class QT(NamedTuple):
    """An int8 activation between quantized convs (the int8 flow): ``i8``
    (B, C, H, W) int8, ``scale`` (C,) float32 per-channel dequant scale,
    ``dtype`` the float dtype a float consumer dequantizes to (the model's
    compute dtype)."""
    i8: torch.Tensor
    scale: torch.Tensor
    dtype: torch.dtype = torch.float32

    @property
    def shape(self):
        return self.i8.shape


def _chan(v: torch.Tensor) -> torch.Tensor:
    return v.view(1, -1, 1, 1)


def q_dequant(x, dtype: torch.dtype = torch.float32):
    """QT → float tensor (the boundary to an unquantized consumer); a float
    tensor passes as it is."""
    if isinstance(x, QT):
        return (x.i8.float() * _chan(x.scale)).to(dtype)
    return x


def silu_as_reference(x: torch.Tensor) -> torch.Tensor:
    """``x·σ(x)``, flax's ``nn.silu`` as written: the int8 paths requantize
    right after it, so it rounds as the reference's does (``F.silu``'s
    fused form differs in the last bit for a quarter of its inputs, and a
    last bit at a .5 boundary flips an int8 code)."""
    return x * torch.sigmoid(x)


def _dequant_add(x, y) -> torch.Tensor:
    """``q_dequant(x) + q_dequant(y)`` in float32 with the first QT's
    product fused into the add (one rounding), as XLA compiles the
    reference's sum."""
    if isinstance(x, QT):
        return torch.addcmul(q_dequant(y).float(), x.i8.float(),
                             _chan(x.scale))
    return torch.addcmul(x.float(), y.i8.float(), _chan(y.scale))


def q_requant(y: torch.Tensor, scale: torch.Tensor,
              dtype: torch.dtype = torch.float32) -> QT:
    """Float tensor → QT under the per-channel ``scale`` (divided, as the
    reference divides)."""
    y_i8 = torch.clamp(torch.round(y.float() / _chan(scale)), -127.0, 127.0)
    return QT(y_i8.to(torch.int8), scale, dtype)


def q_cat(parts, dim: int = 1):
    """Channel concat that keeps the int8 flow: all-QT parts concat as int8
    with their scale vectors concatenated; any float part demotes the whole
    concat to float, the QT parts dequantized to the float parts' dtype
    (the reference's float32 concat is cast to that dtype by the conv it
    feeds). Scales are per channel, so a QT concat over any axis but the
    channel one (1 in NCHW) raises."""
    if all(isinstance(p, QT) for p in parts):
        if dim not in (1, 1 - parts[0].i8.ndim):
            raise ValueError(f"q_cat over QT parts only supports the "
                             f"channel axis (1 in NCHW); got dim={dim}")
        return QT(torch.cat([p.i8 for p in parts], dim=1),
                  torch.cat([p.scale for p in parts]), parts[0].dtype)
    dt = next(p.dtype for p in parts if not isinstance(p, QT))
    return torch.cat([q_dequant(p, dt) for p in parts], dim=dim)


def _quant_of(m: nn.Module) -> Optional[nn.Module]:
    """The ``quant`` submodule ``ops/quant.attach_quant`` gave ``m``, or
    None."""
    return m._modules.get("quant")


class LayerQuant(nn.Module):
    """Per-layer W8A8 conv+BN (the reference's ``conv_bn_maybe_quant``
    serving branch): the input quantized per tensor by its calibrated
    static scale, the BN-folded weight per output channel, the int8 conv,
    then ``y·out_scale + bias`` in float32, cast to ``dtype``."""

    def __init__(self, w_q, out_scale, bias, inv_in_scale, *, stride: int,
                 pad: int, groups: int, dtype: torch.dtype):
        super().__init__()
        self.register_buffer("w_q", w_q)
        self.register_buffer("out_scale", out_scale)
        self.register_buffer("bias", bias)
        self.register_buffer("inv_in_scale", inv_in_scale)
        self.stride, self.pad, self.groups = stride, pad, groups
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_q = torch.clamp(torch.round(x.float() * self.inv_in_scale),
                          -127.0, 127.0).to(torch.int8)
        y = int8_conv2d(x_q, self.w_q, self.stride, self.pad, self.groups)
        return torch.addcmul(_chan(self.bias), y.float(),
                             _chan(self.out_scale)).to(self.dtype)


class FlowQuant(nn.Module):
    """A ``ConvBnAct`` in the int8 flow (the reference's ``_int8_flow``):
    int8 in (a QT, or a float tensor quantized by the per-channel
    ``in_scale``), the incoming scales folded into the BN-folded float
    weight ``w_f`` and the result quantized per output channel, the int8
    conv, ``y·s_w + bias`` in float32, SiLU, then a QT under ``out_scale``,
    or float in ``dtype`` where the tree stores none (head-boundary convs).

    The reference folds on every trace; the incoming scales are static (each
    producer emits its calibrated scale), so the fold runs once, on the
    first call (``ops/quant.attach_quant`` makes that call), and its
    ``w_q``/``s_w`` are kept as buffers."""

    def __init__(self, w_f, bias, in_scale, out_scale=None, *, stride: int,
                 pad: int, groups: int, act: bool, dtype: torch.dtype):
        super().__init__()
        self.register_buffer("w_f", w_f)
        self.register_buffer("bias", bias)
        self.register_buffer("in_scale", in_scale)
        self.register_buffer("out_scale", out_scale)
        self.register_buffer("w_q", None)
        self.register_buffer("s_w", None)
        self.stride, self.pad, self.groups = stride, pad, groups
        self.act, self.dtype = act, dtype

    @torch.no_grad()
    def fold(self, s_vec: torch.Tensor) -> None:
        """``w_q``, ``s_w`` from ``w_f`` and the incoming per-channel
        scales: group j's output block takes its own slice of ``s_vec``."""
        w_f = self.w_f
        co, cig = w_f.shape[:2]
        s = s_vec.reshape(self.groups, cig).repeat_interleave(
            co // self.groups, dim=0)                         # (co, cig)
        w_eff = w_f * s[:, :, None, None]
        s_w = w_eff.abs().amax(dim=(1, 2, 3)) / 127.0
        s_w = torch.where(s_w > 0, s_w, torch.ones_like(s_w))
        self.w_q = torch.clamp(torch.round(w_eff / s_w[:, None, None, None]),
                               -127.0, 127.0).to(torch.int8)
        self.s_w = s_w

    def forward(self, x):
        if isinstance(x, QT):
            x_i8, s_vec = x.i8, x.scale
        else:
            s_vec = self.in_scale
            x_i8 = torch.clamp(torch.round(x.float() / _chan(s_vec)),
                               -127.0, 127.0).to(torch.int8)
        if self.w_q is None:
            self.fold(s_vec)
        y = int8_conv2d(x_i8, self.w_q, self.stride, self.pad, self.groups)
        y = torch.addcmul(_chan(self.bias), y.float(), _chan(self.s_w))
        if self.act:
            y = silu_as_reference(y)
        if self.out_scale is not None:
            return q_requant(y, self.out_scale, self.dtype)
        return y.to(self.dtype)


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
    with the same batch statistics but must not move them a second time.

    ``shard`` (rank, world), set by the data-parallel train step
    (``train/trainer.py``) for its duration: over more than one rank,
    training mode normalizes with the statistics of the global batch
    (:meth:`_synced`), as the reference's does under GSPMD."""

    hold_stats = False
    shard = (0, 1)

    def forward(self, x):
        if not self.training or self.momentum is None:
            return super().forward(x)
        if self.shard[1] > 1:
            return self._synced(x)
        if not self.hold_stats:
            with torch.no_grad():
                var, mean = torch.var_mean(x.float(), dim=(0, 2, 3),
                                           correction=0)
                self.running_mean.lerp_(mean, self.momentum)
                self.running_var.lerp_(var, self.momentum)
                self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)

    def _synced(self, x):
        """Training over several ranks: normalize with the global
        batch's statistics, from one all-reduce of the float32 sums of x
        and x² and the count (the reference's GSPMD BatchNorm sees the
        global batch; its flax variance is the same one-pass
        E[x²] − E[x]²). The all-reduce is differentiable, so the backward
        carries the global statistics' gradient. The running statistics
        move toward the global mean and biased variance on every rank
        alike (``torch.nn.SyncBatchNorm`` would move them toward the
        unbiased one)."""
        c = x.shape[1]
        xf = x.float()
        count = xf.new_full((1,), float(x.numel() // c))
        tot = all_reduce_sum_grad(torch.cat(
            [xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3)), count]))
        n = tot[2 * c]
        mean = tot[:c] / n
        var = torch.clamp(tot[c:2 * c] / n - mean * mean, min=0.0)
        if not self.hold_stats:
            with torch.no_grad():
                self.running_mean.lerp_(mean.detach(), self.momentum)
                self.running_var.lerp_(var.detach(), self.momentum)
                self.num_batches_tracked.add_(1)
        scale = self.weight * torch.rsqrt(var + self.eps)
        shift = self.bias - mean * scale
        return (xf * scale.view(1, c, 1, 1) +
                shift.view(1, c, 1, 1)).to(x.dtype)


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


def conv2d(owner: nn.Module, conv: nn.Conv2d, x: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``conv``'s convolution of ``x`` with its weight cast to ``x``'s
    dtype (and ``bias``, already cast, or none), its H halo taken first
    where a spatial shard is active on ``owner``
    (``parallel.spatial.windowed``): the one place every float
    convolution of the models goes through."""
    k = conv.dilation[0] * (conv.kernel_size[0] - 1) + 1
    x, pad_h = windowed(owner, x, k, conv.stride[0], conv.padding[0])
    return F.conv2d(x, conv.weight.to(x.dtype), bias, conv.stride,
                    (pad_h, conv.padding[1]), conv.dilation, conv.groups)


class CastConv2d(nn.Conv2d):
    """A conv whose float32 weight and bias are cast to the dtype of its
    input where it runs (flax's ``nn.Conv(dtype=…)``)."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return conv2d(self, self, x, bias)


class CastLinear(nn.Linear):
    """A dense layer whose float32 weight and bias are cast to the dtype of
    its input where it runs (flax's ``nn.Dense(dtype=…)``)."""

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


def conv_bn(owner: nn.Module, conv_name: str, x: torch.Tensor
            ) -> torch.Tensor:
    """Conv → BN of the sibling pair ``conv_name``/``conv_name.replace(
    "conv", "bn")`` of ``owner`` (the ResNet layout), with the W8A8 hooks:
    in calibration it records the input under ``{conv_name}_in_amax``;
    with a :class:`LayerQuant` on the conv it runs that instead."""
    conv = owner._modules[conv_name]
    sow(owner, conv_name + "_in_amax", x)
    q = _quant_of(conv)
    if q is not None:
        return q(x)
    x = conv2d(owner, conv, x)
    return owner._modules[conv_name.replace("conv", "bn")](x)


class ConvBnAct(nn.Module):
    """Conv → BN → SiLU, the universal YOLOv5 block ("Conv"). The conv's
    float32 weight is cast to the input's dtype where it is used. Its
    ``quant`` submodule, where ``ops/quant.attach_quant`` set one, runs
    the int8 modes; a QT reaching a float one is dequantized first."""

    def __init__(self, cin: int, cout: int, kernel: int = 1, stride: int = 1,
                 groups: int = 1, act: bool = True, pad: int | None = None):
        super().__init__()
        p = autopad(kernel) if pad is None else pad
        self.conv = nn.Conv2d(cin, cout, kernel, stride, p, groups=groups,
                              bias=False)
        self.bn = BatchNorm2d(cout, eps=1e-3, momentum=0.03)
        self.act = act

    def forward(self, x):
        q = _quant_of(self)
        if isinstance(q, FlowQuant):
            return q(x)
        if isinstance(x, QT):
            x = q_dequant(x, x.dtype)
        sow(self, "in_amax", x)
        if q is not None:
            x = q(x)
            x = silu_as_reference(x) if self.act else x
        else:
            x = conv2d(self, self.conv, x)
            x = F.silu(self.bn(x)) if self.act else self.bn(x)
        sow(self, "out_amax", x)
        return x


class Bottleneck(nn.Module):
    """1x1 → 3x3 with optional residual add (YOLOv5 Bottleneck). In the
    int8 flow the add dequantizes both sides to float32 and requantizes
    the sum under its own calibrated ``res_scale`` buffer, where the
    tree gave one."""

    def __init__(self, cin: int, cout: int, shortcut: bool = True,
                 expansion: float = 0.5):
        super().__init__()
        hidden = int(cout * expansion)
        self.cv1 = ConvBnAct(cin, hidden, 1)
        self.cv2 = ConvBnAct(hidden, cout, 3)
        self.add = shortcut and cin == cout

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        if not self.add:
            return y
        if isinstance(x, QT) or isinstance(y, QT):
            dtype = (x if isinstance(x, QT) else y).dtype
            z = _dequant_add(x, y)
            res_scale = self._buffers.get("res_scale")
            if res_scale is not None:
                return q_requant(z, res_scale, dtype)
            return z.to(dtype)
        y = x + y
        sow(self, "res_amax", y)
        return y


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
        return self.cv3(q_cat([y1, self.cv2(x)], dim=1))


class SPPF(nn.Module):
    """Spatial pyramid pooling — fast (3 chained 5x5 max-pools). A QT pools
    its int8 payload (max commutes with a positive per-channel scale),
    through bfloat16, which holds every int8 value exactly; the pool's
    implicit −inf padding then equals the reference's int8-min padding,
    since every window holds a value ≥ −127."""

    def __init__(self, cin: int, cout: int, pool: int = 5):
        super().__init__()
        hidden = cin // 2
        self.cv1 = ConvBnAct(cin, hidden, 1)
        self.cv2 = ConvBnAct(4 * hidden, cout, 1)
        self.pool = pool

    def _pool(self, v):
        p = self.pool // 2
        if isinstance(v, QT):
            pooled = F.max_pool2d(v.i8.to(torch.bfloat16), self.pool, 1, p)
            return QT(pooled.to(torch.int8), v.scale, v.dtype)
        v, pad_h = windowed(self, v, self.pool, 1, p, float("-inf"))
        return F.max_pool2d(v, self.pool, 1, (pad_h, p))

    def forward(self, x):
        x = self.cv1(x)
        y1 = self._pool(x)
        y2 = self._pool(y1)
        y3 = self._pool(y2)
        return self.cv2(q_cat([x, y1, y2, y3], dim=1))


def upsample2x(x):
    """Nearest 2x upsample of an NCHW tensor; a QT upsamples its int8
    payload (by broadcasting in NHWC, which keeps channels-last memory and
    needs no int8 interpolation) and keeps its scales."""
    if isinstance(x, QT):
        b, c, h, w = x.i8.shape
        n = x.i8.permute(0, 2, 3, 1)[:, :, None, :, None, :]
        up = n.expand(b, h, 2, w, 2, c).reshape(b, 2 * h, 2 * w, c)
        return QT(up.permute(0, 3, 1, 2), x.scale, x.dtype)
    return F.interpolate(x, scale_factor=2, mode="nearest")
