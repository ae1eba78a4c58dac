"""Plain float32 building blocks shared by the references: layers whose
inputs and weights can be cast (the precision control), box arithmetic,
greedy NMS, the AdamW schedule and the EMA.

Nothing here imports the program under test or JAX. Every function is the
slow, obvious form of what it names, after the published description cited
beside it. Callers turn TF32 off (``no_tf32``) so float32 means float32 on
the card.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

EPS = 1e-7


@contextlib.contextmanager
def no_tf32():
    """Matrix products and convolutions in true float32 on the card."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _fp8(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """``x`` rounded to ``dtype`` under one per-tensor scale that maps its
    largest magnitude to ``top``, back in float32."""
    scale = x.abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).float() * scale


class _FP8Cast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2, 57344.0)


def fp8_cast(x: torch.Tensor) -> torch.Tensor:
    """The control's precision, the step below bfloat16, as FP8 training
    runs it (Micikevicius et al. 2022): a product's operands in float8
    e4m3 and the gradient that reaches them in e5m2, each under one
    per-tensor scale, computed in float32."""
    return _FP8Cast.apply(x)


class QConv2d(nn.Conv2d):
    """``nn.Conv2d`` whose input and weight pass through ``cast`` first
    (None: float32 as given)."""

    cast: Optional[Callable] = None

    def forward(self, x):
        if self.cast is None:
            return super().forward(x)
        return self._conv_forward(self.cast(x), self.cast(self.weight),
                                  self.bias)


class QLinear(nn.Linear):
    """``nn.Linear`` with the cast of :class:`QConv2d`."""

    cast: Optional[Callable] = None

    def forward(self, x):
        if self.cast is None:
            return super().forward(x)
        return F.linear(self.cast(x), self.cast(self.weight), self.bias)


def set_cast(model: nn.Module, cast: Optional[Callable]) -> None:
    """Set the cast of every :class:`QConv2d` and :class:`QLinear`."""
    for m in model.modules():
        if isinstance(m, (QConv2d, QLinear)):
            m.cast = cast


# the name of the set-up part in which the reference calibrates the seeded
# weights: its seconds are the reference's, not the program's set-up
REFERENCE_PART = "reference: calibration"


def calibrate_bn(model: nn.Module, run: Callable[[], None]) -> None:
    """Every BatchNorm's running statistics set to those of its input in
    one call of ``run`` (cumulative average, training mode), the rest of
    the model left as it was."""
    bns = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
    saved = [(m.momentum, m.training) for m in bns]
    for m in bns:
        m.reset_running_stats()
        m.momentum = None
        m.train()
    with torch.no_grad():
        run()
    for m, (mom, tr) in zip(bns, saved):
        m.momentum = mom
        m.train(tr)


# ---------------------------------------------------------------------------
# boxes (torchvision's BoxCoder, box_iou, clip_boxes_to_image)
# ---------------------------------------------------------------------------

def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., N, 4) x (..., M, 4) xyxy → (..., N, M)."""
    area_a = ((a[..., 2] - a[..., 0]).clamp(min=0) *
              (a[..., 3] - a[..., 1]).clamp(min=0))
    area_b = ((b[..., 2] - b[..., 0]).clamp(min=0) *
              (b[..., 3] - b[..., 1]).clamp(min=0))
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area_a[..., :, None] + area_b[..., None, :] - inter + EPS)


def encode(ref: torch.Tensor, gt: torch.Tensor,
           weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    wr, hr = ref[..., 2] - ref[..., 0], ref[..., 3] - ref[..., 1]
    xr, yr = ref[..., 0] + 0.5 * wr, ref[..., 1] + 0.5 * hr
    wg, hg = gt[..., 2] - gt[..., 0], gt[..., 3] - gt[..., 1]
    xg, yg = gt[..., 0] + 0.5 * wg, gt[..., 1] + 0.5 * hg
    return torch.stack([weights[0] * (xg - xr) / (wr + EPS),
                        weights[1] * (yg - yr) / (hr + EPS),
                        weights[2] * torch.log(wg.clamp(min=EPS) / (wr + EPS)),
                        weights[3] * torch.log(hg.clamp(min=EPS) / (hr + EPS))],
                       -1)


def decode(ref: torch.Tensor, d: torch.Tensor, weights=(1.0, 1.0, 1.0, 1.0),
           clamp: float = math.log(1000.0 / 16)) -> torch.Tensor:
    wr, hr = ref[..., 2] - ref[..., 0], ref[..., 3] - ref[..., 1]
    xr, yr = ref[..., 0] + 0.5 * wr, ref[..., 1] + 0.5 * hr
    dx, dy = d[..., 0] / weights[0], d[..., 1] / weights[1]
    dw = (d[..., 2] / weights[2]).clamp(max=clamp)
    dh = (d[..., 3] / weights[3]).clamp(max=clamp)
    cx, cy = dx * wr + xr, dy * hr + yr
    w, h = torch.exp(dw) * wr, torch.exp(dh) * hr
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w,
                        cy + 0.5 * h], -1)


def clip(b: torch.Tensor, size: float) -> torch.Tensor:
    return b.clamp(0.0, size)


def greedy_nms(boxes: torch.Tensor, iou_thres: float) -> torch.Tensor:
    """Keep mask (B, N) of score-sorted boxes (B, N, 4): box j goes when a
    kept box before it overlaps it by IoU > ``iou_thres`` (torchvision's
    strict test); all-zero rows overlap nothing."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    iw = (torch.minimum(x2[..., :, None], x2[..., None, :]) -
          torch.maximum(x1[..., :, None], x1[..., None, :])).clamp(min=0)
    ih = (torch.minimum(y2[..., :, None], y2[..., None, :]) -
          torch.maximum(y1[..., :, None], y1[..., None, :])).clamp(min=0)
    inter = iw * ih
    sup = inter > iou_thres * (area[..., :, None] + area[..., None, :]
                               - inter + EPS)
    n = boxes.shape[-2]
    sup &= torch.ones((n, n), dtype=torch.bool, device=boxes.device).triu(1)
    keep = torch.ones(boxes.shape[:-1], dtype=torch.bool, device=boxes.device)
    for i in range(n):
        keep &= ~(sup[:, i, :] & keep[:, i:i + 1])
    return keep


def topk_stable(x: torch.Tensor, k: int):
    """Top-k along the last dim, equal values lower index first."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def class_nms(boxes, scores, classes, *, score_thres: float,
              iou_thres: float, pre_nms_topk: int, max_det: int,
              class_aware: bool = True, offset: float = 8192.0):
    """Score filter (> ``score_thres``), the top ``pre_nms_topk``, greedy
    NMS (per class through a class offset), the top ``max_det`` kept:
    boxes (B, max_det, 4), scores, classes (−1 where empty), valid."""
    s = torch.where(scores > score_thres, scores, torch.full_like(scores, -1))
    k = min(pre_nms_topk, s.shape[1])
    ts, ti = topk_stable(s, k)
    tb = torch.gather(boxes, 1, ti[..., None].expand(-1, -1, 4))
    tc = torch.gather(classes, 1, ti)
    valid = ts > 0
    nb = tb + tc.float()[..., None] * offset if class_aware else tb
    nb = torch.where(valid[..., None], nb, torch.zeros_like(nb))
    keep = greedy_nms(nb, iou_thres) & valid
    ks = torch.where(keep, ts, torch.full_like(ts, -1))
    md = min(max_det, k)
    os_, oi = topk_stable(ks, md)
    ov = os_ > 0
    ob = torch.where(ov[..., None],
                     torch.gather(tb, 1, oi[..., None].expand(-1, -1, 4)),
                     torch.zeros(()).to(tb))
    oc = torch.where(ov, torch.gather(tc, 1, oi), -1)
    return ob, torch.where(ov, os_, torch.zeros_like(os_)), oc, ov


# ---------------------------------------------------------------------------
# optimizer (AdamW, Loshchilov & Hutter 2019), schedule, clip, EMA
# ---------------------------------------------------------------------------

def warmup_cosine_lr(step: int, base: float, total: int, warmup: int,
                     final_frac: float) -> float:
    """Linear warmup from 0, then cosine to ``base · final_frac``; the rate
    of the update that follows ``step`` earlier updates."""
    warmup = max(int(warmup), 1)
    if step < warmup:
        return base * step / warmup
    decay = max(int(total) - warmup, 1)
    t = min(step - warmup, decay)
    return base * ((1 - final_frac) * 0.5 * (1 + math.cos(math.pi * t / decay))
                   + final_frac)


class PlainAdamW:
    """AdamW over named float32 tensors: the global-norm clip (scale by
    max/norm when the norm exceeds max), moments m and v, bias correction,
    decoupled decay on tensors of two or more dimensions, the warmup-cosine
    rate."""

    def __init__(self, params: Dict[str, torch.Tensor], tc: Dict,
                 steps_per_epoch: int):
        self.params = params
        self.tc = tc
        self.total = steps_per_epoch * tc["epochs"]
        self.warmup = int(tc["warmup_epochs"] * steps_per_epoch)
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One update; returns the gradients as clipped (what the moments
        got)."""
        tc = self.tc
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
        scale = 1.0
        if tc["grad_clip"] is not None and float(norm) > tc["grad_clip"]:
            scale = tc["grad_clip"] / float(norm)
        b1, b2 = tc["betas"]
        lr = warmup_cosine_lr(self.count, tc["lr"], self.total, self.warmup,
                              tc["final_lr_frac"])
        self.count += 1
        t = self.count
        clipped = {}
        for k, p in self.params.items():
            g = grads[k] * scale
            clipped[k] = g
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).add_(g * g, alpha=1 - b2)
            mhat = self.m[k] / (1 - b1 ** t)
            vhat = self.v[k] / (1 - b2 ** t)
            if p.ndim >= 2:
                p.mul_(1 - lr * tc["weight_decay"])
            p.sub_(lr * mhat / (vhat.sqrt() + tc["eps"]))
        return clipped


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor],
               updates_before: int, base: float, tau: float) -> None:
    """Ultralytics' ModelEMA: d = base·(1 − exp(−n/tau)) at the count n of
    earlier updates; ema ← d·ema + (1 − d)·params."""
    d = base * (1 - math.exp(-updates_before / tau))
    for k, p in params.items():
        ema[k].mul_(d).add_(p.detach(), alpha=1 - d)


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tensors.items()}


def worst_leaf_gap(got: Dict[str, float], want: Dict[str, float],
                   names: Sequence[str]) -> tuple:
    """The largest |got − want| over ``names``, each over the larger of the
    leaf's own ``want`` and the median ``want`` of ``names``; and the leaf
    that gives it."""
    if not names:
        return 0.0, None
    med = sorted(want[n] for n in names)[len(names) // 2]
    worst, which = 0.0, None
    for n in names:
        gap = abs(got[n] - want[n]) / max(want[n], med, 1e-30)
        if gap > worst:
            worst, which = gap, n
    return worst, which


def median_leaf_gap(got: Dict[str, float], want: Dict[str, float],
                    names: Sequence[str]) -> float:
    """The median over ``names`` of the gap :func:`worst_leaf_gap` takes
    the largest of: steady from seed to seed where one small leaf is not."""
    if not names:
        return 0.0
    med = sorted(want[n] for n in names)[len(names) // 2]
    gaps = sorted(abs(got[n] - want[n]) / max(want[n], med, 1e-30)
                  for n in names)
    return gaps[len(gaps) // 2]


def moved_leaves(grad_norms: Dict[str, float], names: List[str]) -> List[str]:
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's: the others move by round-off alone under Adam."""
    if not names:
        return []
    med = sorted(grad_norms[n] for n in names)[len(names) // 2]
    return [n for n in names if grad_norms[n] >= 1e-3 * med]
