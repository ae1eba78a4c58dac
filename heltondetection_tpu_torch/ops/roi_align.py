"""RoIAlign and RoIPool; counterpart of
heltondetection_tpu/ops/roi_align.py (torchvision semantics: ``aligned``
False by default, so no half-pixel shift and rois at least 1 px; a fixed
sampling ratio; RoIPool as a 4-sample max per bin on the quantized grid).

The reference is plain XLA, not a Pallas kernel, and so is this: torch
gathers. Feature maps are NHWC (an NCHW tensor in channels-last memory,
permuted, is one without a copy), so every bilinear tap is one row of a
(pixels, C) table. :func:`multilevel_roi_align` flattens the pyramid of a
whole batch into one such table and gathers, per pooled bin, the 4 taps of
its s² samples as 4·s² rows, weighted and summed by one batched matmul.
The reference's quad-shifted layout (each level concatenated with its x-,
y- and xy-rolled copies, so one row holds all four taps) is a TPU layout
for the same function; its roll wraparound only ever meets a tap weight of
exactly 0, where this version clamps the tap index instead, as torchvision
does. The tap weights are in the feature dtype with the 1/s² bin mean
folded in, and the result is in the feature dtype.

The backward pass of RoIAlign is the reference's custom VJP
(``_wgather_pool_bwd``), an ``autograd.Function`` here
(:class:`_WeightedGather`): it builds every tap's row, its weight times its
bin's cotangent, in one pass and scatter-adds them into the pyramid's rows
(``index_add_``). The rois and the tap weights get no gradient, as in the
reference, where the rois are stop-gradient. RoIPool keeps autograd's
``amax`` backward, which splits a bin's cotangent among equal maxima as
JAX's does.
"""

from __future__ import annotations

from typing import Sequence

import torch


class _WeightedGather(torch.autograd.Function):
    """``out[i] = Σ_t w[i, t] · flat[idx[i, t]]``: flat (rows, C), idx and
    w (bins, T) → (bins, C) in flat's dtype, by one row gather and a
    batched matmul. Its backward scatter-adds ``w[i, t] · g[i]`` into row
    ``idx[i, t]`` of a zero (rows, C) gradient, in flat's dtype; idx and w
    get none."""

    @staticmethod
    def forward(ctx, flat, idx, w):
        n_bins, t = idx.shape
        taps = flat[idx.reshape(-1)].reshape(n_bins, t, flat.shape[1])
        ctx.save_for_backward(idx, w)
        ctx.rows = flat.shape[0]
        return torch.bmm(w[:, None, :], taps)[:, 0]

    @staticmethod
    def backward(ctx, g):
        idx, w = ctx.saved_tensors
        c = g.shape[1]
        upd = w[:, :, None] * g.to(w.dtype)[:, None, :]
        grad = torch.zeros((ctx.rows, c), dtype=w.dtype, device=g.device)
        grad.index_add_(0, idx.reshape(-1), upd.reshape(-1, c))
        return grad, None, None


def _bilinear_gather(feat: torch.Tensor, ys: torch.Tensor,
                     xs: torch.Tensor) -> torch.Tensor:
    """feat (H, W, C); sample coordinates of one shape → (..., C) bilinear
    values, zero where a sample lies outside (-1, H) x (-1, W)."""
    h, w = feat.shape[0], feat.shape[1]
    valid = (ys > -1.0) & (ys < h) & (xs > -1.0) & (xs < w)
    ys = ys.clamp(0.0, h - 1.0)
    xs = xs.clamp(0.0, w - 1.0)
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    y1 = torch.clamp(y0 + 1, max=h - 1.0)
    x1 = torch.clamp(x0 + 1, max=w - 1.0)
    ly = ys - y0
    lx = xs - x0
    y0i, y1i, x0i, x1i = (t.long() for t in (y0, y1, x0, x1))
    out = (feat[y0i, x0i] * ((1 - ly) * (1 - lx))[..., None] +
           feat[y0i, x1i] * ((1 - ly) * lx)[..., None] +
           feat[y1i, x0i] * (ly * (1 - lx))[..., None] +
           feat[y1i, x1i] * (ly * lx)[..., None])
    return out * valid[..., None]


def roi_align(feat: torch.Tensor, rois: torch.Tensor, *, out_size: int = 7,
              spatial_scale: float = 1.0, sampling_ratio: int = 2,
              aligned: bool = False) -> torch.Tensor:
    """RoIAlign over one map: feat (H, W, C) of one image, rois (N, 4) xyxy
    in input pixels → (N, out_size, out_size, C)."""
    offset = 0.5 if aligned else 0.0
    x1, y1, x2, y2 = (rois[:, k] * spatial_scale - offset for k in range(4))
    if aligned:
        rw, rh = x2 - x1, y2 - y1
    else:
        rw = torch.clamp(x2 - x1, min=1.0)
        rh = torch.clamp(y2 - y1, min=1.0)
    s = sampling_ratio
    g = (torch.arange(out_size * s, device=rois.device) + 0.5) / s
    ys = y1[:, None] + g[None, :] * (rh / out_size)[:, None]
    xs = x1[:, None] + g[None, :] * (rw / out_size)[:, None]
    n = rois.shape[0]
    yy = ys[:, :, None].expand(n, out_size * s, out_size * s)
    xx = xs[:, None, :].expand(n, out_size * s, out_size * s)
    vals = _bilinear_gather(feat, yy, xx)
    c = vals.shape[-1]
    return vals.reshape(n, out_size, s, out_size, s, c).mean(dim=(2, 4))


def roi_pool(feat: torch.Tensor, rois: torch.Tensor, *, out_size: int = 7,
             spatial_scale: float = 1.0) -> torch.Tensor:
    """RoIPool over one map: the max of a fixed 4x4 sample grid per bin of
    the quantized roi; feat (H, W, C), rois (N, 4) → (N, out, out, C)."""
    x1, y1, x2, y2 = (torch.round(rois[:, k] * spatial_scale)
                      for k in range(4))
    rw = torch.clamp(x2 - x1 + 1, min=1.0)
    rh = torch.clamp(y2 - y1 + 1, min=1.0)
    s = 4
    g = (torch.arange(out_size * s, device=rois.device) + 0.5) / s / out_size
    ys = y1[:, None] + g[None, :] * rh[:, None]
    xs = x1[:, None] + g[None, :] * rw[:, None]
    n = rois.shape[0]
    h, w = feat.shape[0], feat.shape[1]
    yy = ys[:, :, None].expand(n, out_size * s, out_size * s)
    xx = xs[:, None, :].expand(n, out_size * s, out_size * s)
    vals = feat[yy.clamp(0, h - 1).long(), xx.clamp(0, w - 1).long()]
    c = vals.shape[-1]
    return vals.reshape(n, out_size, s, out_size, s, c).amax(dim=(2, 4))


def _roi_levels(rois: torch.Tensor, num_levels: int, canonical_level: int,
                canonical_size: float) -> torch.Tensor:
    """torchvision's MultiScaleRoIAlign level of each roi:
    clamp(floor(k0 + log2(sqrt(area) / 224)), levels), as int64."""
    areas = ((rois[..., 2] - rois[..., 0]).clamp(min=0.0) *
             (rois[..., 3] - rois[..., 1]).clamp(min=0.0))
    target = torch.floor(canonical_level +
                         torch.log2(torch.sqrt(areas) / canonical_size + 1e-8))
    return target.clamp(0, num_levels - 1).long()


def multilevel_roi_align(feats: Sequence[torch.Tensor], rois: torch.Tensor,
                         strides: Sequence[int], *, out_size: int = 7,
                         sampling_ratio: int = 2,
                         canonical_size: float = 224.0,
                         canonical_level: int = 2, aligned: bool = False,
                         method: str = "align") -> torch.Tensor:
    """Level-aware RoIAlign (torchvision's MultiScaleRoIAlign) over a
    batch: feats, one (B, H_l, W_l, C) map per stride in ``strides``; rois
    (B, R, 4) xyxy in input pixels → (B, R, out, out, C) in the features'
    dtype. Each roi pools only from its own level (:func:`_roi_levels`).
    ``method="pool"`` is the RoIPool ablation on the same levels."""
    b, r = rois.shape[:2]
    dev = rois.device
    c = feats[0].shape[-1]
    n_lvl = len(feats)
    rois = rois.detach().float()
    target = _roi_levels(rois, n_lvl, canonical_level, canonical_size)
    sizes = [f.shape[1] * f.shape[2] for f in feats]
    # the batch's pyramid as one (rows, C) table: level by level, each
    # level image by image
    flat = torch.cat([f.reshape(-1, c) for f in feats], dim=0)
    starts = torch.tensor([0] + [b * n for n in sizes[:-1]],
                          device=dev).cumsum(0)
    hs = torch.tensor([float(f.shape[1]) for f in feats], device=dev)
    ws = torch.tensor([float(f.shape[2]) for f in feats], device=dev)
    scales = torch.tensor([1.0 / s for s in strides], device=dev)
    per_img = torch.tensor(sizes, device=dev)

    r_scale = scales[target]                                   # (B, R)
    r_h = hs[target][..., None]
    r_w = ws[target][..., None]
    r_base = (starts[target] +
              torch.arange(b, device=dev)[:, None] * per_img[target])
    offset = 0.5 if aligned else 0.0
    if method == "align":
        x1 = rois[..., 0] * r_scale - offset
        y1 = rois[..., 1] * r_scale - offset
        x2 = rois[..., 2] * r_scale - offset
        y2 = rois[..., 3] * r_scale - offset
        if aligned:
            rw, rh = x2 - x1, y2 - y1
        else:
            rw = torch.clamp(x2 - x1, min=1.0)
            rh = torch.clamp(y2 - y1, min=1.0)
        s = sampling_ratio
        g = (torch.arange(out_size * s, device=dev) + 0.5) / s
        ys = y1[..., None] + g * (rh / out_size)[..., None]    # (B, R, os)
        xs = x1[..., None] + g * (rw / out_size)[..., None]
    else:
        x1 = torch.round(rois[..., 0] * r_scale)
        y1 = torch.round(rois[..., 1] * r_scale)
        rw = torch.clamp(torch.round(rois[..., 2] * r_scale) - x1 + 1,
                         min=1.0)
        rh = torch.clamp(torch.round(rois[..., 3] * r_scale) - y1 + 1,
                         min=1.0)
        s = 4
        g = (torch.arange(out_size * s, device=dev) + 0.5) / s / out_size
        ys = y1[..., None] + g * rh[..., None]
        xs = x1[..., None] + g * rw[..., None]

    # bin-major sample order (bin_y, bin_x, sub_y, sub_x): the s² samples
    # of a bin are consecutive
    t = out_size * out_size * s * s
    yy = ys.reshape(b, r, out_size, 1, s, 1).expand(
        b, r, out_size, out_size, s, s).reshape(b, r, t)
    xx = xs.reshape(b, r, 1, out_size, 1, s).expand(
        b, r, out_size, out_size, s, s).reshape(b, r, t)
    base = r_base[..., None]
    w_i = r_w.long()
    n_bins = b * r * out_size * out_size
    if method != "align":
        yi = torch.minimum(yy.clamp(min=0.0), r_h - 1.0).long()
        xi = torch.minimum(xx.clamp(min=0.0), r_w - 1.0).long()
        vals = flat[(base + yi * w_i + xi).reshape(-1)]
        return vals.reshape(n_bins, s * s, c).amax(dim=1).reshape(
            b, r, out_size, out_size, c)

    valid = (yy > -1.0) & (yy < r_h) & (xx > -1.0) & (xx < r_w)
    ycl = torch.minimum(yy.clamp(min=0.0), r_h - 1.0)
    xcl = torch.minimum(xx.clamp(min=0.0), r_w - 1.0)
    y0 = torch.floor(ycl)
    x0 = torch.floor(xcl)
    ly = ycl - y0
    lx = xcl - x0
    idx = base + y0.long() * w_i + x0.long()
    # the right and lower taps, clamped inside the map: where a clamp acts,
    # lx or ly is exactly 0 and so is the tap's weight
    dx = (x0 < r_w - 1.0).long()
    dy = (y0 < r_h - 1.0).long() * w_i
    idx4 = torch.stack([idx, idx + dx, idx + dy, idx + dy + dx], dim=-1)
    w4 = torch.stack([(1 - ly) * (1 - lx), (1 - ly) * lx,
                      ly * (1 - lx), ly * lx], dim=-1)
    w4 = (w4 * (valid[..., None] * (1.0 / (s * s)))).to(flat.dtype)
    out = _WeightedGather.apply(flat, idx4.reshape(n_bins, 4 * s * s),
                                w4.reshape(n_bins, 4 * s * s))
    return out.reshape(b, r, out_size, out_size, c)
