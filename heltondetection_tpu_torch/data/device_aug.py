"""On-device augmentation: mosaic crop, horizontal flip, colour jitter and
mixup as batched torch ops on the card; counterpart of
heltondetection_tpu/data/device_aug.py.

The host (``data.augment.DeviceAugPipeline``) only reads and letterboxes
each sample's tiles to the square train size and flips the mosaic coin;
everything else random runs here, inside the train step, before the model:

    images4 (B, 4, S, S, 3) uint8 ─┐
    boxes4  (B, 4, M, 4) xyxy      ├─ device_augment_batch → image (B, S, S,
    cls4/mask4 (B, 4, M)           │    3) float in [0, 1], gt_boxes (B, 4M
    mosaic4 (B,) bool              ┘    or 8M, 4) cxcywh, gt_cls, gt_mask

Mosaic: the four tiles make a 2S canvas (tile t at row t // 2, column
t % 2) and an S crop is taken at a uniform offset in [0, S]².

The functions take every random number as a tensor (:class:`AugDraws`), so
they can be held to the reference on the reference's own draws;
:func:`sample_draws` makes the draws from an explicit ``torch.Generator``.
The reference splits a ``jax.random`` key per sample, which torch cannot
reproduce, so the port's draws match the reference's in distribution only.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import torch


@dataclass
class AugDraws:
    """The random numbers of one batch of :func:`device_augment_batch`.

    ``oy``, ``ox`` (B,) int: the crop offset in [0, S] on the 2S canvas;
    ``flip`` (B,) bool; ``hsv`` (B, 3) float32: the hue angle in radians,
    the saturation and the value gains of :func:`rgb_jitter`; ``mix`` (B,)
    bool and ``mix_r`` (B,) float32: the mixup coin and ratio (None without
    mixup)."""
    oy: torch.Tensor
    ox: torch.Tensor
    flip: torch.Tensor
    hsv: torch.Tensor
    mix: Optional[torch.Tensor] = None
    mix_r: Optional[torch.Tensor] = None


def sample_draws(b: int, img_size: int, generator: torch.Generator, *,
                 flip_p: float = 0.5, h_gain: float = 0.015,
                 s_gain: float = 0.7, v_gain: float = 0.4,
                 mixup_p: float = 0.0, mixup_beta: float = 32.0) -> AugDraws:
    """Draws for a batch of ``b``, on ``generator``'s device, with the
    reference's distributions: offsets uniform on [0, S], the flip coin
    at ``flip_p``, the hue angle uniform on 2π·[−h_gain, h_gain), the
    saturation and value gains on 1 + [−gain, gain), the mixup coin at
    ``mixup_p`` and its ratio from Beta(mixup_beta, mixup_beta). The Beta
    draw is exact for an integer ``mixup_beta`` = a: the a-th smallest of
    2a − 1 uniforms (torch has no Beta sampler that takes a generator)."""
    dev = generator.device
    kw = dict(device=dev, generator=generator)
    oy = torch.randint(0, img_size + 1, (b,), **kw)
    ox = torch.randint(0, img_size + 1, (b,), **kw)
    flip = torch.rand(b, **kw) < flip_p
    u = torch.rand(b, 3, **kw) * 2.0 - 1.0                 # [-1, 1)
    gains = torch.tensor([h_gain * 2.0 * math.pi, s_gain, v_gain],
                         device=dev)
    hsv = u * gains + torch.tensor([0.0, 1.0, 1.0], device=dev)
    mix = mix_r = None
    if mixup_p > 0:
        a = int(mixup_beta)
        if a != mixup_beta or a < 1:
            raise ValueError(f"mixup_beta must be a positive integer, got "
                             f"{mixup_beta}")
        mix = torch.rand(b, **kw) < mixup_p
        mix_r = torch.rand(b, 2 * a - 1, **kw).kthvalue(a, dim=1).values
    return AugDraws(oy, ox, flip, hsv, mix, mix_r)


def rgb_jitter(img: torch.Tensor, hsv: torch.Tensor) -> torch.Tensor:
    """HSV-like colour jitter in RGB (float [0, 1] in and out) of a batch
    ``img`` (B, H, W, 3), with ``hsv`` (B, 3) = (hue angle, saturation
    gain, value gain) per image: saturation lerps toward the luma, hue
    rotates the channels about the grey axis (Rodrigues), value scales."""
    h, s, v = (t.view(-1, 1, 1) for t in hsv.float().unbind(-1))
    luma = (0.299 * img[..., 0] + 0.587 * img[..., 1] +
            0.114 * img[..., 2])[..., None]
    out = luma + (img - luma) * s[..., None]
    cos, sin = torch.cos(h), torch.sin(h)
    r, g, b = out.unbind(-1)
    third = (r + g + b) / 3.0
    rr = r * cos + (g - b) * sin * 0.57735 + third * (1 - cos)
    gg = g * cos + (b - r) * sin * 0.57735 + third * (1 - cos)
    bb = b * cos + (r - g) * sin * 0.57735 + third * (1 - cos)
    out = torch.stack([rr, gg, bb], dim=-1)
    return torch.clamp(out * v[..., None], 0.0, 1.0)


def device_mosaic(images4: torch.Tensor, boxes4: torch.Tensor,
                  cls4: torch.Tensor, mask4: torch.Tensor,
                  mosaic4: torch.Tensor, draws: AugDraws, *,
                  hsv: bool = True):
    """A batch of four letterboxed tiles each → (image (B, S, S, 3) float
    in [0, 1], gt (B, 4M, 4) cxcywh, cls (B, 4M), mask (B, 4M)).

    Where ``mosaic4`` is set: the S crop of the 2S canvas at (oy, ox), the
    tiles' boxes shifted into it, clipped to it and kept where wider and
    taller than 2 px. Elsewhere: tile 0 as it is, its boxes in the first M
    rows. Then the flip where ``draws.flip`` is set, /255 and, with
    ``hsv``, :func:`rgb_jitter`. The crop is gathered from the uint8 tiles
    directly; no canvas is built."""
    b, _, s, _, _ = images4.shape
    m = boxes4.shape[2]
    dev = images4.device
    ar = torch.arange(s, device=dev)
    rows = (draws.oy.view(b, 1).to(dev) + ar).view(b, s, 1)   # canvas
    cols = (draws.ox.view(b, 1).to(dev) + ar).view(b, 1, s)
    bi = torch.arange(b, device=dev).view(b, 1, 1)
    # tile (row half, column half) and the pixel inside it; the indices
    # broadcast to (B, S, S) without being materialized
    crop = images4.view(b, 2, 2, s, s, 3)[bi, rows // s, cols // s,
                                          rows % s, cols % s]
    use = mosaic4.view(b).to(dev)
    img = torch.where(use.view(b, 1, 1, 1), crop, images4[:, 0])

    # mosaic boxes: each tile's into canvas coordinates, minus the crop
    shift = torch.tensor([[0, 0], [0, s], [s, 0], [s, s]],
                         dtype=torch.float32, device=dev)  # (y, x) per tile
    off4 = torch.cat([shift.flip(1), shift.flip(1)], -1)   # x, y, x, y
    crop_off = torch.stack([draws.ox, draws.oy, draws.ox, draws.oy],
                           -1).to(dev, torch.float32)
    mb = boxes4 + off4.view(1, 4, 1, 4)
    mb = (mb - crop_off.view(b, 1, 1, 4)).reshape(b, 4 * m, 4)
    mb = mb.clamp(0.0, float(s))
    mmask = mask4.reshape(b, 4 * m) & ((mb[..., 2] - mb[..., 0]) > 2.0) & \
        ((mb[..., 3] - mb[..., 1]) > 2.0)
    # no mosaic: tile 0 only
    zb = torch.zeros((b, 3 * m, 4), dtype=mb.dtype, device=dev)
    nb = torch.cat([boxes4[:, 0].clamp(0.0, float(s)), zb], 1)
    ncls = torch.cat([cls4[:, 0], torch.zeros_like(cls4[:, 0]).repeat(1, 3)],
                     1)
    nmask = torch.cat([mask4[:, 0],
                       torch.zeros_like(mask4[:, 0]).repeat(1, 3)], 1)
    u = use.view(b, 1)
    boxes = torch.where(u[..., None], mb, nb)
    cls = torch.where(u, cls4.reshape(b, 4 * m), ncls)
    mask = torch.where(u, mmask, nmask)

    flip = draws.flip.view(b).to(dev)
    img = torch.where(flip.view(b, 1, 1, 1), img.flip(2), img)
    fb = torch.stack([s - boxes[..., 2], boxes[..., 1],
                      s - boxes[..., 0], boxes[..., 3]], -1)
    boxes = torch.where(flip.view(b, 1, 1), fb, boxes)

    img = img.float() / 255.0
    if hsv:
        img = rgb_jitter(img, draws.hsv.to(dev))
    gt = torch.stack([(boxes[..., 0] + boxes[..., 2]) * 0.5,
                      (boxes[..., 1] + boxes[..., 3]) * 0.5,
                      boxes[..., 2] - boxes[..., 0],
                      boxes[..., 3] - boxes[..., 1]], -1)
    gt = gt * mask[..., None]
    return img, gt, cls, mask


def device_augment_batch(batch: Dict[str, torch.Tensor], draws: AugDraws, *,
                         hsv: bool = True) -> Dict[str, torch.Tensor]:
    """``batch`` (``images4``, ``boxes4``, ``cls4``, ``mask4``, ``mosaic4``,
    from ``DeviceAugPipeline``) → a train-step batch (``image`` float in
    [0, 1], ``gt_boxes``, ``gt_cls``, ``gt_mask``), through
    :func:`device_mosaic`. With mixup draws, each image blends with its
    batch neighbour (a roll by one) at ratio ``mix_r`` where ``mix`` is
    set, and the labels are the union, unweighted: the gt width doubles
    to 8M."""
    img, gt, cls, mask = device_mosaic(
        batch["images4"], batch["boxes4"], batch["cls4"], batch["mask4"],
        batch["mosaic4"], draws, hsv=hsv)
    if draws.mix is not None:
        coin = draws.mix.to(img.device)
        r = torch.where(coin, draws.mix_r.to(img.device),
                        torch.ones_like(draws.mix_r, device=img.device))
        r = r.view(-1, 1, 1, 1)
        img = img * r + torch.roll(img, -1, 0) * (1.0 - r)
        gt = torch.cat([gt, torch.roll(gt, -1, 0)], 1)
        cls = torch.cat([cls, torch.roll(cls, -1, 0)], 1)
        mask = torch.cat([mask, torch.roll(mask, -1, 0) & coin[:, None]], 1)
    return {"image": img, "gt_boxes": gt, "gt_cls": cls, "gt_mask": mask}


def step_draws_seed(seed: int, step: int) -> int:
    """The seed of train step ``step``'s draws in a run seeded ``seed``
    (the reference folds the step into ``PRNGKey(seed + 7)``)."""
    return ((seed + 7) & 0xFFFFFFFF) << 32 | (step & 0xFFFFFFFF)
