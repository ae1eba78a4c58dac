"""DropBlock2D: drop contiguous block_size² regions of a feature map and
rescale by the kept fraction (Ghiasi et al. 2018); counterpart of
heltondetection_tpu/models/dropblock.py.

:func:`drop_block` is a pure function of its uniform draws: the reference's
``jax.random.bernoulli(rng, gamma, shape)`` is ``uniform(rng, shape) <
gamma``, so the same draws give the same mask here. The :class:`DropBlock`
module makes the draws from its own ``torch.Generator`` on the input's
device, which the train step seeds from the run's seed and the step
(:func:`reseed_dropblock`), so a run is repeatable and every call takes a
fresh draw. Over N data-parallel ranks (``shard``, set by the train step)
each rank draws for the global batch and takes its rows, so N ranks drop
the blocks one process drops. Under spatial sharding (``spatial``, set on
the trunk by the train step) the input is a band of H rows: the mask is
made at the full H, each (image, channel)'s kept fraction over the whole
image, and the rank takes its band, so the draws and the blocks do not
depend on the number of spatial ranks.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from heltondetection_tpu_torch.parallel.mesh import rank_rows


def draw_shape(x, block_size: int = 7):
    """The shape of the uniform draws of :func:`drop_block` for ``x`` (B, C,
    H, W), a tensor or its shape, in the reference's NHWC order: (B,
    H - bs + 1, W - bs + 1, C)."""
    b, c, h, w = x.shape if isinstance(x, torch.Tensor) else x
    bs = min(block_size, h, w)
    return b, h - bs + 1, w - bs + 1, c


def drop_block(x: torch.Tensor, u: torch.Tensor, drop_prob: float,
               block_size: int = 7) -> torch.Tensor:
    """``x`` (B, C, H, W) with blocks zeroed and the rest rescaled by the
    kept fraction of each (image, channel). ``u`` (B, C, H - bs + 1,
    W - bs + 1) holds uniform [0, 1) draws, one per valid block centre (a
    permuted view of an NHWC draw is fine); a centre seeds a block where
    ``u < gamma``. The output has ``x``'s dtype; the rescale runs in
    float32."""
    if drop_prob <= 0.0:
        return x
    keep, keep_frac = _keep_mask(u, x.shape, drop_prob, block_size)
    return (x.float() * keep / keep_frac).to(x.dtype)


def _keep_mask(u: torch.Tensor, shape, drop_prob: float, block_size: int):
    """:func:`drop_block`'s mask of an input of ``shape`` (B, C, H, W) from
    its draws ``u``: (keep (B, C, H, W) of 0s and 1s, the kept fraction
    (B, C, 1, 1))."""
    b, c, h, w = shape
    bs = min(block_size, h, w)
    valid_h, valid_w = h - bs + 1, w - bs + 1
    if tuple(u.shape) != (b, c, valid_h, valid_w):
        raise ValueError(f"drop_block draws {tuple(u.shape)} for x "
                         f"{tuple(shape)}: want {(b, c, valid_h, valid_w)}")
    # seed rate so that the expected dropped fraction is about drop_prob
    gamma = (drop_prob / (bs ** 2)) * (h * w) / max(valid_h * valid_w, 1)
    seeds = (u < gamma).float()
    # centres → blocks: the reference pads the seeds to (H, W), then max-
    # pools with padding (bs // 2, (bs - 1) // 2); both pads in one, zeros
    # standing for its -inf (every window holds a real seed)
    lo = 2 * (bs // 2)
    hi = (bs - 1 - bs // 2) + (bs - 1) // 2
    seeds = F.pad(seeds, (lo, hi, lo, hi))
    keep = 1.0 - F.max_pool2d(seeds, bs, stride=1)
    keep_frac = keep.mean(dim=(2, 3), keepdim=True).clamp(1e-6, 1.0)
    return keep, keep_frac


class DropBlock(nn.Module):
    """Active in training mode only. Each call draws fresh uniforms from the
    module's generator, made on the input's device at ``seed`` (set by
    :meth:`reseed`). It has no parameters or buffers, so a state dict is the
    same with it or without it. ``shard`` (rank, world): the train step's
    rows of the global batch, whose draws every rank makes alike;
    ``spatial``: the spatial shard whose band of rows the input is."""

    shard = (0, 1)
    spatial = None

    def __init__(self, drop_prob: float = 0.1, block_size: int = 7):
        super().__init__()
        self.drop_prob = drop_prob
        self.block_size = block_size
        self.seed = 0
        self.generator = None

    def reseed(self, seed: int) -> None:
        self.seed = seed
        if self.generator is not None:
            self.generator.manual_seed(seed)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.drop_prob <= 0.0:
            return x
        if self.generator is None or self.generator.device != x.device:
            self.generator = torch.Generator(x.device).manual_seed(self.seed)
        # data parallel: the global batch's draws, this rank's rows; under
        # spatial sharding the mask of the whole image, this rank's band
        rank, world = self.shard
        mesh = self.spatial
        sp = 1 if mesh is None else mesh.n_spatial
        b, c, h, w = x.shape
        shape = draw_shape((b, c, h * sp, w), self.block_size)
        u = rank_rows(torch.rand((shape[0] * world, *shape[1:]),
                                 device=x.device, generator=self.generator),
                      world, rank)
        keep, keep_frac = _keep_mask(u.permute(0, 3, 1, 2), (b, c, h * sp, w),
                                     self.drop_prob, self.block_size)
        if sp > 1:
            lo = mesh.spatial_rank * h
            keep = keep[:, :, lo:lo + h]
        return (x.float() * keep / keep_frac).to(x.dtype)


def reseed_dropblock(model: nn.Module, seed: int, step: int) -> None:
    """Seed every DropBlock of ``model`` for train step ``step`` of a run
    seeded ``seed``: the same (seed, step) gives the same draws."""
    for m in model.modules():
        if isinstance(m, DropBlock):
            m.reseed((seed & 0xFFFFFFFF) << 32 | (step & 0xFFFFFFFF))
