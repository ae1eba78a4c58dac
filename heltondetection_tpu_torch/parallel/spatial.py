"""Spatial sharding: the image's H axis split over ranks; counterpart of
heltondetection_tpu/parallel/spatial.py.

The reference puts its devices on a (data × spatial) mesh, shards NHWC
activations ``P('data', 'spatial', None, None)`` and lets GSPMD insert the
halo exchanges of every windowed operation and the collectives of
whatever reads rows anywhere in the image. The port does the same by hand
over ``torch.distributed``, one rank standing for one device:

* **The layout** (:func:`create_spatial_mesh`): rank ``r`` is data rank
  ``r // sp`` and spatial rank ``r % sp``. The ranks of one data rank form
  its spatial group (they hold one set of images, each its band of H rows);
  the ranks of one spatial rank form a data group.
* **The trunk** (``model.backbone`` and ``model.neck``) runs on this rank's
  rows. Each operation whose window reaches across rows (a convolution
  with k > 1, a max-pool) first takes its halo (:func:`halo_exchange`)
  through :func:`windowed`; 1x1 convolutions, nearest upsampling and
  concatenation need none. DropBlock draws its mask at the global shape
  and takes this rank's rows (``models/dropblock.py``).
* **After the trunk** the model gathers the rows over the spatial group
  (:func:`gather_rows`): YOLOv5 its detect outputs, FasterRCNN its
  pyramid (the RPN's proposals, RoIAlign and the assigners read rows
  anywhere), and every rank of a spatial group then computes the same
  loss of its data group's rows.

Both collectives are built from ``all_reduce`` over the spatial group: a
rank writes its rows into its slot of a zeroed buffer and the sum is every
rank's rows. So one code path serves gloo on the CPU, gloo on a card
(whose CUDA tensors it takes for all-reduce and broadcast only) and NCCL.
Each operation's exchange is one all-reduce forward and one backward.

The gradients: the gather's backward sums the gradient over the spatial
group and keeps this rank's rows (the transpose of an all-gather is a
reduce-scatter), so a trunk parameter's gradient on a rank is ``sp`` times
its partial sum and a parameter after the gather gets the same gradient
on each spatial rank. The train step's average over the world (dp · sp
ranks, ``parallel/mesh.py:average_gradients``) is then the data mean, as
in data parallelism over dp ranks. BatchNorm's statistics are summed over
the world, whose ranks hold disjoint (image, row) pieces: the global
batch's statistics, with no change. The loss normalizers count the data
group only (``train/yolo_loss.py``'s ``group``).
"""

from __future__ import annotations

import contextlib
import datetime
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from heltondetection_tpu_torch.parallel import mesh as M


@dataclass(frozen=True, eq=False)
class SpatialMesh:
    """This rank's place on the (data × spatial) layout and its two groups
    (None where a group would hold one rank: it needs no collective)."""
    n_data: int
    n_spatial: int
    data_rank: int
    spatial_rank: int
    data_group: Any = None
    spatial_group: Any = None

    @property
    def data_shard(self) -> Tuple[int, int]:
        """(data rank, n_data): this rank's share of the global batch."""
        return self.data_rank, self.n_data


_LAYOUTS: dict = {}


def create_spatial_mesh(n_data: int, n_spatial: int) -> SpatialMesh:
    """The (n_data × n_spatial) layout of the process group's ranks. Every
    rank must call it, alike: the groups are made with ``dist.new_group``
    in the same order on every rank (made once per process group and
    layout, then reused)."""
    world, rank = M.process_count(), M.process_index()
    if n_data < 1 or n_spatial < 1 or n_data * n_spatial != world:
        raise ValueError(f"a {n_data} x {n_spatial} (data x spatial) layout "
                         f"needs {n_data * n_spatial} ranks; the process "
                         f"group has {world}")
    key = (n_data, n_spatial)
    pg = dist.group.WORLD if world > 1 else None
    hit = _LAYOUTS.get(key)
    if hit is not None and hit[0] is pg:
        return hit[1]
    timeout = datetime.timedelta(seconds=M.group_timeout_s())
    data_group = spatial_group = None
    if n_spatial > 1:
        for d in range(n_data):
            g = dist.new_group(list(range(d * n_spatial, (d + 1) * n_spatial)),
                               timeout=timeout)
            if d == rank // n_spatial:
                spatial_group = g
    if n_data > 1:
        for s in range(n_spatial):
            g = dist.new_group(list(range(s, world, n_spatial)),
                               timeout=timeout)
            if s == rank % n_spatial:
                data_group = g
    out = SpatialMesh(n_data, n_spatial, rank // n_spatial, rank % n_spatial,
                      data_group, spatial_group)
    _LAYOUTS[key] = (pg, out)
    return out


def image_sharding(mesh: SpatialMesh, batch: int, height: int, *,
                   data_axis: bool = True) -> Tuple[slice, slice]:
    """This rank's (rows of a ``batch``, H rows of a ``height``): its data
    rank's rows (all of them with ``data_axis=False``) and its band
    ``[s·H/sp, (s+1)·H/sp)``."""
    if height % mesh.n_spatial:
        raise ValueError(f"{height} rows do not split over "
                         f"{mesh.n_spatial} spatial ranks")
    h = height // mesh.n_spatial
    rows = slice(0, batch)
    if data_axis:
        if batch % mesh.n_data:
            raise ValueError(f"a batch of {batch} does not split over "
                             f"{mesh.n_data} data ranks")
        b = batch // mesh.n_data
        rows = slice(mesh.data_rank * b, (mesh.data_rank + 1) * b)
    return rows, slice(mesh.spatial_rank * h, (mesh.spatial_rank + 1) * h)


def shard_images_spatial(images: torch.Tensor, mesh: SpatialMesh, *,
                         data_axis: bool = True) -> torch.Tensor:
    """This rank's piece of NHWC ``images`` (:func:`image_sharding`)."""
    rows, band = image_sharding(mesh, images.shape[0], images.shape[1],
                                data_axis=data_axis)
    return images[rows, band]


def replicate_vars(model: nn.Module) -> nn.Module:
    """Rank 0's parameters and buffers on every rank
    (``parallel/mesh.py:replicate``)."""
    return M.replicate(model)


# -- the collectives ---------------------------------------------------------

def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    dist.all_reduce(t, group=group)
    return t


def _segments(h: int, rows: range, n_ranks: int, first_published: int
              ) -> List[Tuple[int, int, int, int]]:
    """Where the halo rows ``rows`` (global row numbers) come from: runs
    ``(out_row, source rank, buffer row, n)`` of rows inside the image,
    ``buffer row`` counted from the first of the rows each rank publishes,
    ``first_published`` rows into its band."""
    out: List[Tuple[int, int, int, int]] = []
    for j, g in enumerate(rows):
        if not 0 <= g < n_ranks * h:
            continue
        r, o = divmod(g, h)
        k = o - first_published
        if out and out[-1][1] == r and out[-1][0] + out[-1][3] == j:
            out[-1] = out[-1][:3] + (out[-1][3] + 1,)
        else:
            out.append((j, r, k, 1))
    return out


class _Halo(torch.autograd.Function):
    """``x`` (N, C, h, W) with ``top`` rows above and ``bottom`` below: the
    neighbours' rows where the image goes on, ``value`` beyond its edges.
    Each rank publishes its last min(top, h) rows and its first
    min(bottom, h) in its slot of a zeroed buffer, one all-reduce over the
    spatial group; a halo wider than a rank's band takes rows from ranks
    further off. The backward sends each halo row's gradient back to the
    rank that owns it (the same buffer, summed in float32) and adds it
    there."""

    @staticmethod
    def forward(ctx, x, top, bottom, value, mesh):
        n, c, h, w = x.shape
        sp, s = mesh.n_spatial, mesh.spatial_rank
        tt, bb = min(top, h), min(bottom, h)
        tops = _segments(h, range(s * h - top, s * h), sp, h - tt)
        bots = _segments(h, range((s + 1) * h, (s + 1) * h + bottom), sp,
                         -tt)
        ctx.geom = (top, bottom, h, tt, bb, tops, bots, mesh)
        buf = x.new_zeros((sp, n, c, tt + bb, w))
        buf[s, :, :, :tt] = x[:, :, h - tt:]
        buf[s, :, :, tt:] = x[:, :, :bb]
        _all_reduce(buf, mesh.spatial_group)
        out = x.new_full((n, c, top + h + bottom, w), value)
        out[:, :, top:top + h] = x
        for off, segs in ((0, tops), (top + h, bots)):
            for j, r, k, m in segs:
                out[:, :, off + j:off + j + m] = buf[r, :, :, k:k + m]
        return out

    @staticmethod
    def backward(ctx, g):
        top, bottom, h, tt, bb, tops, bots, mesh = ctx.geom
        n, c, _, w = g.shape
        s = mesh.spatial_rank
        acc = torch.promote_types(g.dtype, torch.float32)
        buf = g.new_zeros((mesh.n_spatial, n, c, tt + bb, w), dtype=acc)
        for off, segs in ((0, tops), (top + h, bots)):
            for j, r, k, m in segs:
                buf[r, :, :, k:k + m] += g[:, :, off + j:off + j + m]
        _all_reduce(buf, mesh.spatial_group)
        dx = g[:, :, top:top + h].to(acc)
        dx[:, :, h - tt:] += buf[s, :, :, :tt]
        dx[:, :, :bb] += buf[s, :, :, tt:]
        return dx.to(g.dtype), None, None, None, None


def halo_exchange(x: torch.Tensor, mesh: SpatialMesh, top: int, bottom: int,
                  value: float = 0.0) -> torch.Tensor:
    """``x`` (N, C, h, W), this rank's band, with ``top`` rows of the
    ranks above and ``bottom`` of the ranks below added, ``value`` beyond
    the image's edges (0 for a convolution, −inf for a max-pool);
    differentiable. The result is contiguous NCHW whatever ``x``'s memory
    format (a channels_last input pays a layout change, not an error)."""
    if mesh.n_spatial == 1 or top == bottom == 0:
        return x
    return _Halo.apply(x, top, bottom, value, mesh)


def halo_rows(k: int, s: int, p: int) -> Tuple[int, int]:
    """(top, bottom) halo rows of a (kernel k, stride s, padding p) window
    over H, for a band whose rows divide by s: p above, and k − 1 − p −
    (s − 1) below (none where that is negative: the band's last rows are
    then read by no output row)."""
    return p, max(k - 1 - p - (s - 1), 0)


def windowed(module: nn.Module, x: torch.Tensor, k: int, s: int, p: int,
             value: float = 0.0) -> Tuple[torch.Tensor, int]:
    """``(x, H padding)`` for a (k, s, p) window op of ``module``: where a
    spatial shard is active on the module (``module.spatial``), ``x`` with
    its halo rows and 0 (the halo is the padding); else ``x`` and ``p``."""
    mesh = getattr(module, "spatial", None)
    if mesh is None or mesh.n_spatial == 1:
        return x, p
    if x.shape[2] % s:
        raise ValueError(f"a band of {x.shape[2]} rows does not divide by "
                         f"the stride {s}")
    top, bottom = halo_rows(k, s, p)
    return halo_exchange(x, mesh, top, bottom, value), 0


class _GatherRows(torch.autograd.Function):
    """Every rank's band along ``dim``, in spatial-rank order; the backward
    sums the gradient over the spatial group and keeps this rank's rows."""

    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.mesh, ctx.h = dim, mesh, x.shape[dim]
        shape = list(x.shape)
        shape[dim] *= mesh.n_spatial
        out = x.new_zeros(shape)
        out.narrow(dim, mesh.spatial_rank * ctx.h, ctx.h).copy_(x)
        return _all_reduce(out, mesh.spatial_group)

    @staticmethod
    def backward(ctx, g):
        g = _all_reduce(g.contiguous().clone(), ctx.mesh.spatial_group)
        return (g.narrow(ctx.dim, ctx.mesh.spatial_rank * ctx.h, ctx.h),
                None, None)


def gather_rows(x: torch.Tensor, mesh: Optional[SpatialMesh],
                dim: int = 2) -> torch.Tensor:
    """The spatial group's bands of ``x`` concatenated along ``dim`` (H of
    NCHW by default; 1 for (B, H·W, C) rows, which are H-major);
    differentiable. ``x`` itself without a spatial shard."""
    if mesh is None or mesh.n_spatial == 1:
        return x
    return _GatherRows.apply(x, dim, mesh)


# -- setting a shard on a model ---------------------------------------------

def trunk_modules(model: nn.Module) -> List[nn.Module]:
    """The modules that run on a rank's band: the model itself (which
    gathers after the trunk) and every module of its backbone and neck."""
    out = [model]
    for part in ("backbone", "neck"):
        sub = getattr(model, part, None)
        if sub is not None:
            out.extend(sub.modules())
    return out


@contextlib.contextmanager
def spatially_sharded(model: nn.Module, mesh: Optional[SpatialMesh]):
    """``mesh`` on the model's trunk (:func:`trunk_modules`) while active,
    and none after it, so a forward outside (the in-loop eval, the EMA's)
    runs on whole images. A no-op without a mesh."""
    mods = trunk_modules(model) if mesh is not None else []
    for m in mods:
        m.spatial = mesh
    try:
        yield
    finally:
        for m in mods:
            m.spatial = None


def _has_quant(model: nn.Module) -> bool:
    return any("quant" in m._modules for m in model.modules())


def spatial_forward(model: nn.Module, mesh: SpatialMesh
                    ) -> Callable[[torch.Tensor], Any]:
    """The eval-mode forward with H-sharded activations:
    ``fwd(images)`` takes the global batch's NHWC images (every rank
    alike), runs this rank's piece (:func:`shard_images_spatial`) and
    returns the model's output for its data rank's rows, gathered over the
    spatial group: the unsharded forward's. The float model only (an int8
    copy raises)."""
    if _has_quant(model):
        raise ValueError("spatial_forward runs the float model; this one "
                         "carries int8 quant submodules")

    @torch.no_grad()
    def fwd(images: torch.Tensor):
        model.eval()
        with spatially_sharded(model, mesh):
            return model(shard_images_spatial(images, mesh))

    return fwd
