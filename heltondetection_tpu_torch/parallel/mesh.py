"""Data parallelism over processes and cards; counterpart of
heltondetection_tpu/parallel/mesh.py.

The reference gets data parallelism from GSPMD: one mesh over every
chip, the batch sharded on its ``data`` axis, the state replicated, and XLA
inserting the gradient all-reduce. The port does it with
``torch.distributed``:

* **More than one process** (``torchrun``, or :func:`init_distributed`
  with explicit arguments): each rank holds its contiguous slice of every
  global batch (``TrainLoader(shard=…)``), the train step averages the
  gradients over the ranks with one all-reduce of a flat buffer before the
  clip (DDP's arithmetic, with no buffer broadcast: BatchNorm's statistics
  are all-reduced in the forward and so agree by construction), and the
  loss normalizers that count the global batch are all-reduced too
  (``train/yolo_loss.py``). Every draw of a step (FasterRCNN's sampling,
  DropBlock, ``device_aug``) is made for the global batch on every rank
  and each rank takes its rows (:func:`rank_rows`), so N ranks compute
  what one process computes on the global batch.
* **One process over its local cards** (eval and serve): a :class:`Mesh`
  names the devices; the model is replicated on each (:func:`replicate`)
  and each batch is split by rows over them (:func:`shard_batch`).

The collectives run on gloo on the CPU and NCCL on cards, chosen and
logged by :func:`init_distributed`; gloo may be asked for on cards (two
ranks sharing one card, which NCCL refuses). gloo's all-reduce and
broadcast take CUDA tensors, and those two (and the ``*_object``
collectives) are all this package uses.
"""

from __future__ import annotations

import dataclasses
import datetime
import io
import logging
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from heltondetection_tpu_torch.device import resolve_device

_log = logging.getLogger("heltondetection_tpu_torch")

# the cluster markers: the reference's list, plus torchrun's
_SIZE_MARKERS = ("WORLD_SIZE", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE",
                 "NPROC")
_RANK_MARKERS = ("RANK", "SLURM_PROCID", "OMPI_COMM_WORLD_RANK")
_ADDR_MARKERS = ("MASTER_ADDR", "JAX_COORDINATOR_ADDRESS",
                 "COORDINATOR_ADDRESS", "MEGASCALE_COORDINATOR_ADDRESS")
_OTHER_MARKERS = ("TPU_WORKER_HOSTNAMES", "CLOUD_TPU_TASK_ID")
MARKERS = _SIZE_MARKERS + _RANK_MARKERS + _ADDR_MARKERS + _OTHER_MARKERS

DEFAULT_TIMEOUT_S = 600.0     # every collective of a group gives up after
_timeout_s = DEFAULT_TIMEOUT_S    # the process group's, for its subgroups


# -- processes --------------------------------------------------------------

def process_count() -> int:
    """The number of ranks of the initialized process group, else 1."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def process_index() -> int:
    """This process's rank in the initialized process group, else 0."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def _env_int(names: Sequence[str]) -> Optional[int]:
    for m in names:
        v = os.environ.get(m, "").strip()
        if v:
            if not v.isdigit():
                raise ValueError(f"cluster marker {m}={v!r} is not a count")
            return int(v)
    return None


def _address(coordinator_address: Optional[str]) -> Optional[str]:
    """``tcp://host:port`` from the argument or the markers, or None."""
    addr = coordinator_address
    if addr is None and os.environ.get("MASTER_ADDR"):
        port = os.environ.get("MASTER_PORT", "").strip()
        if not port:
            raise ValueError("MASTER_ADDR is set but MASTER_PORT is not")
        addr = f"{os.environ['MASTER_ADDR']}:{port}"
    if addr is None:
        for m in _ADDR_MARKERS[1:]:
            if os.environ.get(m):
                addr = os.environ[m]
                break
    if addr is None:
        return None
    if "://" not in addr:
        addr = "tcp://" + addr
    return addr


def _local_rank(rank: int) -> int:
    for m in ("LOCAL_RANK", "SLURM_LOCALID", "OMPI_COMM_WORLD_LOCAL_RANK"):
        v = os.environ.get(m, "").strip()
        if v.isdigit():
            return int(v)
    return rank


def _local_size(world: int) -> int:
    for m in ("LOCAL_WORLD_SIZE", "SLURM_NTASKS_PER_NODE",
              "OMPI_COMM_WORLD_LOCAL_SIZE"):
        v = os.environ.get(m, "").strip()
        if v.isdigit():
            return int(v)
    return world


def choose_backend(local_size: int, backend: Optional[str] = None) -> str:
    """The collective backend: ``backend`` when the caller names one; else
    NCCL where every rank of this host has a card of its own, gloo where
    there is no CUDA. Ranks that would share a card raise: NCCL refuses
    two ranks on one device, and a silent gloo would move every gradient
    through the host (pass ``backend="gloo"`` to choose that)."""
    if backend is not None:
        if backend not in ("nccl", "gloo"):
            raise ValueError(f"backend must be 'nccl' or 'gloo', got "
                             f"{backend!r}")
        return backend
    if not torch.cuda.is_available():
        return "gloo"
    n = torch.cuda.device_count()
    if local_size > n:
        raise ValueError(
            f"{local_size} ranks on this host share {n} CUDA device(s): "
            "NCCL needs a card per rank; pass backend='gloo' to run them "
            "over the host")
    return "nccl"


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     backend: Optional[str] = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the process group of a multi-process run; returns True when
    more than one process takes part.

    With no arguments it is an immediate no-op (False) unless the
    environment carries cluster markers (:data:`MARKERS`: the reference's
    SLURM, OpenMPI, coordinator and TPU-pod variables, and torchrun's
    ``WORLD_SIZE``/``RANK``/``MASTER_ADDR``). Explicit arguments
    (``coordinator_address`` ``host:port``, ``num_processes``,
    ``process_id``) start an ad-hoc cluster. A world of one is a single
    process (False).

    It raises when the markers or the arguments ask for a cluster that it
    cannot join: no rank, no address, a size-less marker, or a bootstrap
    that fails or times out. N processes that each went on alone would
    each train on the whole data set and write one ``ckpt_dir``, which is
    the failure this guards against. ``init_process_group`` always gets
    ``timeout_s``. The backend (:func:`choose_backend`) is logged; a
    failing NCCL is never replaced by gloo. On NCCL each rank takes the
    card of its local rank; on gloo with CUDA, local rank modulo the card
    count (two ranks may share a card)."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    explicit = coordinator_address is not None or num_processes is not None
    if not explicit and not any(os.environ.get(m) for m in MARKERS):
        return False
    world = num_processes
    if world is None:
        world = _env_int(_SIZE_MARKERS)
    if world is None and os.environ.get("TPU_WORKER_HOSTNAMES"):
        world = len([h for h in os.environ["TPU_WORKER_HOSTNAMES"].split(",")
                     if h.strip()])
    if world is None:
        raise ValueError(
            "cluster markers are set but none gives the number of processes "
            f"({', '.join(m for m in MARKERS if os.environ.get(m))}): pass "
            "num_processes or launch with torchrun")
    if world == 1 and coordinator_address is None:
        return False
    rank = process_id if process_id is not None else _env_int(_RANK_MARKERS)
    if rank is None:
        raise ValueError(f"a cluster of {world} processes needs this "
                         "process's rank: pass process_id or set RANK")
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    addr = _address(coordinator_address)
    if addr is None:
        raise ValueError(f"a cluster of {world} processes needs the "
                         "coordinator's address: pass coordinator_address "
                         "or set MASTER_ADDR and MASTER_PORT")
    local = _local_rank(rank)
    chosen = choose_backend(_local_size(world), backend)
    global _timeout_s
    _timeout_s = timeout_s
    if torch.cuda.is_available():
        torch.cuda.set_device(local % torch.cuda.device_count()
                              if chosen == "gloo" else local)
    _log.info("init_distributed: rank %d of %d, backend %s, %s", rank, world,
              chosen, addr, extra={"distributed": {
                  "rank": rank, "world": world, "backend": chosen}})
    try:
        dist.init_process_group(
            chosen, init_method=addr, world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s))
    except Exception as e:
        raise RuntimeError(f"could not join the {chosen} process group of "
                           f"{world} at {addr} as rank {rank}: {e}") from e
    return world > 1


def group_timeout_s() -> float:
    """The timeout the process group was joined with, in seconds (what its
    subgroups get too)."""
    return _timeout_s


def shutdown() -> None:
    """Leave the process group, if this process is in one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


# -- collectives --------------------------------------------------------------

def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``t`` over the ranks, or over ``group``'s (a new tensor;
    ``t`` itself where there is one process). No gradient flows through
    it."""
    if process_count() == 1:
        return t
    out = t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    return out


def all_reduce_sum_grad(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks, differentiable: its backward sums
    the gradient over the ranks too, which is right when the ranks'
    gradients are then averaged (each rank's loss is 1/N of the global
    one's gradient, ``train/trainer.py``)."""
    if process_count() == 1:
        return t
    return _AllReduceSum.apply(t)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g)
        return g


def average_gradients(params: Sequence[torch.nn.Parameter]) -> None:
    """Average ``.grad`` over the ranks in place, with one all-reduce of a
    flat float32 buffer over every parameter that requires a gradient
    (zeros where it has none, so the buffer is the same size on every
    rank). Which parameters get a gradient follows from the model's
    structure and frozen parameters, the same on every rank, so a
    parameter with no gradient here keeps none, as in one process; nothing
    is read back to the host."""
    n = process_count()
    if n == 1:
        return
    params = [p for p in params if p.requires_grad]
    if not params:
        return
    flat = torch.cat([(p.grad if p.grad is not None else
                       torch.zeros_like(p)).reshape(-1).float()
                      for p in params])
    dist.all_reduce(flat)
    flat.div_(n)
    off = 0
    for p in params:
        k = p.numel()
        if p.grad is not None:
            p.grad.copy_(flat[off:off + k].view_as(p))
        off += k


def average_metrics(metrics: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """Each 0-d metric averaged over the ranks (one all-reduce): the
    global batch's value where the metric is a mean over equal shards."""
    n = process_count()
    if n == 1 or not metrics:
        return metrics
    names = list(metrics)
    v = torch.stack([metrics[k].detach().float().reshape(()) for k in names])
    dist.all_reduce(v)
    v = v / n
    return {k: v[i] for i, k in enumerate(names)}


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """``obj`` of rank ``src`` on every rank (``obj`` where there is one
    process)."""
    if process_count() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def all_gather_object(obj: Any) -> List[Any]:
    """Every rank's ``obj``, in rank order (``[obj]`` in one process)."""
    n = process_count()
    if n == 1:
        return [obj]
    out: List[Any] = [None] * n
    dist.all_gather_object(out, obj)
    return out


def gather_object(obj: Any, dst: int = 0) -> Optional[List[Any]]:
    """Every rank's ``obj`` in rank order on rank ``dst``, None on the
    others (``[obj]`` in one process)."""
    n = process_count()
    if n == 1:
        return [obj]
    out: Optional[List[Any]] = [None] * n if process_index() == dst else None
    dist.gather_object(obj, out, dst=dst)
    return out


def rank_rows(t, n: Optional[int] = None, pid: Optional[int] = None):
    """This rank's contiguous rows of a global-batch tensor (or of each
    field of a tuple or a dataclass of them; None stays None): rows
    ``[pid·b, (pid+1)·b)`` with ``b = len/n``. The whole tensor where there
    is one process."""
    n = process_count() if n is None else n
    pid = process_index() if pid is None else pid
    if n == 1 or t is None:
        return t
    if dataclasses.is_dataclass(t):
        return dataclasses.replace(t, **{
            f.name: rank_rows(getattr(t, f.name), n, pid)
            for f in dataclasses.fields(t)})
    if isinstance(t, tuple):
        return type(t)(*(rank_rows(x, n, pid) for x in t)) \
            if hasattr(t, "_fields") else tuple(rank_rows(x, n, pid)
                                                for x in t)
    if t.shape[0] % n:
        raise ValueError(f"{t.shape[0]} rows do not split over {n} ranks")
    b = t.shape[0] // n
    return t[pid * b:(pid + 1) * b]


# -- one process over its local devices ---------------------------------------

@dataclass(frozen=True)
class Mesh:
    """The devices of one process that a batch is split over, by rows, in
    order (the reference's ``Mesh(devices, ('data',))``). A mesh of one
    device is the one-device case."""
    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def mesh_functions(fns, mesh: Optional[Mesh] = None, device=None
                   ) -> Tuple[Mesh, List]:
    """``(mesh, one function a device)`` of an eval or serve step: over
    ``mesh``, ``fns`` is a sequence of one function a device; with no mesh,
    a mesh of the one device ``device`` (CUDA unless ``"cpu"``). A single
    callable stands for a sequence of one."""
    if mesh is None:
        mesh = Mesh((resolve_device(device),))
    fns = [fns] if callable(fns) else list(fns)
    if len(fns) != mesh.size:
        raise ValueError(f"{len(fns)} functions for a mesh of {mesh.size} "
                         "devices")
    return mesh, fns


def create_mesh(num_devices: Optional[int] = None, device=None) -> Mesh:
    """The local CUDA cards (the first ``num_devices`` of them), or on the
    CPU (``device="cpu"``) ``num_devices`` entries of the CPU (default 1),
    which runs the same split and concatenation."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return Mesh(tuple(torch.device("cpu")
                          for _ in range(num_devices or 1)))
    n = torch.cuda.device_count()
    if num_devices is not None:
        if num_devices > n:
            raise ValueError(f"{num_devices} devices asked for, {n} present")
        n = num_devices
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)))


def batch_sharding(mesh: Mesh, batch_size: int) -> List[Tuple[int, int]]:
    """The rows ``[lo, hi)`` of a batch that each device of ``mesh`` runs;
    the batch must divide by the device count."""
    n = mesh.size
    if batch_size % n:
        raise ValueError(f"batch of {batch_size} does not divide over the "
                         f"mesh's {n} devices")
    b = batch_size // n
    return [(i * b, (i + 1) * b) for i in range(n)]


def shard_batch(batch: Any, mesh: Optional[Mesh] = None) -> Any:
    """Split a batch's leading dim: over ``mesh``, a list of one part per
    device (each moved to its device); with no mesh, in a multi-process
    run, this rank's slice of a global batch (the batch itself in one
    process). ``batch`` is a tensor or a dict of them."""
    if mesh is None:
        if isinstance(batch, dict):
            return {k: rank_rows(v) for k, v in batch.items()}
        return rank_rows(batch)
    first = next(iter(batch.values())) if isinstance(batch, dict) else batch
    parts = []
    for dev, (lo, hi) in zip(mesh.devices,
                             batch_sharding(mesh, first.shape[0])):
        if isinstance(batch, dict):
            parts.append({k: v[lo:hi].to(dev) for k, v in batch.items()})
        else:
            parts.append(batch[lo:hi].to(dev))
    return parts


def replicate(module: torch.nn.Module, mesh: Optional[Mesh] = None):
    """Put ``module`` on every device. Over ``mesh``: a list of one copy a
    device (channels-last weights; the first device's is ``module`` itself,
    moved there). With no mesh, in a multi-process run: rank 0's
    parameters and buffers broadcast to every rank in place, then a float64
    checksum of them all-gathered and checked equal; returns ``module``."""
    if mesh is not None:
        import copy
        out = []
        for dev in mesh.devices:
            m = module.to(dev) if not out else copy.deepcopy(module).to(dev)
            out.append(m.to(memory_format=torch.channels_last))
        return out
    if process_count() == 1:
        return module
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0)
    sums = all_gather_object(state_checksum(module))
    if any(s != sums[0] for s in sums):
        raise RuntimeError(f"replicated state differs over the ranks after "
                           f"the broadcast: checksums {sums}")
    return module


def state_checksum(module: torch.nn.Module) -> float:
    """The float64 sum of |x| over the parameters and floating buffers."""
    tot = 0.0
    for t in list(module.parameters()) + list(module.buffers()):
        if t.is_floating_point():
            tot += float(t.detach().double().abs().sum())
    return tot


# -- launching ranks from one process ----------------------------------------

def free_port() -> int:
    """A TCP port on localhost that was free a moment ago (bind to 0)."""
    import socket
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank: int, nprocs: int, port: int, backend, timeout_s,
               args, results) -> None:
    import traceback
    try:
        args = torch.load(io.BytesIO(args), weights_only=False)
        init_distributed(f"localhost:{port}", nprocs, rank, backend=backend,
                         timeout_s=timeout_s)
        try:
            out = fn(rank, *args)
        finally:
            shutdown()
        results.put((rank, True, _as_bytes(out)))
    except Exception:                           # handed to the launcher
        results.put((rank, False, traceback.format_exc()))


def _as_bytes(obj) -> bytes:
    """``obj`` serialized by ``torch.save``: a tensor handed to another
    process as it is would travel as a shared-memory handle, one file
    descriptor each (which a fork server cannot pass in their hundreds),
    and the handle dies with the process that made it."""
    buf = io.BytesIO()
    torch.save(obj, buf)
    return buf.getvalue()


def run_ranks(fn, nprocs: int, args: tuple = (), *,
              backend: Optional[str] = None, timeout_s: float = 600.0,
              group_timeout_s: Optional[float] = None,
              start_method: str = "spawn") -> List[Any]:
    """Run ``fn(rank, *args)`` in ``nprocs`` new processes that form a
    process group on localhost (a free port; ``backend`` as
    :func:`init_distributed` chooses it) and return their results in rank
    order. ``fn`` must be importable by name and its result picklable.
    ``start_method`` is multiprocessing's: "spawn" (each rank imports
    afresh; what CUDA needs) or "forkserver" (CPU only: a server process,
    started once, imports this module and ``fn``'s, and each rank forks
    from it with those imports done; unlike "fork", no rank is a copy of a
    process whose other threads, a JAX or OpenMP pool, may hold a lock).

    Raises RuntimeError, with the rank's traceback, when a rank raises or
    dies, and TimeoutError when the ranks have not all returned within
    ``timeout_s``; either way every rank still running is killed first.
    The process group's own timeout is ``group_timeout_s`` (default
    ``timeout_s``)."""
    import queue as _queue
    import time as _time

    import torch.multiprocessing as mp
    ctx = mp.get_context(start_method)
    if start_method == "forkserver":      # (once the server runs, a no-op)
        ctx.set_forkserver_preload([__name__, fn.__module__])
    results = ctx.Queue()
    port = free_port()
    blob = _as_bytes(args)
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, nprocs, port, backend,
                               group_timeout_s or timeout_s, blob, results),
                         daemon=True)
             for r in range(nprocs)]
    for p in procs:
        p.start()
    out: Dict[int, Any] = {}
    deadline = _time.monotonic() + timeout_s
    try:
        while len(out) < nprocs:
            left = deadline - _time.monotonic()
            if left <= 0:
                late = sorted(set(range(nprocs)) - set(out))
                raise TimeoutError(f"ranks {late} did not finish within "
                                   f"{timeout_s} s")
            try:
                rank, ok, res = results.get(timeout=min(left, 1.0))
            except _queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and not p.is_alive()
                        and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} died (exit code "
                                       f"{procs[dead[0]].exitcode})")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{res}")
            out[rank] = torch.load(io.BytesIO(res), weights_only=False)
        for p in procs:
            p.join(timeout=max(deadline - _time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10.0)
        results.close()
    return [out[r] for r in range(nprocs)]
