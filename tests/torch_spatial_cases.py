"""The work of each rank in the port's spatial-sharding tests
(``tests/test_torch_port_spatial.py``), and of the one process they are
held to. Imports torch and the port only, as ``torch_parallel_cases`` does
(whose runner, inputs and results travel the same way).

The cluster has four ranks; a case names its (data × spatial) layouts,
each over all four (1 × 4, 2 × 2). Rank ``r`` is data rank ``r // sp`` and
spatial rank ``r % sp``. Every case is a function ``case(inp) → result`` of
picklable inputs and results; the functions that the tests also call in
their own process (no group) give the one-process answer there.
"""

import numpy as np
import torch
import torch.nn as tnn
import torch.nn.functional as F

from heltondetection_tpu_torch.parallel import mesh as M
from heltondetection_tpu_torch.parallel import spatial as S


def _piece(a, mesh, dim: int = 2, data: bool = True):
    """This rank's data rows (``data``) and its band along ``dim`` of a
    global array."""
    t = torch.as_tensor(np.asarray(a))
    if data:
        t = M.rank_rows(t, mesh.n_data, mesh.data_rank)
    h = t.shape[dim] // mesh.n_spatial
    return t.narrow(dim, mesh.spatial_rank * h, h)


class _Owner(tnn.Module):
    """A module to carry a spatial shard for :func:`S.windowed`."""


def halo(inp):
    """Every op of ``inp["ops"]`` {name: (k, s, p, kind, x, w, gy)} (kind
    "conv" or "pool"; x (B, C, H, W) float64, w the conv's weight, gy the
    output's gradient) on this rank's piece under each layout: the output
    band, the input's gradient band and the weight's partial gradient
    under the loss Σ y·gy."""
    out = {}
    for nd, sp in inp["layouts"]:
        mesh = S.create_spatial_mesh(nd, sp)
        owner = _Owner()
        owner.spatial = mesh
        for name, (k, s, p, kind, x, w, gy) in inp["ops"].items():
            xl = _piece(x, mesh).clone().requires_grad_(True)
            value = 0.0 if kind == "conv" else float("-inf")
            xh, pad_h = S.windowed(owner, xl, k, s, p, value)
            if kind == "conv":
                wt = torch.from_numpy(w).requires_grad_(True)
                y = F.conv2d(xh, wt, None, s, (pad_h, p))
            else:
                wt = None
                y = F.max_pool2d(xh, k, s, (pad_h, p))
            (y * _piece(gy, mesh)).sum().backward()
            out[(nd, sp, name)] = {
                "y": y.detach(), "dx": xl.grad,
                "dw": None if wt is None else wt.grad}
    return out


def _yolo(sd, width: float, packed_train: bool = False):
    from heltondetection_tpu_torch.models.yolov5 import YOLOv5
    with torch.device("meta"):
        m = YOLOv5(4, 0.33, width)
    m = m.to_empty(device="cpu")
    m.load_state_dict(sd)
    m.packed_train = packed_train
    return m


def forward(inp):
    """``spatial_forward`` of a YOLOv5 (4 classes, depth 0.33, width
    ``inp["width"]``) holding ``inp["sd"]`` on the global images
    ``inp["x"]`` under each layout: this rank's data rows of the
    outputs."""
    model = _yolo(inp["sd"], inp["width"])
    x = torch.from_numpy(inp["x"])
    out = {}
    for nd, sp in inp["layouts"]:
        mesh = S.create_spatial_mesh(nd, sp)
        out[(nd, sp)] = [o.clone() for o in S.spatial_forward(model, mesh)(x)]
    return out


def dropblock(inp):
    """A DropBlock (``inp["p"]``, block ``inp["block"]``, seed 11) in
    training mode on this rank's piece of ``inp["x"]`` (B, C, H, W) under
    each layout, as the train step sets it (the data shard and the spatial
    mesh); in one process, on the whole batch."""
    from heltondetection_tpu_torch.models.dropblock import DropBlock
    out = {}
    layouts = inp["layouts"] if M.process_count() > 1 else [(1, 1)]
    for nd, sp in layouts:
        db = DropBlock(inp["p"], inp["block"]).train()
        db.reseed(11)
        x = torch.from_numpy(inp["x"])
        if sp > 1 or nd > 1:
            mesh = S.create_spatial_mesh(nd, sp)
            db.shard = mesh.data_shard
            db.spatial = mesh if sp > 1 else None
            x = _piece(x, mesh)
        out[(nd, sp)] = db(x)
    return out


def batchnorm(inp):
    """A train-mode ``BatchNorm2d`` on this rank's piece of ``inp["x"]``
    (N, C, H, W) under the 2 × 2 layout, its shard the world's as the
    train step sets it: the output band, the running statistics and the
    input's gradient band under the loss Σ y·w."""
    from heltondetection_tpu_torch.models.common import BatchNorm2d
    mesh = S.create_spatial_mesh(2, 2)
    x = _piece(inp["x"], mesh).clone().requires_grad_(True)
    bn = BatchNorm2d(x.shape[1], eps=1e-3, momentum=0.03).train()
    bn.shard = (M.process_index(), M.process_count())
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, x.shape[1]))
        bn.bias.copy_(torch.linspace(-0.2, 0.2, x.shape[1]))
    y = bn(x)
    (y * _piece(inp["w"], mesh)).sum().backward()
    return {"y": y.detach(), "dx": x.grad, "mean": bn.running_mean.clone(),
            "var": bn.running_var.clone()}


def _model(inp):
    if inp["kind"] == "yolo":
        return _yolo(inp["sd"], inp["width"], packed_train=True)
    from heltondetection_tpu_torch.models import faster_rcnn as PR
    with torch.device("meta"):
        m = PR.FasterRCNN(PR.RCNNConfig(**inp["cfg"]))
    m = m.to_empty(device="cpu")
    m.load_state_dict(inp["sd"])
    return m


def train_steps(inp):
    """``inp``: kind ("yolo" or "rcnn"), sd, width or cfg, opt
    (make_optimizer's keywords), batches (global numpy batches), draws
    (FasterRCNN: the global batch's RCNNDraws per step), spatial (sp).
    Each rank steps on its data rank's rows of every batch (the step keeps
    its band) with ``spatial_shards=sp``; one process on the whole batches.
    Returns the metrics and (averaged) gradients of each step, the
    checksum, and the parameters, EMA and BatchNorm statistics."""
    from heltondetection_tpu_torch.train import schedule as PS
    from heltondetection_tpu_torch.train import trainer as PT
    from heltondetection_tpu_torch.train.yolo_loss import YoloLossConfig
    torch.manual_seed(0)
    model = _model(inp)
    state = PT.create_train_state(model, PS.make_optimizer(
        model, 1e-3, **inp["opt"]))
    sp = inp["spatial"] if M.process_count() > 1 else 1
    n_data = M.process_count() // sp
    data_rank = M.process_index() // sp
    if inp["kind"] == "yolo":
        step = PT.make_train_step(YoloLossConfig(
            num_classes=4, img_size=inp["batches"][0]["image"].shape[1]),
            spatial_shards=sp)
    else:
        step = PT.make_rcnn_train_step(spatial_shards=sp)
    out, grads = [], []
    for i, batch in enumerate(inp["batches"]):
        rows = {k: M.rank_rows(torch.from_numpy(np.asarray(v)), n_data,
                               data_rank) for k, v in batch.items()}
        if inp["kind"] == "yolo":
            state, m = step(state, rows)
        else:
            state, m = step(state, rows, [inp["draws"][i]])
        out.append({k: float(v) for k, v in m.items()})
        grads.append({k: p.grad.clone() for k, p in model.named_parameters()
                      if p.grad is not None})
    return {"metrics": out, "grads": grads,
            "checksum": M.state_checksum(model),
            "state": {k: v.detach().clone()
                      for k, v in model.state_dict().items()},
            "ema": {k: v.clone() for k, v in state.ema.items()}}


def run_train(inp):
    """``run_train`` of a YOLOv5n at 64² with ``spatial_shards=2`` (global
    batch 8, two epochs of one step, a checkpoint at the second, the eval
    at the end): the best stats, the checkpoint steps on this rank's
    disk, and the checksum of the trained weights."""
    import os

    from torch_parallel_cases import _NullTB, _cfg

    from heltondetection_tpu_torch.engine import runner
    runner.TBWriter = _NullTB
    cfg = _cfg(inp, inp["work"], epochs=2, batch_size=8, eval_interval=1000,
               ckpt_interval=2, spatial_shards=2)
    best = runner.run_train(cfg, device="cpu")
    ckpt = sorted(os.listdir(cfg.ckpt_dir)) if os.path.isdir(cfg.ckpt_dir) \
        else []
    return {"best": best, "ckpt": ckpt}


def dryrun(inp):
    """The dry run's (5) and (6), as each of its ranks runs them."""
    from heltondetection_tpu_torch.parallel import dryrun as D
    return D.spatial_rank_steps(M.process_index(), M.process_count(), "cpu")


def warm_fork_server():
    """Start multiprocessing's fork server now, with this module and the
    port's trainer and runner imported in it (``torch_parallel_cases``'
    counterpart)."""
    import multiprocessing.forkserver

    import torch.multiprocessing as mp
    mp.get_context("forkserver").set_forkserver_preload([
        M.__name__, S.__name__, __name__,
        "heltondetection_tpu_torch.engine.runner",
        "heltondetection_tpu_torch.train.trainer"])
    multiprocessing.forkserver.ensure_running()


CASES = {"halo": halo, "forward": forward, "dropblock": dropblock,
         "batchnorm": batchnorm, "train_steps": train_steps,
         "run_train": run_train, "dryrun": dryrun}


def rank_main(rank, jobs):
    """``jobs``: [(name, case name, input)], run in order; {name: result}.
    One CPU thread a rank."""
    torch.set_num_threads(1)
    return {name: CASES[case](inp) for name, case, inp in jobs}
