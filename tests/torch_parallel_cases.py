"""The work of each rank in the port's two-process tests
(``tests/test_torch_port_parallel.py``,
``tests/test_torch_port_rcnn_train_step.py``), and of the one process they
are held to. Imports torch and the port only: the ranks are spawned
processes, and importing JAX there would cost seconds for nothing.

Every case is a function ``case(inp) → result`` of picklable inputs and
results; :func:`rank_main` runs the named cases in one rank of a process
group (``parallel.mesh.run_ranks``), and the tests call the same functions
in their own process, without a group, for the one-process answer.
"""

import os

import numpy as np
import torch
import torch.nn as tnn

from heltondetection_tpu_torch.parallel import mesh as M

NC, S = 3, 64


class PTiny(tnn.Module):
    """The port's side of test_torch_port_train_step's tiny detector: two
    ConvBnAct stages to stride 8 and the packed train head on that level
    (the reference's side is its ``JTiny``)."""

    def __init__(self, nc=NC):
        super().__init__()
        from heltondetection_tpu_torch.models.common import ConvBnAct
        self.nc = nc
        self.stem = ConvBnAct(3, 8, 3, 4)
        self.stage = ConvBnAct(8, 12, 3, 2)
        self.detect0 = tnn.Conv2d(12, 3 * (5 + nc), 1)

    def forward(self, x):
        from heltondetection_tpu_torch.models.yolov5 import packed_train_head
        x = self.stage(self.stem(x.permute(0, 3, 1, 2)))
        d = self.detect0
        return [packed_train_head(x, d.weight, d.bias, self.nc)]


def _model(kind: str, sd):
    from heltondetection_tpu_torch.models.yolov5 import YOLOv5
    if kind == "tiny":
        m = PTiny(NC)
    elif kind == "yolov5":            # width 0.125, DropBlock on
        m = YOLOv5(NC, 0.33, 0.125, dropblock_p=0.1)
        m.packed_train = True
    else:                             # the tiny FasterRCNN of TRAIN_CFG
        from heltondetection_tpu_torch.models import faster_rcnn as PR
        from torch_rcnn_refs import TRAIN_CFG
        with torch.device("meta"):
            m = PR.FasterRCNN(PR.RCNNConfig(**TRAIN_CFG))
        m = m.to_empty(device="cpu")
    m.load_state_dict(sd)
    return m


def _rows(batch):
    """This rank's rows of a global batch of numpy arrays, as tensors."""
    return {k: M.rank_rows(torch.from_numpy(np.asarray(v)))
            for k, v in batch.items()}


def checksum(model) -> float:
    """Σ|p| over the parameters, in float64 (the reference test's)."""
    return float(sum(p.detach().double().abs().sum()
                     for p in model.parameters()))


def train_steps(inp):
    """``inp``: kind, sd, opt (make_optimizer's keywords), batches (global
    numpy batches), accum (one per batch), draws (FasterRCNN: the global
    batch's RCNNDraws per batch, or None). Each rank steps on its rows.
    Returns the metrics and the (averaged) gradients of each step, the
    checksum, and the parameters, EMA and BatchNorm statistics."""
    from heltondetection_tpu_torch.train import schedule as PS
    from heltondetection_tpu_torch.train import trainer as PT
    from heltondetection_tpu_torch.train.yolo_loss import YoloLossConfig
    torch.manual_seed(0)
    model = _model(inp["kind"], inp["sd"])
    state = PT.create_train_state(model, PS.make_optimizer(
        model, 1e-3, **inp["opt"]))
    rcnn = inp["kind"] == "rcnn"
    out, grads = [], []
    for i, batch in enumerate(inp["batches"]):
        accum = inp["accum"][i]
        if rcnn:
            step = PT.make_rcnn_train_step(accum_steps=accum)
            state, m = step(state, _rows(batch), [inp["draws"][i]])
        else:
            step = PT.make_train_step(
                YoloLossConfig(num_classes=NC, img_size=S), accum_steps=accum,
                seed=5)
            state, m = step(state, _rows(batch))
        out.append({k: float(v) for k, v in m.items()})
        grads.append({k: p.grad.clone() for k, p in model.named_parameters()
                      if p.grad is not None})
    return {"metrics": out, "checksum": checksum(model), "grads": grads,
            "step": state.step,
            "state": {k: v.detach().clone()
                      for k, v in model.state_dict().items()},
            "ema": {k: v.clone() for k, v in state.ema.items()}}


def batchnorm(inp):
    """A train-mode ``BatchNorm2d`` on this rank's rows of ``inp["x"]``
    (N, C, H, W) float32, given this rank's shard as the train step gives
    it: its output rows, running statistics and the input's gradient under
    the loss Σ y·w."""
    from heltondetection_tpu_torch.models.common import BatchNorm2d
    x = torch.from_numpy(inp["x"])
    bn = BatchNorm2d(x.shape[1], eps=1e-3, momentum=0.03).train()
    bn.shard = (M.process_index(), M.process_count())
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, x.shape[1]))
        bn.bias.copy_(torch.linspace(-0.2, 0.2, x.shape[1]))
    xr = M.rank_rows(x).clone().requires_grad_(True)
    y = bn(xr)
    (y * M.rank_rows(torch.from_numpy(inp["w"]))).sum().backward()
    M.average_gradients(list(bn.parameters()))
    return {"y": y.detach().numpy(), "mean": bn.running_mean.numpy(),
            "var": bn.running_var.numpy(), "dx": xr.grad.numpy(),
            "dweight": bn.weight.grad.numpy()}


class _Indices:
    """A pipeline whose sample is its index."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def sample(self, i, epoch=0):
        return {"idx": np.array([i, epoch])}


def loader(inp):
    """The indices of every batch of ``TrainLoader(shard=inp["shard"])``
    (default: one process) over epochs 0 and 1 (global batch
    ``inp["batch"]`` of ``inp["n"]``)."""
    from heltondetection_tpu_torch.data.loader import TrainLoader
    ld = TrainLoader(_Indices(inp["n"]), inp["batch"], seed=3,
                     num_workers=1, device="cpu", keys=("idx",),
                     shard=inp.get("shard", (0, 1)))
    return [[b["idx"][:, 0].tolist() for b in ld.host_batches(e)]
            for e in (0, 1)]


def _cfg(inp, work_dir, **train):
    from heltondetection_tpu_torch.configs import base as B
    return B.ExperimentConfig(
        name="run", work_dir=work_dir,
        data=B.DataConfig(train_ann=inp["train_ann"],
                          train_imgs=inp["train_imgs"],
                          val_ann=inp["val_ann"], val_imgs=inp["val_imgs"],
                          max_boxes=8),
        model=B.ModelConfig(variant="n", img_size=S),
        train=B.TrainConfig(**{**dict(epochs=1, batch_size=4, lr=1e-3,
                                      warmup_epochs=0.5, num_workers=1,
                                      eval_interval=1, ckpt_interval=1),
                               **train}),
        eval=B.EvalConfig(batch_size=2))


class _NullTB:
    def __init__(self, *a):
        pass

    def scalars(self, *a, **k):
        pass

    def close(self):
        pass


def sharded_eval(inp):
    """``run_eval`` of a seeded YOLOv5n over the val set (its COCO results
    JSON from rank 0): the stats, and the dets."""
    from heltondetection_tpu_torch.engine import runner
    cfg = _cfg(inp, inp["work"])
    model = runner.build_model(cfg.model, 4)
    from heltondetection_tpu_torch.models.common import init_weights
    init_weights(model, torch.Generator().manual_seed(4))
    os.makedirs(inp["work"], exist_ok=True)
    path = os.path.join(inp["work"], f"dets{M.process_count()}.json")
    stats = runner.run_eval(cfg, model.state_dict(), model, verbose=False,
                            dump_json=path, device="cpu")
    dets = None
    if M.process_index() == 0:
        import json
        with open(path) as f:
            dets = json.load(f)
    return {"stats": stats, "dets": dets}


def early_stop(inp):
    """``train_from_datasets`` of YOLOv5n with ``patience=1`` for up to 4
    epochs (an untrained detector's AP does not rise, so it stops after
    its second eval): best stats, the epochs run, the checksum."""
    from heltondetection_tpu_torch.engine import runner
    runner.TBWriter = _NullTB
    cfg = _cfg(inp, inp["work"], epochs=4, patience=1)
    seen = []
    orig = runner.run_eval

    def counting(*a, **k):
        seen.append(1)
        return orig(*a, **k)

    runner.run_eval = counting
    try:
        best = runner.run_train(cfg, device="cpu")
    finally:
        runner.run_eval = orig
    from heltondetection_tpu_torch.utils import ckpt as ckpt_io
    return {"best": best, "evals": len(seen),
            "step": ckpt_io.latest_step(cfg.ckpt_dir)}


def resume_guard(inp):
    """Rank 0 on the work dir of :func:`early_stop` (a checkpoint to
    resume), rank 1 on an empty one: both must raise the resume
    disagreement."""
    from heltondetection_tpu_torch.engine import runner
    runner.TBWriter = _NullTB
    work = inp["work"] if M.process_index() == 0 else inp["work"] + "_other"
    cfg = _cfg(inp, work, epochs=4)
    try:
        runner.run_train(cfg, device="cpu")
    except ValueError as e:
        return str(e)
    return None


def warm_fork_server():
    """Start multiprocessing's fork server now, with this module and the
    port's engine imported in it, so that a later
    ``run_ranks(start_method="forkserver")`` neither waits for it nor has
    each rank import the engine (``run_ranks``' own preload is a no-op
    once the server runs)."""
    import multiprocessing.forkserver
    import torch.multiprocessing as mp
    mp.get_context("forkserver").set_forkserver_preload([
        M.__name__, __name__, "heltondetection_tpu_torch.engine.runner",
        "heltondetection_tpu_torch.train.trainer"])
    multiprocessing.forkserver.ensure_running()


CASES = {"train_steps": train_steps, "batchnorm": batchnorm,
         "loader": loader, "sharded_eval": sharded_eval,
         "early_stop": early_stop, "resume_guard": resume_guard}


def rank_main(rank, jobs):
    """``jobs``: [(name, case name, input)], run in order; {name: result}.
    One CPU thread a rank."""
    torch.set_num_threads(1)
    return {name: CASES[case](inp) for name, case, inp in jobs}
