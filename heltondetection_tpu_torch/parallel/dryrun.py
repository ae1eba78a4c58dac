"""A dry run of every data-parallel program of the port over ``n`` ranks;
counterpart of ``dryrun_multichip`` in the JAX package's
``__graft_entry__.py``.

    python -m heltondetection_tpu_torch.parallel.dryrun 2 [--device cpu]

:func:`dryrun_multichip` spawns ``n`` ranks (``parallel.mesh.run_ranks``:
gloo on the CPU, whatever :func:`~heltondetection_tpu_torch.parallel.mesh.
init_distributed` picks on cards) that each run (1) the YOLOv5
data-parallel train step and (2) the FasterRCNN two-stage one on their
rows of one seeded global batch; every rank must end with the same weights
and finite losses; for ``n`` ≥ 4 and even, the same ranks then run (5)
the YOLOv5 and (6) the FasterRCNN train step on a (n/2 data × 2 spatial)
layout (``parallel/spatial.py``: each image's H rows split over two
ranks, with the halo exchanges and the gathers), with the same checks.
Then one process splits (3) the packed YOLOv5 serve/eval step and (4)
FasterRCNN inference over a mesh of ``n`` devices (the local cards, or
``n`` entries of the CPU), each against the same step on one device.
Small shapes (width 0.125, 64²): it checks the programs run and agree,
not their speed.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, Optional

import numpy as np
import torch

from heltondetection_tpu_torch.parallel import mesh as M

NC, IMG, M_GT = 8, 64, 8
_RCNN = dict(num_classes=NC, img_size=IMG, rpn_pre_nms_topk=64,
             rpn_post_nms_topk=32, rpn_batch=16, box_batch=16,
             backbone="resnet18", backbone_frozen_stages=0,
             backbone_norm_eval=False)


def _yolo():
    from heltondetection_tpu_torch.models.common import init_weights
    from heltondetection_tpu_torch.models.yolov5 import YOLOv5
    m = YOLOv5(NC, 0.33, 0.125)
    init_weights(m, torch.Generator().manual_seed(0))
    return m


def _rcnn():
    from heltondetection_tpu_torch.models.common import init_weights
    from heltondetection_tpu_torch.models.faster_rcnn import (FasterRCNN,
                                                              RCNNConfig)
    m = FasterRCNN(RCNNConfig(**_RCNN))
    init_weights(m, torch.Generator().manual_seed(1))
    return m


def _batch(b: int, rcnn: bool, dev) -> Dict[str, torch.Tensor]:
    """A seeded global batch: uint8 frames, 8 gts an image (xyxy for
    FasterRCNN, cxcywh for YOLOv5)."""
    rng = np.random.default_rng(3 if rcnn else 2)
    xy = rng.uniform(8, 40, (b, M_GT, 2))
    wh = rng.uniform(8, 24, (b, M_GT, 2))
    boxes = np.concatenate([xy, xy + wh] if rcnn else [xy + wh / 2, wh], -1)
    out = {"image": rng.integers(0, 256, (b, IMG, IMG, 3)).astype(np.uint8),
           "gt_boxes_xyxy" if rcnn else "gt_boxes": boxes.astype(np.float32),
           "gt_cls": rng.integers(0, NC, (b, M_GT)).astype(np.int32),
           "gt_mask": np.ones((b, M_GT), bool)}
    return {k: torch.from_numpy(v).to(dev) for k, v in out.items()}


def _rank_steps(rank: int, n: int, device: Optional[str]) -> Dict:
    """One rank: the YOLOv5 and FasterRCNN train steps on its rows, then,
    for n ≥ 4 and even, :func:`spatial_rank_steps`."""
    out = _dp_steps(n, device)
    if n >= 4 and n % 2 == 0:
        out.update(spatial_rank_steps(rank, n, device))
    return out


def _dp_steps(n: int, device: Optional[str], spatial: int = 1) -> Dict:
    """The YOLOv5 and FasterRCNN train steps of this rank: 2 images a
    data rank, ``spatial`` ranks to an image."""
    from heltondetection_tpu_torch.device import resolve_device
    from heltondetection_tpu_torch.train.schedule import make_optimizer
    from heltondetection_tpu_torch.train.trainer import (
        create_train_state, make_rcnn_train_step, make_train_step)
    from heltondetection_tpu_torch.train.yolo_loss import YoloLossConfig
    dev = resolve_device(device)
    n_data = n // spatial
    out = {}
    for name, model, step, rng in (
            ("yolo", _yolo(),
             make_train_step(YoloLossConfig(num_classes=NC, img_size=IMG),
                             spatial_shards=spatial),
             None),
            ("rcnn", _rcnn(), make_rcnn_train_step(spatial_shards=spatial),
             torch.Generator(dev).manual_seed(5))):
        model = model.to(dev)
        if name == "yolo":
            model.packed_train = True
        M.replicate(model)
        state = create_train_state(model, make_optimizer(
            model, 1e-3, total_steps=10, warmup_steps=1), rng=rng)
        batch = _batch(2 * n_data, name == "rcnn", dev)
        state, metrics = step(state, {
            k: M.rank_rows(v, n_data, M.process_index() // spatial)
            for k, v in batch.items()})
        out[name] = {"total": float(metrics["total"]),
                     "checksum": M.state_checksum(model)}
    return out


def spatial_rank_steps(rank: int, n: int, device: Optional[str]) -> Dict:
    """(5) and (6) of one rank of ``n`` (≥ 4, even): the YOLOv5 and
    FasterRCNN train steps on a (n/2 × 2) data × spatial layout, 2 images
    a data rank, each rank on its band of their rows; keyed
    ``yolo_spatial`` and ``rcnn_spatial``."""
    if n < 4 or n % 2:
        raise ValueError(f"the data x spatial programs need an even n >= 4, "
                         f"not {n}")
    return {f"{k}_spatial": v for k, v in _dp_steps(n, device, 2).items()}


def _mesh_steps(n: int, device: Optional[str]) -> Dict:
    """One process over a mesh of n devices: the packed YOLOv5 serve step
    and FasterRCNN inference, each batch split by rows, against one
    device."""
    from heltondetection_tpu_torch.engine.evaluator import (
        dispatch_sharded, dispatch_step, fetch_dets, make_packed_serve_step)
    from heltondetection_tpu_torch.models.faster_rcnn import \
        faster_rcnn_infer
    mesh = M.create_mesh(n if device == "cpu" else min(
        n, torch.cuda.device_count()), device=device)
    rng = np.random.default_rng(4)
    x = rng.integers(0, 256, (2 * mesh.size, IMG, IMG, 3)).astype(np.uint8)
    yolo = _yolo().eval()
    steps = [make_packed_serve_step(m, NC, conf_thres=0.01, pre_nms_topk=128,
                                    max_det=16, device=d)
             for m, d in zip(M.replicate(yolo, mesh), mesh.devices)]
    rcnn = _rcnn().eval()

    def rcnn_step(m, d):
        m = m.to(d).eval()

        @torch.inference_mode()
        def step(images):
            return faster_rcnn_infer(m, torch.as_tensor(images).to(d)
                                     .float() / 255.0)
        return step

    rsteps = [rcnn_step(m, d) for m, d in zip(M.replicate(rcnn, mesh),
                                              mesh.devices)]
    out = {"devices": mesh.size}
    for name, ss in (("yolo_serve", steps), ("rcnn_infer", rsteps)):
        got = fetch_dets(dispatch_sharded(ss, x, mesh))
        want = fetch_dets(dispatch_step(ss[0], x, mesh.devices[0]))
        err = max(float(np.abs(np.asarray(a, np.float64) -
                               np.asarray(b, np.float64)).max())
                  for a, b in zip(got, want))
        if not all(np.isfinite(np.asarray(a, np.float64)).all()
                   for a in got) or err > 1e-3:
            raise AssertionError(f"{name} over {mesh.size} devices: "
                                 f"differs from one device by {err}")
        out[name] = {"dets": int(np.asarray(got[3]).sum()),
                     "max_abs_err": err}
    return out


def dryrun_multichip(n_devices: int, device: Optional[str] = None,
                     timeout_s: float = 600.0) -> Dict:
    """Run every data-parallel program over ``n_devices`` ranks and a mesh
    of as many devices (module docstring); raises on any disagreement.
    ``device="cpu"`` runs on the CPU; the default is the cards."""
    ranks = M.run_ranks(_rank_steps, n_devices, (n_devices, device),
                        backend="gloo" if device == "cpu" else None,
                        timeout_s=timeout_s)
    for name in ranks[0]:
        vals = {r[name]["checksum"] for r in ranks}
        if len(vals) != 1 or not all(np.isfinite(r[name]["total"])
                                     for r in ranks):
            raise AssertionError(f"{name} over {n_devices} ranks: "
                                 f"{[r[name] for r in ranks]}")
        what = (f"{name[:-8]}-2d data{n_devices // 2}xspatial2"
                if name.endswith("_spatial") else f"{name}-dp")
        print(f"dryrun_multichip({n_devices}): {what} ok, "
              f"loss={ranks[0][name]['total']:.4f}")
    out = {"ranks": ranks, "mesh": _mesh_steps(n_devices, device)}
    for name in ("yolo_serve", "rcnn_infer"):
        print(f"dryrun_multichip({n_devices}): {name} over "
              f"{out['mesh']['devices']} devices ok, "
              f"dets={out['mesh'][name]['dets']}")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser("heltondetection_tpu_torch.parallel.dryrun")
    p.add_argument("n", type=int, help="ranks (and mesh devices)")
    p.add_argument("--device", default=None, help="cpu, or the cards")
    args = p.parse_args(argv)
    dryrun_multichip(args.n, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
