"""The train step, its state and the EMA; counterpart of
heltondetection_tpu/train/trainer.py.

One eager step: uint8 images are divided by 255 inside it, the model runs
in training mode (BatchNorm on batch statistics, moving its running ones),
the loss is the batch-scaled YOLOv5 total whose gradient ``backward``
takes, then the optimizer (clipping, AdamW, schedule) and the EMA of the
parameters. Compute runs in the model's dtype (bfloat16 on the card) over
float32 master weights, and the loss in float32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from heltondetection_tpu_torch.models.dropblock import reseed_dropblock
from heltondetection_tpu_torch.train.schedule import Optimizer
from heltondetection_tpu_torch.train.yolo_loss import (YoloLossConfig,
                                                       yolo_loss,
                                                       yolo_loss_packed)


@dataclass
class TrainState:
    """What a train run carries from step to step: the model (parameters and
    BatchNorm statistics), the optimizer (moments, update count, schedule),
    the step count and the EMA of the parameters by name (None without
    EMA)."""
    model: torch.nn.Module
    optimizer: Optimizer
    step: int = 0
    ema: Optional[Dict[str, torch.Tensor]] = None


def create_train_state(model: torch.nn.Module, optimizer: Optimizer,
                       use_ema: bool = True) -> TrainState:
    """A state at step 0; the EMA starts as a copy of the parameters."""
    ema = ({n: p.detach().clone() for n, p in model.named_parameters()}
           if use_ema else None)
    return TrainState(model, optimizer, 0, ema)


def ema_decay_schedule(step: int, base: float = 0.9999,
                       tau: float = 2000.0) -> float:
    """Ultralytics ModelEMA ramp: d = base · (1 − exp(−step/tau))."""
    return base * (1.0 - math.exp(-step / tau))


@torch.no_grad()
def update_ema(ema: Dict[str, torch.Tensor], model: torch.nn.Module,
               step: int) -> None:
    """``ema ← ema·d + params·(1 − d)`` with d at ``step``, the count before
    this update, so step 0 copies the parameters. Parameters only: the
    reference averages no BatchNorm statistics (Ultralytics' ModelEMA
    does), and neither does the port."""
    d = ema_decay_schedule(step)
    names, params = zip(*model.named_parameters())
    e = [ema[n] for n in names]
    torch._foreach_mul_(e, d)
    torch._foreach_add_(e, [p.detach() for p in params], alpha=1.0 - d)


def grad_global_norm(model: torch.nn.Module) -> torch.Tensor:
    """The global norm of every parameter's gradient, frozen ones included
    (``optax.global_norm`` of the reference's grads)."""
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    return torch.nn.utils.get_total_norm(grads)


def _loss_on(model, batch, loss_cfg: YoloLossConfig):
    img = batch["image"]
    if img.dtype == torch.uint8:
        img = img.float() / 255.0           # normalization inside the step
    outs = model(img)
    # the packed train head gives per-level tuples, the standard one maps
    loss_impl = yolo_loss_packed if isinstance(outs[0], tuple) else yolo_loss
    return loss_impl(outs, batch["gt_boxes"], batch["gt_cls"],
                     batch["gt_mask"], loss_cfg)


def _accum_grads(model, batch, loss_cfg: YoloLossConfig,
                 accum_steps: int) -> Dict[str, torch.Tensor]:
    """Micro-batch gradient accumulation: micro-batch i takes the
    interleaved rows ``i::accum_steps``, as the reference's scan does. The
    YOLO loss is batch-scaled, so micro-batch gradients add up to the
    full-batch one: they are summed in ``.grad``; the ``total`` metric is
    summed and the per-term ones averaged. BatchNorm statistics chain
    through the micro-batches, as ``accum_steps`` real small steps would."""
    sums: Dict[str, torch.Tensor] = {}
    for i in range(accum_steps):
        micro = {k: v[i::accum_steps] for k, v in batch.items()}
        loss, metrics = _loss_on(model, micro, loss_cfg)
        loss.backward()
        for k, v in metrics.items():
            sums[k] = sums.get(k, 0) + v.detach()
    return {k: v if k == "total" else v / accum_steps
            for k, v in sums.items()}


def make_train_step(loss_cfg: YoloLossConfig, use_ema: bool = True,
                    accum_steps: int = 1, seed: int = 0
                    ) -> Callable[[TrainState, Dict], Tuple[TrainState, Dict]]:
    """``train_step(state, batch) → (state, metrics)``; the state is updated
    in place and returned.

    ``batch``: ``image`` (B, S, S, 3) uint8 or float in [0, 1],
    ``gt_boxes`` (B, M, 4) cxcywh pixels, ``gt_cls`` (B, M) int, ``gt_mask``
    (B, M) bool, all on the model's device. The metrics (``box``, ``obj``,
    ``cls``, ``total``, ``grad_norm``, the norm before clipping) stay 0-d
    tensors on the device: reading one waits for the step. The gradients
    stay in ``.grad`` until the next step. A model with DropBlock draws
    from generators seeded by (``seed``, step), the reference's fold of the
    step into its dropout key."""

    def train_step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        model = state.model
        model.train()
        reseed_dropblock(model, seed, state.step)
        model.zero_grad(set_to_none=True)      # frozen parameters too
        if accum_steps > 1:
            metrics = _accum_grads(model, batch, loss_cfg, accum_steps)
        else:
            loss, metrics = _loss_on(model, batch, loss_cfg)
            loss.backward()
            metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = grad_global_norm(model)
        state.optimizer.step()
        if use_ema and state.ema is not None:
            update_ema(state.ema, model, state.step)
        state.step += 1
        return state, metrics

    return train_step


def multiscale_sizes(img_size: int, factors, stride: int = 32
                     ) -> Tuple[int, ...]:
    """Multi-scale bucket sizes: each factor maps ``img_size`` to the
    nearest multiple of the coarsest head stride. Factors must be in (0, 1]:
    the host renders at ``img_size``, so upscaling would invent pixels; set
    img_size to the largest wanted scale instead."""
    sizes = []
    for f in factors:
        if not 0.0 < f <= 1.0:
            raise ValueError(
                f"multi_scale factor {f} out of (0, 1]: the host renders "
                "at img_size — raise model.img_size to the largest scale "
                "and express the rest as fractions of it")
        s = max(int(round(img_size * f / stride)) * stride, stride)
        if s not in sizes:
            sizes.append(s)
    if not sizes:
        raise ValueError("multi_scale needs at least one factor")
    return tuple(sorted(sizes))


def resize_batch_to(batch: Dict, size: int) -> Dict:
    """Resize a train batch's images to ``size``² (bilinear) and scale its
    gt boxes to match. ``jax.image.resize(..., "bilinear")`` antialiases
    when it shrinks, so this does too (``antialias=True``). A same-size
    call returns the batch unchanged (uint8 stays uint8)."""
    img = batch["image"]
    s0 = img.shape[1]
    if size == s0:
        return batch
    if img.dtype == torch.uint8:
        img = img.float() / 255.0
    r = size / s0
    x = F.interpolate(img.permute(0, 3, 1, 2),
                      size=(size, int(round(img.shape[2] * r))),
                      mode="bilinear", align_corners=False, antialias=True)
    out = dict(batch)
    out["image"] = x.permute(0, 2, 3, 1)
    out["gt_boxes"] = batch["gt_boxes"] * r      # cxcywh pixels: linear
    return out
