"""Learning-rate schedule and optimizer: AdamW with linear warmup and
cosine decay; counterpart of heltondetection_tpu/train/schedule.py.

The reference's optax chain, written for torch:

- ``torch.optim.AdamW`` with two parameter groups, decay for the rank ≥ 2
  kernels and none for biases and BatchNorm's scale and bias (the
  reference's ``_decay_mask``), and a ``LambdaLR`` of
  :func:`warmup_cosine`. optax evaluates the schedule at the update count
  *before* the update, so the first step runs at ``base ·
  warmup_init_frac`` (0); the lambda here is read at the same count.
- Clipping by the global norm as ``optax.clip_by_global_norm``: grads are
  scaled by ``max / norm`` only when ``norm > max``
  (``clip_grad_norm_`` would scale by ``max / (norm + 1e-6)``).
- Frozen prefixes as ``optax.set_to_zero`` under ``multi_transform``: a
  frozen parameter gets no update, no decay and no moments, and its
  gradient is left out of the clipping norm (it still has one).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn as nn


def warmup_cosine(base_lr: float, total_steps: int, warmup_steps: int,
                  final_lr_frac: float = 0.1, warmup_init_frac: float = 0.0
                  ) -> Callable[[int], float]:
    """Linear warmup → cosine decay to ``base_lr · final_lr_frac``: the
    learning rate at update count ``step`` (optax's ``join_schedules`` of a
    linear and a cosine schedule)."""
    warmup_steps = max(int(warmup_steps), 1)
    decay_steps = max(int(total_steps) - warmup_steps, 1)
    init = base_lr * warmup_init_frac

    def lr(step: int) -> float:
        if step < warmup_steps:
            return init + (base_lr - init) * min(max(step / warmup_steps, 0.0),
                                                 1.0)
        count = min(step - warmup_steps, decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))
        return base_lr * ((1.0 - final_lr_frac) * cosine + final_lr_frac)

    return lr


def global_norm(tensors) -> torch.Tensor:
    """The L2 norm of all ``tensors`` together (one device), as a float32
    0-d tensor, each tensor's sum of squares accumulated in float64:
    torch's float32 norm of one tensor of millions of elements is off by
    up to 5e-4 relative on the CPU (a 12.8M-element dense layer's
    gradient), where ``optax.global_norm`` is not."""
    norms = torch._foreach_norm(list(tensors), 2.0, dtype=torch.float64)
    return torch.linalg.vector_norm(torch.stack(norms)).float()


def param_path(name: str) -> str:
    """A torch parameter name as the reference's "/"-joined flax path
    (``backbone.stem.conv.weight`` → ``backbone/stem/conv/weight``), the
    form ``frozen_prefixes`` is written in."""
    return name.replace(".", "/")


class Optimizer:
    """AdamW + schedule + global-norm clipping over the named parameters of
    a model; see the module docstring. ``step()`` applies one update from
    the parameters' ``.grad`` (clipping them in place) and advances the
    schedule. ``state_dict``/``load_state_dict`` cover the moments, the
    update count and the schedule."""

    def __init__(self, named_params, base_lr: float = 1e-3, *,
                 total_steps: int = 10000, warmup_steps: int = 500,
                 weight_decay: float = 5e-4, final_lr_frac: float = 0.1,
                 grad_clip: Optional[float] = 10.0, b1: float = 0.9,
                 b2: float = 0.999, frozen_prefixes: Sequence[str] = ()):
        self.grad_clip = grad_clip
        decay, no_decay = [], []
        for name, p in named_params:
            if not any(param_path(name).startswith(pref)
                       for pref in frozen_prefixes):
                (decay if p.ndim >= 2 else no_decay).append(p)
        self.params: List[torch.Tensor] = decay + no_decay
        groups = [{"params": decay, "weight_decay": weight_decay},
                  {"params": no_decay, "weight_decay": 0.0}]
        self.opt = torch.optim.AdamW([g for g in groups if g["params"]],
                                     lr=base_lr, betas=(b1, b2), eps=1e-8)
        sched = warmup_cosine(base_lr, total_steps, warmup_steps,
                              final_lr_frac)
        self.sched = torch.optim.lr_scheduler.LambdaLR(
            self.opt, lambda step: sched(step) / base_lr)

    @torch.no_grad()
    def clip_(self) -> None:
        """Scale the trainable grads by ``max / norm`` when their global
        norm (:func:`global_norm`) exceeds ``grad_clip`` (one fused norm,
        no host read)."""
        if self.grad_clip is None:
            return
        grads = [p.grad for p in self.params if p.grad is not None]
        if not grads:
            return
        norm = global_norm(grads)
        scale = torch.where(norm < self.grad_clip, torch.ones_like(norm),
                            self.grad_clip / norm)
        torch._foreach_mul_(grads, scale)

    def step(self) -> None:
        self.clip_()
        self.opt.step()
        self.sched.step()

    def state_dict(self) -> Dict:
        return {"opt": self.opt.state_dict(), "sched": self.sched.state_dict()}

    def load_state_dict(self, state: Dict) -> None:
        self.opt.load_state_dict(state["opt"])
        self.sched.load_state_dict(state["sched"])


def make_optimizer(model: nn.Module, base_lr: float = 1e-3, *,
                   total_steps: int = 10000, warmup_steps: int = 500,
                   weight_decay: float = 5e-4, final_lr_frac: float = 0.1,
                   grad_clip: Optional[float] = 10.0, b1: float = 0.9,
                   b2: float = 0.999, frozen_prefixes: tuple = ()
                   ) -> Optimizer:
    """The reference's ``make_optimizer`` over ``model``'s parameters.
    ``frozen_prefixes``: prefixes of the "/"-joined parameter path to
    freeze (``("backbone",)`` freezes the backbone, the reference's
    frozen-backbone ablation)."""
    return Optimizer(model.named_parameters(), base_lr,
                     total_steps=total_steps, warmup_steps=warmup_steps,
                     weight_decay=weight_decay, final_lr_frac=final_lr_frac,
                     grad_clip=grad_clip, b1=b1, b2=b2,
                     frozen_prefixes=frozen_prefixes)
