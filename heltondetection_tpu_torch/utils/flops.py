"""FLOPs and parameter counts of a detector; counterpart of
heltondetection_tpu/utils/flops.py.

The reference counts with XLA's cost model of the compiled forward. The
port counts from the shapes of the operations the forward runs, with
``torch.utils.flop_counter.FlopCounterMode``: every matrix product and
convolution (``mm``, ``addmm``, ``bmm``, ``baddbmm``, ``convolution`` and
their kin), two FLOPs per multiply-add. It does not count what XLA also
counts: elementwise arithmetic (BatchNorm, activations, residual adds,
``/255``), reductions, pooling and resampling; ``tests/test_torch_port_
artifacts.py`` measures how far the two counts lie apart.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
from torch.utils.flop_counter import FlopCounterMode


def count_params(model: torch.nn.Module) -> int:
    """The number of parameters (BatchNorm statistics are buffers, as they
    are ``batch_stats`` and not ``params`` in the reference)."""
    return int(sum(p.numel() for p in model.parameters()))


def flops_of(fn: Callable, *args) -> float:
    """FLOPs of the matrix products and convolutions of one call
    ``fn(*args)``, counted from their shapes (without autograd)."""
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        fn(*args)
    return float(counter.get_total_flops())


def model_complexity(model: torch.nn.Module, img_size: int,
                     batch_size: int = 1) -> Dict[str, float]:
    """GFLOPs per image and MParams of a detector's forward (a YOLOv5's
    raw head maps; a FasterRCNN's pyramid and RPN outputs, as the
    reference's ``model.apply``) on zero images of ``img_size``², on the
    model's device."""
    dev = next(model.parameters()).device
    x = torch.zeros((batch_size, img_size, img_size, 3), device=dev)
    return {
        "gflops_per_image": flops_of(model, x) / batch_size / 1e9,
        "mparams": count_params(model) / 1e6,
    }
