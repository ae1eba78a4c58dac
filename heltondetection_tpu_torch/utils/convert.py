"""Weight bridge from the reference's flax variables to the port's modules.

The port's module names follow the flax scopes (``backbone.c3_1.m0.cv1``,
``neck.td4``, ``detect0``, …), so the map is by name: conv kernels go HWIO →
OIHW, dense kernels (cin, out) → (out, cin), BatchNorm ``scale``/``bias``
and the ``batch_stats`` ``mean``/``var`` go to ``weight``/``bias`` and
``running_mean``/``running_var``.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

# flax BatchNorm names → torch (a conv or dense "bias" keeps its name)
_BN_NAMES = {"scale": "weight", "mean": "running_mean", "var": "running_var"}


def _leaves(tree: Any, prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    if hasattr(tree, "items"):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (str(k),))
    else:
        yield prefix, np.asarray(tree)


def _tensor(arr: np.ndarray) -> torch.Tensor:
    """A float32 tensor that owns a C-ordered copy of ``arr``."""
    return torch.from_numpy(np.array(arr, np.float32, order="C"))


def from_jax_variables(variables: Any) -> Dict[str, torch.Tensor]:
    """Flax ``{"params", "batch_stats"}`` tree (numpy leaves) → a state dict
    for the port's model with the same head layout (standard ``detect{i}``
    convs, or the packed ``detect{i}_obj``/``detect{i}_cand{a}`` dense
    layers)."""
    sd: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, arr in _leaves(variables.get(collection, {})):
            *scope, leaf = path
            key = ".".join(scope)
            if leaf == "kernel":
                if arr.ndim == 4:                  # HWIO → OIHW
                    arr = arr.transpose(3, 2, 0, 1)
                else:                              # (cin, out) → (out, cin)
                    arr = arr.T
                sd[f"{key}.weight"] = _tensor(arr)
                continue
            sd[f"{key}.{_BN_NAMES.get(leaf, leaf)}"] = _tensor(arr)
            if leaf == "mean":
                sd[f"{key}.num_batches_tracked"] = torch.tensor(0)
    return sd


def checkpoint_from_jax_variables(variables: Any, ckpt_dir: str, step: int = 0,
                                  ema_params: Optional[Any] = None) -> str:
    """Carry a reference checkpoint across: the flax ``{"params",
    "batch_stats"}`` tree (numpy leaves, e.g. the reference's
    ``restore_eval_variables`` output after ``jax.device_get``) is written
    as a checkpoint of the port under ``ckpt_dir``. ``ema_params``, the
    reference's EMA parameter tree, becomes the ``ema`` state dict, with
    the same ``batch_stats``. Returns the file written."""
    from heltondetection_tpu_torch.utils.ckpt import save_eval_variables
    ema = None
    if ema_params is not None:
        ema = from_jax_variables({
            "params": ema_params,
            "batch_stats": variables.get("batch_stats", {})})
    return save_eval_variables(ckpt_dir, from_jax_variables(variables), step,
                               ema_state=ema)
