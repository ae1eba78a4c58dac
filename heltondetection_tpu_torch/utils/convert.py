"""Weight bridge from the reference's flax variables to the port's modules.

The port's module names follow the flax scopes (``backbone.c3_1.m0.cv1``,
``neck.td4``, ``detect0``, …), so the map is by name: conv kernels go HWIO →
OIHW, dense kernels (cin, out) → (out, cin), BatchNorm ``scale``/``bias``
and the ``batch_stats`` ``mean``/``var`` go to ``weight``/``bias`` and
``running_mean``/``running_var``. A train state maps too: its EMA
parameters (:func:`from_jax_train_state`) and an optax ``adamw`` state's
moments and count onto the port's optimizer (:func:`load_adamw_state`), so
both packages can start from one state mid-training.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

# flax BatchNorm names → torch (a conv or dense "bias" keeps its name)
_BN_NAMES = {"scale": "weight", "mean": "running_mean", "var": "running_var"}


def _leaves(tree: Any, prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    """(path, array) of every array leaf; other leaves (optax's
    ``MaskedNode`` of a frozen parameter) are skipped."""
    if hasattr(tree, "items"):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (str(k),))
    elif hasattr(tree, "shape") and hasattr(tree, "dtype"):
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


def from_jax_train_state(state: Any) -> Tuple[Dict[str, torch.Tensor],
                                              Optional[Dict[str, torch.Tensor]]]:
    """A reference ``TrainState`` (numpy leaves) → (the model's state dict,
    the EMA parameters by name or None), the forms of
    ``train.trainer.TrainState.model`` and ``.ema``."""
    sd = from_jax_variables({"params": state.params,
                             "batch_stats": state.batch_stats})
    ema = None
    if state.ema_params is not None:
        ema = from_jax_variables({"params": state.ema_params})
    return sd, ema


def _adam_states(tree: Any) -> Iterator[Any]:
    """Every optax ``ScaleByAdamState`` (it has ``mu``, ``nu`` and
    ``count``) inside a nested optimizer state."""
    if all(hasattr(tree, f) for f in ("mu", "nu", "count")):
        yield tree
    elif hasattr(tree, "items"):
        for v in tree.values():
            yield from _adam_states(v)
    elif isinstance(tree, (tuple, list)):      # chains and NamedTuples
        for v in tree:
            yield from _adam_states(v)


def load_adamw_state(opt_state: Any, optimizer, model: torch.nn.Module
                     ) -> None:
    """Carry an optax ``adamw`` state (numpy leaves; chained with clipping
    or under ``multi_transform`` as the reference's ``make_optimizer``
    builds it) onto the port's ``train.schedule.Optimizer`` over
    ``model``: ``mu``/``nu`` become each parameter's ``exp_avg``/
    ``exp_avg_sq`` (mapped by name like the weights), ``count`` the
    ``step`` of every parameter the optimizer updates and the schedule's
    position. Frozen parameters (masked in optax) get no state, as the
    port keeps none for them."""
    adam = list(_adam_states(opt_state))
    if len(adam) != 1:
        raise ValueError(f"expected one adam state, found {len(adam)}")
    adam = adam[0]
    mu = from_jax_variables({"params": adam.mu})
    nu = from_jax_variables({"params": adam.nu})
    count = int(np.asarray(adam.count))
    names = {id(p): n for n, p in model.named_parameters()}
    for group in optimizer.opt.param_groups:
        for p in group["params"]:
            n = names[id(p)]
            optimizer.opt.state[p] = {
                "step": torch.tensor(float(count)),
                "exp_avg": mu[n].to(p.device).reshape(p.shape),
                "exp_avg_sq": nu[n].to(p.device).reshape(p.shape)}
    sched = optimizer.sched
    sched.last_epoch = count
    for group, base in zip(optimizer.opt.param_groups, sched.base_lrs):
        group["lr"] = base * sched.lr_lambdas[0](count)


def from_jax_quant_tree(qtree: Any) -> Dict[str, Any]:
    """A reference quant tree (``heltondetection_tpu/ops/quant.py``,
    numpy or jax leaves) → the port's (``ops/quant.py``): ``w_q`` and
    ``w_f`` HWIO → OIHW, scales and biases as they are, and the ResNet
    pairs' flat ``convN_w_q``/``convN_out_scale``/… keys nested under
    ``convN``. Leaves keep their dtype (int8 weights, float32 scales)."""
    fields = ("w_q", "out_scale", "bias", "inv_in_scale")

    def leaf(name: str, v) -> torch.Tensor:
        arr = np.asarray(v)
        if name in ("w_q", "w_f"):
            arr = arr.transpose(3, 2, 0, 1)
        return torch.from_numpy(np.array(arr, order="C"))

    def walk(node) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for k, v in node.items():
            if hasattr(v, "items"):
                out[k] = walk(v)
                continue
            pair = next((f for f in fields if k.endswith("_" + f)), None)
            if pair is not None:
                out.setdefault(k[:-len(pair) - 1], {})[pair] = leaf(pair, v)
            else:
                out[k] = leaf(k, v)
        return out

    return walk(qtree)
