"""Checkpoint I/O for inference; counterpart of ``latest_step`` and
``restore_eval_variables`` in heltondetection_tpu/utils/ckpt.py.

A checkpoint directory holds one sub-directory per step, ``<step>/`` with
``eval_variables.pt`` inside: a ``torch.save`` of ``{"model": state_dict,
"ema": state_dict or None, "step": int}``, the state dicts those of the
port's model (``utils.convert.from_jax_variables`` names). The reference
keeps orbax directories, which only JAX reads;
``utils.convert.checkpoint_from_jax_variables`` carries one across. The
asynchronous writer, the full train-state restore and transfer loading
come with the training slice.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch

_FILE = "eval_variables.pt"


def save_eval_variables(ckpt_dir: str, model_state: Dict[str, torch.Tensor],
                        step: int,
                        ema_state: Optional[Dict[str, torch.Tensor]] = None
                        ) -> str:
    """Write the inference fields of step ``step`` under ``ckpt_dir`` (made
    if missing), tensors moved to the CPU. The file appears under its final
    name only when it is complete. Returns its path."""
    step_dir = os.path.join(ckpt_dir, str(int(step)))
    os.makedirs(step_dir, exist_ok=True)

    def on_cpu(sd):
        return {k: v.detach().cpu() for k, v in sd.items()}

    path = os.path.join(step_dir, _FILE)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({"model": on_cpu(model_state),
                "ema": None if ema_state is None else on_cpu(ema_state),
                "step": int(step)}, tmp)
    os.replace(tmp, path)
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The largest step saved under ``ckpt_dir``, or None (also for a
    directory that does not exist)."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d) for d in os.listdir(ckpt_dir)
             if d.isdigit() and os.path.isfile(os.path.join(ckpt_dir, d, _FILE))]
    return max(steps, default=None)


def restore_eval_variables(ckpt_dir: str, step: Optional[int] = None) -> dict:
    """``{"model", "ema", "step"}`` of the newest (or the given) step, on
    the CPU. Never creates ``ckpt_dir``: a mistyped path must fail."""
    if not os.path.isdir(ckpt_dir):
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    step = latest_step(ckpt_dir) if step is None else step
    path = None if step is None else os.path.join(ckpt_dir, str(step), _FILE)
    if path is None or not os.path.isfile(path):
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    # weights_only: tensors and plain containers, no arbitrary pickles
    saved = torch.load(path, map_location="cpu", weights_only=True)
    return {"model": saved["model"], "ema": saved.get("ema"),
            "step": saved.get("step")}
