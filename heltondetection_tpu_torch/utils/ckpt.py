"""Checkpoint I/O; counterpart of heltondetection_tpu/utils/ckpt.py.

A checkpoint directory holds one sub-directory per step, ``<step>/``, with:

- ``train_state.pt``: ``{"model": state_dict, "optimizer": the optimizer's
  state (moments, update count, schedule), "ema": the EMA of the
  parameters by name or None, "step": int, "rng": the state of the step's
  generator or None}``, what a resumed run restores;
- ``eval_variables.pt``: ``{"model": state_dict, "ema": state_dict or
  None, "step": int}``, the inference fields (the EMA state dict holds the
  EMA parameters and the model's BatchNorm statistics), what eval, serving
  and ``load_detector`` read.

The state dicts are those of the port's model (``utils.convert`` names).
Each file appears under its final name only when complete; the reference
keeps orbax directories, which only JAX reads, and
``utils.convert.checkpoint_from_jax_variables`` carries one across.
"""

from __future__ import annotations

import os
import shutil
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional

import torch

_FILE = "eval_variables.pt"
STATE_FILE = "train_state.pt"
WAIT_S = 600.0   # the longest a save may wait for the previous write


def _on_cpu(tree: Any) -> Any:
    """A copy of ``tree`` with every tensor copied to the CPU (a snapshot
    that later in-place updates cannot touch)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _on_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_on_cpu(v) for v in tree)
    return tree


def _write(path: str, obj: Any) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_eval_variables(ckpt_dir: str, model_state: Dict[str, torch.Tensor],
                        step: int,
                        ema_state: Optional[Dict[str, torch.Tensor]] = None
                        ) -> str:
    """Write the inference fields of step ``step`` under ``ckpt_dir`` (made
    if missing), tensors moved to the CPU. Returns the file's path."""
    step_dir = os.path.join(ckpt_dir, str(int(step)))
    os.makedirs(step_dir, exist_ok=True)
    path = os.path.join(step_dir, _FILE)
    _write(path, {"model": _on_cpu(model_state),
                  "ema": None if ema_state is None else _on_cpu(ema_state),
                  "step": int(step)})
    return path


def snapshot(state) -> Dict[str, Any]:
    """The fields of a ``train.trainer.TrainState`` as CPU tensors:
    ``{"model", "optimizer", "ema", "step", "rng"}``, the
    ``train_state.pt`` layout. A CUDA tensor's copy waits for the work
    that writes it."""
    return {"model": _on_cpu(state.model.state_dict()),
            "optimizer": _on_cpu(state.optimizer.state_dict()),
            "ema": _on_cpu(state.ema), "step": int(state.step),
            "rng": None if state.rng is None else state.rng.get_state()}


def _write_snapshot(ckpt_dir: str, snap: Dict[str, Any],
                    max_to_keep: Optional[int]) -> None:
    step_dir = os.path.join(ckpt_dir, str(snap["step"]))
    os.makedirs(step_dir, exist_ok=True)
    _write(os.path.join(step_dir, STATE_FILE), snap)
    ema = None if snap["ema"] is None else {**snap["model"], **snap["ema"]}
    _write(os.path.join(step_dir, _FILE), {
        "model": snap["model"], "ema": ema, "step": snap["step"]})
    if max_to_keep:
        steps = sorted(int(d) for d in os.listdir(ckpt_dir) if d.isdigit())
        for old in steps[:-max_to_keep]:
            shutil.rmtree(os.path.join(ckpt_dir, str(old)),
                          ignore_errors=True)


def save_state(ckpt_dir: str, state, step: int,
               max_to_keep: int = 3) -> None:
    """Write ``state`` as step ``step`` and wait for it; keep the newest
    ``max_to_keep`` steps."""
    snap = snapshot(state)
    snap["step"] = int(step)
    _write_snapshot(ckpt_dir, snap, max_to_keep)


class CheckpointWriter:
    """Asynchronous checkpoint writer for the training loop: ``save``
    snapshots the state to CPU tensors before it returns, so the next step
    cannot race the write, and writes on a background thread while
    training goes on. At most one write is in flight: a ``save`` (or
    ``close``) first waits for the previous one, and raises its error.
    Keeps the newest ``max_to_keep`` steps."""

    def __init__(self, ckpt_dir: str, max_to_keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.max_to_keep = max_to_keep
        os.makedirs(ckpt_dir, exist_ok=True)
        self._pool = ThreadPoolExecutor(1)
        self._pending = None

    def save(self, state, step: int) -> None:
        snap = snapshot(state)
        snap["step"] = int(step)
        self.wait()
        self._pending = self._pool.submit(_write_snapshot, self.ckpt_dir,
                                          snap, self.max_to_keep)

    def wait(self) -> None:
        """Block until the write in flight, if any, is on disk."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result(timeout=WAIT_S)

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._pool.shutdown(wait=True)

    def __enter__(self) -> "CheckpointWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def latest_step(ckpt_dir: str, file: str = _FILE) -> Optional[int]:
    """The largest step under ``ckpt_dir`` that holds ``file`` (the
    inference fields unless told otherwise), or None (also for a directory
    that does not exist)."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d) for d in os.listdir(ckpt_dir)
             if d.isdigit() and os.path.isfile(os.path.join(ckpt_dir, d, file))]
    return max(steps, default=None)


def _load(ckpt_dir: str, step: Optional[int], file: str) -> dict:
    """Never creates ``ckpt_dir``: a mistyped path must fail."""
    if not os.path.isdir(ckpt_dir):
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    step = latest_step(ckpt_dir, file) if step is None else step
    path = None if step is None else os.path.join(ckpt_dir, str(step), file)
    if path is None or not os.path.isfile(path):
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    # weights_only: tensors and plain containers, no arbitrary pickles
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_eval_variables(ckpt_dir: str, step: Optional[int] = None) -> dict:
    """``{"model", "ema", "step"}`` of the newest (or the given) step, on
    the CPU."""
    saved = _load(ckpt_dir, step, _FILE)
    return {"model": saved["model"], "ema": saved.get("ema"),
            "step": saved.get("step")}


def restore_state(ckpt_dir: str, state, step: Optional[int] = None):
    """Load the newest (or the given) step's ``train_state.pt`` into
    ``state`` (a ``train.trainer.TrainState``; its generator continues the
    saved one's stream) and return it. A checkpoint
    of another model (other keys or shapes) raises ValueError before
    anything is changed."""
    saved = _load(ckpt_dir, step, STATE_FILE)
    own = state.model.state_dict()
    if saved["model"].keys() != own.keys() or any(
            saved["model"][k].shape != v.shape for k, v in own.items()):
        raise ValueError(f"the checkpoint under {ckpt_dir} is of another "
                         f"model (keys or shapes differ)")
    if (saved["ema"] is None) != (state.ema is None):
        raise ValueError("the checkpoint and the run disagree on EMA")
    state.model.load_state_dict(saved["model"])
    state.optimizer.load_state_dict(saved["optimizer"])
    if state.ema is not None:
        with torch.no_grad():
            for k, v in state.ema.items():
                v.copy_(saved["ema"][k])
    state.step = int(saved["step"])
    if state.rng is not None and saved.get("rng") is not None:
        state.rng.set_state(saved["rng"])
    return state


def load_params_for_transfer(ckpt_dir: str, model: torch.nn.Module,
                             step: Optional[int] = None,
                             skip_prefixes: tuple = ()) -> int:
    """Copy into ``model`` the parameters of a checkpoint's model that
    match by name and shape (a head of another class count keeps its
    init); names starting with one of ``skip_prefixes`` are skipped.
    Returns how many were copied."""
    saved = _load(ckpt_dir, step, _FILE)["model"]
    n = 0
    with torch.no_grad():
        for name, p in model.named_parameters():
            src = saved.get(name)
            if src is not None and src.shape == p.shape and not any(
                    name.startswith(pref) for pref in skip_prefixes):
                p.copy_(src)
                n += 1
    return n
