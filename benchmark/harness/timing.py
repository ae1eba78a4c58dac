"""Timing on the card: frozen copies of ``chip_smoke.py:450-457``
(``nvidia_smi_line``) and ``chip_smoke.py:498-511`` (``cuda_ms``)."""

from __future__ import annotations

import subprocess

import torch


def nvidia_smi_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    if not out:
        raise RuntimeError("nvidia-smi reported no GPU")
    return out[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean ms of fn() over iters runs, by CUDA events after warmup."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters
