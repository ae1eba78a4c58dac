"""The train window: the program's train step over a ring of batches on
the card for ``--seconds``, ending on a ``synchronize``.

Set-up builds one train state and drives it through the window's own call
on the ring's first ``check_steps`` batches (distinct rows), reading the
losses, the first gradient from the optimizer's first moment after step 1
and the parameters' and the EMA's move after the last; the same state then
steps through the window. ``train_img_per_s`` is every image stepped over
the window. Once the window has closed and the program is freed, the plain
reference follows those first steps from the same weights and batches."""

from __future__ import annotations

import math
import time
from typing import Dict, Optional

import torch

from benchmark.drivers.eval import CALIB, free
from benchmark.harness import frames
from benchmark.harness.timing import cuda_ms
from benchmark.reference import common as rc
from benchmark.reference import compare

PROFILE_S = 1.0        # seconds of steps a traced run profiles


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.detach().double()))


def _half(b: Dict, draws):
    """The fault "half of the batch left out": the first half of the rows
    (and of the draws), the loss a mean over them."""
    n = b["image"].shape[0] // 2
    b = {k: v[:n] for k, v in b.items()}
    if draws is not None:
        draws = tuple(tuple(t[:n] for t in part) for part in draws)
    return b, draws


def program_readings(cell, weights, ring, draws, device, fault=None):
    """Build the program's train state, take ``check_steps`` steps on the
    ring's first batches through the window's own call, and read them.
    Returns (program, readings keyed by the reference's leaf names)."""
    cfg, fam = cell.config, cell.family
    prog = fam.TrainProgram(cfg, weights, device)
    names = fam.port_to_reference_names(cfg, weights)
    model = prog.state.model
    params = dict(model.named_parameters())
    p0 = {n: p.detach().clone() for n, p in params.items()}
    b1 = cfg["train"]["betas"][0]
    losses, grads, grad_norm = [], {}, None
    for s in range(cell.traffic["check_steps"]):
        b, d = prog.batch(ring[s]), draws[s]
        if fault == "half":
            b, d = _half(b, d)
        m = prog.step(b, d)
        losses.append({k: float(v) for k, v in m.items() if k != "grad_norm"})
        if s == 0:
            grad_norm = float(m["grad_norm"])
            opt_state = prog.state.optimizer.opt.state
            grads = {names[n]: _norm(opt_state[p]["exp_avg"]) / (1 - b1)
                     for n, p in params.items() if p in opt_state}
    ema = prog.state.ema or {}
    got = {"loss": losses, "grad_norm": grad_norm, "grad": grads,
           "change": {names[n]: _norm(p - p0[n]) for n, p in params.items()},
           "ema": {names[n]: _norm(ema[n] - p0[n]) for n in ema}}
    return prog, got


def reference_readings(cell, weights, ring, draws, device, cast=None):
    """The plain reference's readings of the same steps, from the same
    weights, batches and draws; ``cast`` runs its products in a lower
    precision (the control)."""
    cfg, fam = cell.config, cell.family
    tc = cfg["train"]
    model = fam.reference_model(cfg, weights, device).train()
    rc.set_cast(model, cast)
    params = {}
    for n, p in model.named_parameters():
        if fam.reference_frozen(n, cfg):
            p.requires_grad_(False)
        else:
            params[n] = p
    opt = rc.PlainAdamW(params, tc, fam.steps_per_epoch(cfg))
    p0 = {n: p.detach().clone() for n, p in params.items()}
    ema = {n: p.detach().clone() for n, p in params.items()}
    losses, grads, grad_norm = [], {}, None
    with rc.no_tf32():
        for s in range(cell.traffic["check_steps"]):
            model.zero_grad(set_to_none=True)
            total, terms = fam.reference_loss(cfg, model, ring[s], draws[s])
            total.backward()
            g = {n: p.grad for n, p in params.items()}
            if s == 0:
                grad_norm = math.sqrt(sum(_norm(v) ** 2 for v in g.values()))
            clipped = opt.step(g)
            if s == 0:
                grads = rc.leaf_norms(clipped)
            rc.ema_update(ema, params, s, tc["ema_base"], tc["ema_tau"])
            losses.append({k: float(v.detach()) for k, v in terms.items()})
    return {"loss": losses, "grad_norm": grad_norm, "grad": grads,
            "change": {n: _norm(p - p0[n]) for n, p in params.items()},
            "ema": {n: _norm(ema[n] - p0[n]) for n in params}}


def _inputs(cell, seed: int, device):
    cfg, fam = cell.config, cell.family
    ring = frames.train_ring(cell.traffic, cfg, seed, cfg["train"]["batch"],
                             device)
    make = getattr(fam, "make_draws", None)
    draws = (make(cfg, seed, len(ring), device) if make
             else [None] * len(ring))
    return ring, draws


def readings(cell, seed: int, device, *, control: bool = False,
             fault: Optional[str] = None) -> Dict[str, float]:
    """The compared numbers of one seed, without a window: the program's
    first steps (or with ``control`` the reference's own in float8, or with
    ``fault`` a planted fault) against the reference's."""
    ring, draws = _inputs(cell, seed, device)
    weights = cell.family.make_weights(cell.config, seed, device,
                                       ring[0]["image"][:CALIB])
    if control:
        got = reference_readings(cell, weights, ring, draws, device,
                                 cast=rc.fp8_cast)
    else:
        prog, got = program_readings(cell, weights, ring, draws, device,
                                     fault)
        del prog
    free()
    want = reference_readings(cell, weights, ring, draws, device)
    return compare.train_numbers(got, want,
                                 getattr(cell.family, "FIRST_STAGE", None))


def _trace(prog, ring, draws, k: int, steps_per_s: float,
           window_peak: int) -> Dict:
    """The per-layer record of a traced run: a profiled slice of the
    window's steps, as many as the window ran in ``PROFILE_S`` seconds (at
    least three), the optimizer's and the EMA's CUDA-event ms, and where
    the program has assigners, their roofline share."""
    from benchmark.harness.trace import profile_slice
    from heltondetection_tpu_torch.train.trainer import update_ema

    n = max(3, math.ceil(PROFILE_S * steps_per_s))

    def steps():
        for i in range(k, k + n):
            prog.step(prog.batch(ring[i % len(ring)]), draws[i % len(ring)])

    st = prog.state

    def optim():
        st.optimizer.step()
        update_ema(st.ema, st.model, st.step)

    rec = {"kind": "train", "slice": profile_slice(steps),
           "steps_per_s": steps_per_s,
           "spans_ms": {"optim": cuda_ms(optim, 5, warmup=1)},
           "peak_bytes": window_peak}
    if hasattr(prog, "assigners"):
        rpn, box, least = prog.assigners(ring[0], draws[0])
        rec["assign_roofline_pct"] = 100.0 * least * 1e3 / cuda_ms(
            lambda: (rpn(), box()), 5)
    return rec


def run(cell, seed: int, seconds: float, trace: bool, device, clock) -> Dict:
    cfg, fam = cell.config, cell.family
    ring, draws = _inputs(cell, seed, device)
    clock.mark("frames")
    weights = fam.make_weights(cfg, seed, device, ring[0]["image"][:CALIB],
                               clock)
    prog, got = program_readings(cell, weights, ring, draws, device)
    k = cell.traffic["check_steps"]
    for _ in range(cell.traffic["warmup_steps"]):
        prog.step(prog.batch(ring[k % len(ring)]), draws[k % len(ring)])
        k += 1
    torch.cuda.synchronize()
    clock.mark("model and first steps")
    setup_s = clock.setup_s()
    setup_peak = torch.cuda.max_memory_allocated(device)

    torch.cuda.reset_peak_memory_stats(device)
    bsz = cfg["train"]["batch"]
    t0 = time.perf_counter()
    steps = 0
    while True:
        m = prog.step(prog.batch(ring[k % len(ring)]), draws[k % len(ring)])
        k += 1
        steps += 1
        if time.perf_counter() - t0 >= seconds:
            break
    torch.cuda.synchronize()
    window = time.perf_counter() - t0
    window_peak = torch.cuda.max_memory_allocated(device)
    finite = math.isfinite(float(m["total"]))
    out = {"attempted": steps, "failed": 0 if finite else 1,
           "e2e": {"train_img_per_s": steps * bsz / window,
                   "setup_s": setup_s},
           "memory_peak_bytes": max(setup_peak, window_peak)}
    if trace:
        out["record"] = _trace(prog, ring, draws, k, steps / window,
                               window_peak)
        out["record"]["flops_per_step"] = fam.train_flops(cfg)
    del prog, m
    free()
    want = reference_readings(cell, weights, ring, draws, device)
    out["check"] = compare.train_numbers(
        got, want, getattr(fam, "FIRST_STAGE", None))
    return out
