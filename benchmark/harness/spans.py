"""The program's own spans over a cell's window (``utils/trace.py`` of the
port), reduced to per-layer numbers.

``measure(run, seconds)`` takes ``run(s)``, which drives the cell's window
loop for about ``s`` seconds, and runs it twice:

(a) with the tracer on and no profiler: each span's host ms, self ms and
    device ms a batch or step, the counters, and how much of the wall time
    the spans cover;
(b) with the tracer on in profiler mode, under ``torch.profiler``: the
    device's idle gaps (the complement of the union of kernel, copy and
    fill intervals, as ``trace.py`` finds them), each put down to the
    innermost program span open at its middle, and the device operations
    a ``train.step``. Slice (b) carries the profiler's own host cost, as
    ``device_idle.*`` does.

It returns {} where the program has no tracer. From the root of a
checkout,

    python3 -m benchmark.harness.spans --workload <cell> --seed <n>
        --seconds <s>

runs ``benchmark/run.py`` with ``--trace 1`` and hands ``measure`` the
loop its driver profiles (``trace.profile_slice``'s ``fn``), just before
the driver's own profiled slice: it prints run.py's lines, then
``{"spans": measure's result}`` as one JSON line.
"""

from __future__ import annotations

import bisect
import sys
import time
from typing import Callable, Dict, List, Tuple

import torch

from benchmark.harness import trace as bench_trace

OUTSIDE = "outside any span"
WINDOW = "bench.spans.window"
LOOK_BACK = 256         # spans that started before a gap's middle, scanned

Interval = Tuple[int, int]


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def idle_by_span(w0: int, w1: int, device: List[Interval],
                 spans: List[Tuple[int, int, str]]) -> Dict:
    """Reduce one slice ``[w0, w1)`` (ns): the device's ``busy`` ns (the
    union of its ``device`` intervals), its idle gaps, and each gap's ns
    put down to the innermost of ``spans`` (start, end, name) open at the
    gap's middle (``inner``, ``OUTSIDE`` where none is) and to every span
    name open there (``within``: a span's or its descendants' idle)."""
    busy = bench_trace._union([(max(s, w0), min(e, w1)) for s, e in device
                               if min(e, w1) > max(s, w0)])
    gaps, prev = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    spans = sorted(spans)
    starts = [s[0] for s in spans]
    inner: Dict[str, int] = {}
    within: Dict[str, int] = {}
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        i = bisect.bisect_right(starts, mid)
        open_ = [s for s in spans[max(0, i - LOOK_BACK):i] if s[1] >= mid]
        name = min(open_, key=lambda s: s[1] - s[0])[2] if open_ else OUTSIDE
        inner[name] = inner.get(name, 0) + g1 - g0
        for n in {s[2] for s in open_}:
            within[n] = within.get(n, 0) + g1 - g0
    return {"window_ns": w1 - w0, "busy_ns": sum(e - s for s, e in busy),
            "inner": inner, "within": within}


def _profiled(run: Callable[[float], object], seconds: float, trace):
    """Run ``run(seconds)`` under the profiler with the tracer on in
    profiler mode; returns (window, device intervals, program spans,
    the tracer's take)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    _sync()
    trace.enable(profiler=True)
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            run(seconds)
            _sync()
    got = trace.take()
    names = set(got["summary"])
    cpu = torch.autograd.DeviceType.CPU
    events = prof.profiler.kineto_results.events()
    win = next(e for e in events if e.name() == WINDOW
               and e.device_type() == cpu)
    device, spans = [], []
    for e in events:
        if e.device_type() != cpu:
            if not e.is_user_annotation():
                device.append((e.start_ns(), e.end_ns()))
        elif e.is_user_annotation() and e.name() in names:
            spans.append((e.start_ns(), e.end_ns(), e.name()))
    return (win.start_ns(), win.end_ns()), device, spans, got


def _per(summary: Dict, name: str, key: str, n: int):
    row = summary.get(name)
    if row is None or row[key] is None or not n:
        return None
    return row[key] / n


def metrics(a: Dict, a_wall_ms: float, b: Dict, b_device: List[Interval],
            b_spans: List[Tuple[int, int, str]], window: Interval) -> Dict:
    """The per-layer numbers from slice (a) (the tracer's take and its
    wall ms) and slice (b) (the profiled take, device intervals, span
    annotations and window)."""
    summ = a["summary"]
    out: Dict = {}
    red = idle_by_span(window[0], window[1], b_device, b_spans)
    pct = {k: 100.0 * v / red["window_ns"] for k, v in red["within"].items()}
    idle_ns = red["window_ns"] - red["busy_ns"]
    top: Dict[str, int] = {}
    for s in a["spans"]:
        if s["parent"] is None:
            ns = s["end_ns"] - s["start_ns"]
            top[s["name"]] = top.get(s["name"], 0) + ns
    if "eval.dispatch" in summ:
        n = summ["eval.dispatch"]["count"]
        out["dispatch_ms.infer"] = _per(summ, "eval.dispatch", "host_ms", n)
        if "eval.accumulate" in summ:      # less its child, the wait
            out["accumulate_ms.infer"] = _per(
                summ, "eval.accumulate", "self_ms",
                summ["eval.accumulate"]["count"])
        out["trunk_span_ms.infer"] = _per(summ, "yolov5.forward",
                                          "device_ms", n)
        out["post_span_ms.infer"] = _per(summ, "ops.postprocess",
                                         "device_ms", n)
        out["idle_dispatch.infer"] = pct.get("eval.dispatch", 0.0)
        out["idle_accumulate.infer"] = pct.get("eval.accumulate", 0.0)
        cover = top.get("eval.dispatch", 0) + top.get("eval.accumulate", 0)
        out["coverage"] = {"eval": cover * 1e-6 / a_wall_ms}
    if "train.step" in summ:
        n = summ["train.step"]["count"]
        steps_b = sum(1 for s in b_spans if s[2] == "train.step"
                      and window[0] <= s[1] <= window[1])
        ops = sum(1 for s, e in b_device if window[0] <= s < window[1])
        out["launches_per_step.train"] = ops / steps_b if steps_b else None
        dev = [summ[k]["device_ms"] for k in ("train.optimizer", "train.ema")
               if k in summ and summ[k]["device_ms"] is not None]
        out["optim_span_ms.train"] = sum(dev) / n if dev else None
        out["idle_forward.train"] = pct.get("train.forward", 0.0)
        out["idle_backward.train"] = pct.get("train.backward", 0.0)
        kids = sum(s["end_ns"] - s["start_ns"] for s in a["spans"]
                   if s["parent"] == "train.step")
        out["coverage"] = {"train.step": top.get("train.step", 0) * 1e-6 /
                           a_wall_ms, "children": kids * 1e-6 / a_wall_ms}
    out["a"] = {"wall_ms": a_wall_ms, "summary": summ,
                "counters": a["counters"]}
    out["b"] = {"window_s": red["window_ns"] * 1e-9,
                "busy_s": red["busy_ns"] * 1e-9,
                "idle_pct": 100.0 * idle_ns / red["window_ns"],
                "idle_in_spans_pct": (100.0 * (1 - red["inner"].get(
                    OUTSIDE, 0) / idle_ns) if idle_ns else None),
                "idle_inner_pct": {k: 100.0 * v / red["window_ns"]
                                   for k, v in red["inner"].items()},
                "idle_within_pct": pct, "counters": b["counters"]}
    return out


def measure(run: Callable[[float], object], seconds: float = 1.0) -> Dict:
    """Slices (a) and (b) of ``run`` (the module docstring); {} where the
    program has no tracer."""
    try:
        from heltondetection_tpu_torch.utils import trace
    except ImportError:
        return {}
    try:
        _sync()
        trace.enable()
        t0 = time.perf_counter_ns()
        run(seconds)
        _sync()
        wall_ms = (time.perf_counter_ns() - t0) * 1e-6
        a = trace.take()
        window, device, spans, b = _profiled(run, seconds, trace)
    finally:
        trace.disable()
    return metrics(a, wall_ms, b, device, spans, window)


def main(argv=None) -> int:
    """``benchmark/run.py`` with ``--trace 1`` (the module docstring)."""
    import json

    from benchmark import run as bench
    got: Dict = {}
    profile_slice = bench_trace.profile_slice

    def measured(fn):
        got.update(measure(lambda s: fn()))
        return profile_slice(fn)

    bench_trace.profile_slice = measured
    try:
        rc = bench.main(list(sys.argv[1:] if argv is None else argv) +
                        ["--trace", "1"])
    finally:
        bench_trace.profile_slice = profile_slice
    if rc == 0:
        print(json.dumps({"spans": got}), flush=True)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
