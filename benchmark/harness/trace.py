"""A profiled slice of a run, reduced to what the per-layer readers and the
result's ``device`` and ``breakdown`` need: the slice's length, the time a
device operation ran (the union of kernel, copy and fill intervals), the
operations that took most time, and the idle gaps by the host operation
running at their middle."""

from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import Callable, List, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

WINDOW = "bench.window"


@dataclass
class Slice:
    window_s: float
    busy_s: float
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]

    @property
    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s / self.window_s)


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def profile_slice(fn: Callable[[], None]) -> Slice:
    """Run ``fn`` (which ends on the device's work) under torch.profiler
    and reduce its trace."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            fn()
            torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    win = next(e for e in events if e.name() == WINDOW
               and e.device_type() == torch.autograd.DeviceType.CPU)
    w0, w1 = win.start_ns(), win.end_ns()
    dev, host = [], []
    for e in events:
        if e.is_user_annotation():
            continue
        s, t = max(e.start_ns(), w0), min(e.end_ns(), w1)
        if t <= s:
            continue
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            dev.append((s, t, e.name()))
        elif e.name() != WINDOW:
            host.append((e.start_ns(), e.end_ns(), e.name()))
    busy = _union([(s, t) for s, t, _ in dev])
    by_op = {}
    for s, t, name in dev:
        by_op[name] = by_op.get(name, 0.0) + (t - s) * 1e-9
    gaps, prev = [], w0
    for s, t in busy + [[w1, w1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    by_host = {}
    host.sort()
    starts = [h[0] for h in host]
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        i = bisect.bisect_right(starts, mid)
        # the innermost host operation that spans the middle: operations
        # nest, so it is among those that started last before it
        inner = [h for h in host[max(0, i - 256):i] if h[1] >= mid]
        label = min(inner, key=lambda h: h[1] - h[0])[2] if inner \
            else "host: outside any operation"
        by_host[label] = by_host.get(label, 0.0) + (g1 - g0) * 1e-9
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:10]
    return Slice((w1 - w0) * 1e-9, sum(t - s for s, t in busy) * 1e-9,
                 [list(kv) for kv in top], [list(kv) for kv in idle])
