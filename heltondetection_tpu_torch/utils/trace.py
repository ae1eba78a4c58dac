"""The port's spans and counters: one tracer for the process, off by
default.

    from heltondetection_tpu_torch.utils import trace
    trace.enable()                       # or enable(profiler=True)
    with trace.span("eval.dispatch"):
        ...
    got = trace.take()       # what was recorded since the last take
    trace.disable()

Off, :func:`span` returns one shared context manager that does nothing:
nothing is recorded or allocated, no CUDA event is made and no profiler
range is entered. No environment variable turns the tracer on;
``run_train`` does where ``HELTON_PROFILE_DIR`` is set.

On, each span records its name, its parent (the innermost span open on
the same thread when it began) and its start and end in ns on the clock
of ``torch.profiler``'s events (the Unix epoch: ``perf_counter_ns`` plus
an offset taken at :func:`enable`). A span with ``device=True`` where
CUDA is in use records a timing CUDA event at each of its edges on the
current stream; :func:`take` waits for them and reads them, and no span
synchronizes. With ``profiler=True`` each span also enters ``torch.profiler.record_function(name)``, so it shows in
a profiler's trace as a user annotation. At most ``MAX_RECORDS`` spans are
kept between two takes; the rest are counted as ``trace.dropped``.

The kernels' launches are counted in one place, ``kernels.launch_counts``;
:func:`take` reports those since the last take as ``kernel.<name>``.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, Optional

import torch
from torch.profiler import record_function

from heltondetection_tpu_torch.kernels import launch_counts

MAX_RECORDS = 100_000


class _Off:
    """The span of a tracer that is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _clock_offset_ns() -> int:
    """``time_ns() - perf_counter_ns()``, from the closest of a few reads."""
    best = None
    for _ in range(5):
        a = time.time_ns()
        p = time.perf_counter_ns()
        b = time.time_ns()
        if best is None or b - a < best[0]:
            best = (b - a, (a + b) // 2 - p)
    return best[1]


def _cuda_in_use() -> bool:
    return torch.cuda.is_initialized()


class _Tracer:
    def __init__(self, profiler: bool):
        self.profiler = profiler
        self.offset_ns = _clock_offset_ns()
        self.lock = threading.Lock()
        self.local = threading.local()
        self.seq = itertools.count()
        self.records: List[tuple] = []
        self.dropped = 0
        self.launches = dict(launch_counts)

    def stack(self) -> List["_Span"]:
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s

    def add(self, record: tuple) -> None:
        with self.lock:
            if len(self.records) < MAX_RECORDS:
                self.records.append(record)
            else:
                self.dropped += 1


class _Span:
    __slots__ = ("tracer", "name", "device", "seq", "parent", "t0",
                 "ranged", "ev0")

    def __init__(self, tracer: _Tracer, name: str, device: bool):
        self.tracer, self.name, self.device = tracer, name, device
        self.ranged = self.ev0 = None

    def __enter__(self):
        tr = self.tracer
        stack = tr.stack()
        self.parent = stack[-1] if stack else None
        self.seq = next(tr.seq)
        stack.append(self)
        # the host stamps enclose the profiler range, which encloses the
        # device events
        self.t0 = time.perf_counter_ns()
        if tr.profiler:
            self.ranged = record_function(self.name)
            self.ranged.__enter__()
        if self.device and _cuda_in_use():
            self.ev0 = torch.cuda.Event(enable_timing=True)
            self.ev0.record()
        return self

    def __exit__(self, *exc):
        ev1 = None
        if self.ev0 is not None:
            ev1 = torch.cuda.Event(enable_timing=True)
            ev1.record()
        if self.ranged is not None:
            self.ranged.__exit__(*exc)
        t1 = time.perf_counter_ns()
        tr = self.tracer
        tr.stack().pop()
        p = self.parent
        tr.add((self.name, self.seq,
                None if p is None else p.seq, None if p is None else p.name,
                self.t0 + tr.offset_ns, t1 + tr.offset_ns, self.ev0, ev1))
        return False


_tracer: Optional[_Tracer] = None


def enable(profiler: bool = False) -> None:
    """Turn the tracer on, with nothing recorded yet; ``profiler``: each
    span also enters a ``record_function`` range of its name."""
    global _tracer
    _tracer = _Tracer(profiler)


def disable() -> None:
    """Turn the tracer off; what :func:`take` has not returned is dropped."""
    global _tracer
    _tracer = None


def enabled() -> bool:
    return _tracer is not None


def span(name: str, device: bool = False):
    """A context manager timing the work inside it under ``name``;
    ``device``: also time it on the device where CUDA is in use."""
    tr = _tracer
    if tr is None:
        return _OFF
    return _Span(tr, name, device)


def take() -> Dict:
    """The spans and counters since the last take (or :func:`enable`), and
    clear them: ``spans`` (one dict a span, in the order they ended),
    ``summary`` ({name: count, host_ms, self_ms (the span less its
    children), device_ms (None without device events)}) and ``counters``
    (``kernel.<name>`` launches and ``trace.dropped``). Empty when the
    tracer is off."""
    tr = _tracer
    if tr is None:
        return {"spans": [], "summary": {}, "counters": {}}
    with tr.lock:
        recs, tr.records = tr.records, []
        dropped, tr.dropped = tr.dropped, 0
    counters: Dict[str, int] = {}
    now = dict(launch_counts)
    for k, v in now.items():
        # a reset of the counts since the last take: count from the reset
        d = v - tr.launches.get(k, 0)
        d = v if d < 0 else d
        if d:
            counters[f"kernel.{k}"] = d
    tr.launches = now
    if dropped:
        counters["trace.dropped"] = dropped
    spans, child_ns = [], {}
    for name, seq, pseq, pname, t0, t1, ev0, ev1 in recs:
        if ev1 is not None:
            ev1.synchronize()     # on its own device, whichever that is
        spans.append({"name": name, "seq": seq, "parent": pname,
                      "parent_seq": pseq, "start_ns": t0, "end_ns": t1,
                      "device_ms": (None if ev0 is None
                                    else ev0.elapsed_time(ev1))})
        if pseq is not None:
            child_ns[pseq] = child_ns.get(pseq, 0) + t1 - t0
    summary: Dict[str, Dict] = {}
    for s in spans:
        host = (s["end_ns"] - s["start_ns"]) * 1e-6
        row = summary.setdefault(s["name"], {"count": 0, "host_ms": 0.0,
                                             "self_ms": 0.0,
                                             "device_ms": None})
        row["count"] += 1
        row["host_ms"] += host
        row["self_ms"] += host - child_ns.get(s["seq"], 0) * 1e-6
        if s["device_ms"] is not None:
            row["device_ms"] = (row["device_ms"] or 0.0) + s["device_ms"]
    return {"spans": spans, "summary": summary, "counters": counters}
