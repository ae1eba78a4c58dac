"""The port's tracer (heltondetection_tpu_torch/utils/trace.py) on the CPU:
the off path, nesting and the summary's arithmetic, the kernel counters,
the profiler's annotations on the tracer's clock, and the spans of
``Evaluator.collect`` and of one YOLOv5 train step.

The card-side half (device events read at ``take``) is held here with a
stand-in for ``torch.cuda.Event``: no span may synchronize; ``take`` waits
on each span's closing event.
"""

import time
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from heltondetection_tpu_torch import kernels
from heltondetection_tpu_torch.engine.evaluator import Evaluator
from heltondetection_tpu_torch.models.yolov5 import YOLOv5
from heltondetection_tpu_torch.train.schedule import make_optimizer
from heltondetection_tpu_torch.train.trainer import (create_train_state,
                                                     make_train_step)
from heltondetection_tpu_torch.train.yolo_loss import YoloLossConfig
from heltondetection_tpu_torch.utils import trace


@pytest.fixture(autouse=True)
def _off_after():
    """Each test starts and ends with the tracer off, on one thread."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    trace.disable()
    yield
    trace.disable()
    torch.set_num_threads(prev)


class _FakeEvent:
    """``torch.cuda.Event`` on a machine without a card: its record is a
    host time; it counts the waits on it."""

    waits = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter()

    def synchronize(self):
        _FakeEvent.waits += 1

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


def _fake_cuda(monkeypatch):
    def refuse(*a):
        raise AssertionError("a span synchronized the device")

    monkeypatch.setattr(trace, "_cuda_in_use", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(_FakeEvent, "waits", 0)


def test_off_records_allocates_and_enters_nothing(monkeypatch):
    """Off: one shared span object, no profiler range, no CUDA event, no
    allocation by the tracer's code, nothing for ``take``."""
    def refuse(*a, **k):
        raise AssertionError("entered while the tracer is off")

    monkeypatch.setattr(trace, "record_function", refuse)
    monkeypatch.setattr(trace, "_cuda_in_use", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    assert not trace.enabled()
    assert trace.span("a", device=True) is trace.span("b")

    def loop():
        for i in range(1000):
            with trace.span("outer", device=True):
                with trace.span("inner"):
                    pass

    loop()                      # the first calls may warm caches
    tracemalloc.start()
    try:
        loop()
        snap = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    mine = snap.filter_traces([tracemalloc.Filter(True, trace.__file__)])
    assert sum(s.size for s in mine.statistics("filename")) == 0
    assert trace.take() == {"spans": [], "summary": {}, "counters": {}}


def test_nesting_parents_ids_and_self_time():
    """Nesting, parents and self time; a span carries no id."""
    trace.enable()
    with trace.span("a"):
        with trace.span("b"):
            time.sleep(0.002)
        with trace.span("c"):
            with trace.span("d"):
                time.sleep(0.001)
        time.sleep(0.001)
    with trace.span("b"):
        pass
    got = trace.take()
    spans = got["spans"]
    assert [s["name"] for s in spans] == ["b", "d", "c", "a", "b"]
    b, d, c, a, b2 = spans
    assert a["parent"] is None and a["parent_seq"] is None
    assert (b["parent"], b["parent_seq"]) == ("a", a["seq"])
    assert (c["parent"], c["parent_seq"]) == ("a", a["seq"])
    assert (d["parent"], d["parent_seq"]) == ("c", c["seq"])
    assert b2["parent"] is None and b2["start_ns"] >= a["end_ns"]
    for s in spans:
        assert s["device_ms"] is None
        assert s["end_ns"] >= s["start_ns"]
    for child in (b, c):
        assert a["start_ns"] <= child["start_ns"] <= child["end_ns"] \
            <= a["end_ns"]
    assert b["end_ns"] <= c["start_ns"]

    def ms(s):
        return (s["end_ns"] - s["start_ns"]) * 1e-6

    summ = got["summary"]
    assert summ["b"]["count"] == 2 and summ["a"]["count"] == 1
    assert summ["b"]["host_ms"] == pytest.approx(ms(b) + ms(b2))
    assert summ["a"]["self_ms"] == pytest.approx(ms(a) - ms(b) - ms(c))
    assert summ["c"]["self_ms"] == pytest.approx(ms(c) - ms(d))
    assert summ["d"]["self_ms"] == pytest.approx(ms(d))
    assert summ["a"]["self_ms"] >= 0.9      # its own sleep of 1 ms
    assert summ["a"]["device_ms"] is None
    assert trace.take()["spans"] == []


def test_take_clears_and_reports_kernel_launches(monkeypatch):
    for k in kernels.KERNELS:
        monkeypatch.setitem(kernels.launch_counts, k, 5)
    trace.enable()
    kernels.launch_counts["nms_mask"] += 2
    kernels.launch_counts["iou_matrix"] += 1
    assert trace.take()["counters"] == {"kernel.nms_mask": 2,
                                        "kernel.iou_matrix": 1}
    assert trace.take()["counters"] == {}
    kernels.reset_launch_counts()
    kernels.launch_counts["nms_fixpoint"] += 3
    assert trace.take()["counters"] == {"kernel.nms_fixpoint": 3}


def test_cap_drops_and_counts(monkeypatch):
    monkeypatch.setattr(trace, "MAX_RECORDS", 3)
    trace.enable()
    for i in range(5):
        with trace.span(f"s{i}"):
            pass
    got = trace.take()
    assert [s["name"] for s in got["spans"]] == ["s0", "s1", "s2"]
    assert got["counters"] == {"trace.dropped": 2}


def test_device_events_read_at_take_without_a_sync_in_spans(monkeypatch):
    _fake_cuda(monkeypatch)
    trace.enable()
    for i in range(3):
        with trace.span("dev", device=True):
            with trace.span("host"):
                time.sleep(0.001)
    assert _FakeEvent.waits == 0
    got = trace.take()
    assert _FakeEvent.waits == 3        # each span's closing event
    dev = [s for s in got["spans"] if s["name"] == "dev"]
    assert all(s["device_ms"] >= 1.0 for s in dev)
    assert got["summary"]["dev"]["device_ms"] == pytest.approx(
        sum(s["device_ms"] for s in dev))
    assert got["summary"]["host"]["device_ms"] is None


def test_profiler_mode_annotations_on_the_tracers_clock():
    trace.enable(profiler=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("warm-up"):     # the profiler's first range
            pass
        with trace.span("outer"):
            time.sleep(0.003)
            with trace.span("inner"):
                time.sleep(0.003)
    got = trace.take()
    notes = {e.name(): e for e in prof.profiler.kineto_results.events()
             if e.is_user_annotation()}
    assert {s["name"] for s in got["spans"]} == {"warm-up", "outer", "inner"}
    for s in got["spans"][1:]:
        e = notes[s["name"]]
        assert abs(e.start_ns() - s["start_ns"]) < 2e6
        assert abs(e.end_ns() - s["end_ns"]) < 2e6


def _toy_step(images):
    """(B, K=4) dets: row i of image b valid where i < (b % 3) + 1."""
    b = images.shape[0]
    boxes = torch.tensor([10.0, 10.0, 30.0, 40.0]).expand(b, 4, 4)
    scores = torch.full((b, 4), 0.5)
    classes = torch.zeros(b, 4, dtype=torch.int32)
    valid = torch.arange(4)[None] <= (torch.arange(b)[:, None] % 3)
    return boxes, scores, classes, valid


class _Dets:
    def __init__(self):
        self.n = 0

    def add_det(self, img_id, boxes, scores, classes):
        self.n += len(scores)


def test_evaluator_collect_spans_and_counters():
    """One of each span a batch, in ``collect``'s order; no counters."""
    ev = Evaluator(None, 1, step_fn=_toy_step, device="cpu")

    def batch(ids):
        n = len(ids)
        return {"image": np.zeros((n, 8, 8, 3), np.uint8), "img_id": ids,
                "scale": [1.0] * n, "pad_x": [0.0] * n, "pad_y": [0.0] * n,
                "orig_hw": [(64, 64)] * n}

    batches = [batch([0, 1, 2]), batch([3, 4, 5]), batch([6, None, None])]
    dets = _Dets()
    trace.enable()
    assert ev.collect(batches, dets) == 7
    got = trace.take()
    by = {}
    for s in got["spans"]:
        by.setdefault(s["name"], []).append(s)
    assert [len(by[k]) for k in ("eval.dispatch", "eval.accumulate",
                                 "eval.wait")] == [3, 3, 3]
    # batch k's dets are accumulated after batch k + 1 is dispatched
    d, acc = by["eval.dispatch"], by["eval.accumulate"]
    for k in range(3):
        assert d[k]["end_ns"] <= acc[k]["start_ns"]
        if k < 2:
            assert d[k + 1]["end_ns"] <= acc[k]["start_ns"]
    for w, a in zip(by["eval.wait"], acc):
        assert (w["parent"], w["parent_seq"]) == ("eval.accumulate",
                                                  a["seq"])
    assert all(s["parent"] is None for s in d + acc)
    # rows valid 1, 2, 3 by image % 3: 6 + 6 + 1 (the padding left out)
    assert dets.n == 13
    assert got["counters"] == {}


def test_yolov5_train_step_spans_in_order():
    torch.manual_seed(0)
    model = YOLOv5(num_classes=2, depth_multiple=0.33, width_multiple=0.125)
    opt = make_optimizer(model, 1e-3, total_steps=10, warmup_steps=1)
    state = create_train_state(model, opt)
    step = make_train_step(YoloLossConfig(num_classes=2, img_size=64))
    b = 2
    batch = {"image": torch.randint(0, 256, (b, 64, 64, 3),
                                    dtype=torch.uint8),
             "gt_boxes": torch.tensor([[[32.0, 32.0, 20.0, 16.0]]] * b),
             "gt_cls": torch.zeros(b, 1, dtype=torch.int64),
             "gt_mask": torch.ones(b, 1, dtype=torch.bool)}
    step(state, batch)                  # step 0 untraced
    trace.enable()
    step(state, batch)
    got = trace.take()
    spans = got["spans"]
    [root] = [s for s in spans if s["name"] == "train.step"]
    kids = sorted((s for s in spans if s["parent_seq"] == root["seq"]),
                  key=lambda s: s["start_ns"])
    assert [s["name"] for s in kids] == [
        "train.forward", "train.backward", "train.allreduce",
        "train.optimizer", "train.ema"]
    fwd = kids[0]
    under = sorted((s for s in spans if s["parent_seq"] == fwd["seq"]),
                   key=lambda s: s["start_ns"])
    assert [s["name"] for s in under] == ["yolov5.forward", "train.loss"]
    assert spans[-1] is root
    assert got["counters"] == {}
    assert got["summary"]["train.step"]["self_ms"] < \
        got["summary"]["train.step"]["host_ms"]
