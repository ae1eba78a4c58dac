"""``benchmark/harness/spans.py``: the reduction of a profiled slice by
program span (idle gaps put down to the innermost span open at their
middle, operations a step) on synthetic traces, and ``measure`` over a
toy loop of the port's spans on the CPU."""

import time

import pytest

from benchmark.harness import spans as sp


def test_idle_by_innermost_span():
    # window 0..100; device busy 10..20, 15..30 (merged), 60..70
    device = [(10, 20), (15, 30), (60, 70), (95, 120)]
    spans = [(0, 50, "step"), (5, 45, "forward"), (32, 40, "loss"),
             (50, 90, "backward")]
    red = sp.idle_by_span(0, 100, device, spans)
    assert red["window_ns"] == 100 and red["busy_ns"] == 20 + 10 + 5
    # gaps: 0-10 (mid 5: forward), 30-60 (mid 45: forward's end),
    # 70-95 (mid 82: backward)
    assert red["inner"] == {"forward": 10 + 30, "backward": 25}
    assert red["within"] == {"step": 40, "forward": 40, "backward": 25}
    red = sp.idle_by_span(0, 100, [(40, 60)], [(50, 55, "a")])
    # gaps 0-40 (mid 20) and 60-100 (mid 80): outside any span
    assert red["inner"] == {sp.OUTSIDE: 80} and red["within"] == {}


def _take(spans, counters=None):
    """The tracer's ``take`` of ``spans``; a child is a span naming the
    other as its parent and lying within it."""
    summary = {}
    for s in spans:
        row = summary.setdefault(s["name"], {"count": 0, "host_ms": 0.0,
                                             "self_ms": 0.0,
                                             "device_ms": None})
        row["count"] += 1
        host = s["end_ns"] - s["start_ns"]
        kids = sum(c["end_ns"] - c["start_ns"] for c in spans
                   if c["parent"] == s["name"]
                   and s["start_ns"] <= c["start_ns"] <= c["end_ns"]
                   <= s["end_ns"])
        row["host_ms"] += host * 1e-6
        row["self_ms"] += (host - kids) * 1e-6
        if s.get("device_ms") is not None:
            row["device_ms"] = (row["device_ms"] or 0.0) + s["device_ms"]
    return {"spans": spans, "summary": summary, "counters": counters or {}}


def _span(name, t0, t1, parent=None, device_ms=None):
    return {"name": name, "start_ns": t0, "end_ns": t1, "parent": parent,
            "device_ms": device_ms}


def test_train_numbers_operations_a_step():
    ms = 1_000_000
    a = _take([_span("train.forward", 0, 30 * ms, "train.step"),
               _span("train.backward", 30 * ms, 80 * ms, "train.step"),
               _span("train.optimizer", 80 * ms, 90 * ms, "train.step", 3.0),
               _span("train.ema", 90 * ms, 95 * ms, "train.step", 1.0),
               _span("train.step", 0, 96 * ms)])
    # slice (b): two steps in a 200-unit window, 7 device operations,
    # the third step still open at the window's end
    b_spans = [(0, 95, "train.step"), (5, 40, "train.forward"),
               (45, 85, "train.backward"), (100, 195, "train.step"),
               (105, 140, "train.forward"), (145, 185, "train.backward"),
               (198, 260, "train.step")]
    b_dev = [(10, 20), (25, 35), (50, 70), (88, 92), (110, 128),
             (150, 170), (186, 199)]
    out = sp.metrics(a, 100.0, _take([]), b_dev, b_spans, (0, 200))
    assert out["launches_per_step.train"] == 7 / 2
    assert out["optim_span_ms.train"] == pytest.approx(4.0)
    assert out["coverage"]["train.step"] == pytest.approx(0.96)
    assert out["coverage"]["children"] == pytest.approx(0.95)
    # gaps by middle: 0-10 (5) forward, 20-25 (22) forward, 35-50 (42)
    # the step alone, 70-88 (79) backward, 92-110 (101) the second step
    # alone, 128-150 (139) forward, 170-186 (178) backward, 199-200 (199)
    # the third step
    assert out["idle_forward.train"] == pytest.approx(100 * 37 / 200)
    assert out["idle_backward.train"] == pytest.approx(100 * 34 / 200)
    assert out["b"]["idle_inner_pct"] == pytest.approx(
        {"train.forward": 18.5, "train.backward": 17.0,
         "train.step": 17.0})
    assert out["b"]["idle_in_spans_pct"] == pytest.approx(100.0)


def test_eval_numbers():
    ms = 1_000_000
    spans = []
    for k in range(2):
        t = k * 10 * ms
        spans += [_span("yolov5.forward", t, t + 4 * ms, "eval.dispatch",
                        5.0),
                  _span("ops.postprocess", t + 4 * ms, t + 5 * ms,
                        "eval.dispatch", 1.5),
                  _span("eval.dispatch", t, t + 6 * ms),
                  _span("eval.wait", t + 6 * ms, t + 8 * ms,
                        "eval.accumulate"),
                  _span("eval.accumulate", t + 6 * ms, t + 9 * ms)]
    out = sp.metrics(_take(spans), 20.0, _take([]), [(0, 50)],
                     [(0, 60, "eval.dispatch"), (60, 90, "eval.accumulate"),
                      (60, 80, "eval.wait")], (0, 100))
    assert out["dispatch_ms.infer"] == pytest.approx(6.0)
    assert out["accumulate_ms.infer"] == pytest.approx(1.0)
    assert out["trunk_span_ms.infer"] == pytest.approx(5.0)
    assert out["post_span_ms.infer"] == pytest.approx(1.5)
    assert out["coverage"]["eval"] == pytest.approx(0.9)
    # gap 50-100, mid 75: eval.wait innermost, under eval.accumulate
    assert out["idle_accumulate.infer"] == pytest.approx(50.0)
    assert out["idle_dispatch.infer"] == 0.0
    assert out["b"]["idle_inner_pct"] == {"eval.wait": 50.0}


def test_measure_over_the_ports_spans_on_the_cpu():
    from heltondetection_tpu_torch.utils import trace

    def run(seconds):
        t0 = time.perf_counter()
        k = 0
        while True:
            with trace.span("train.step", k):
                with trace.span("train.forward"):
                    time.sleep(0.002)
                with trace.span("train.backward"):
                    time.sleep(0.003)
            k += 1
            if time.perf_counter() - t0 >= seconds:
                break

    out = sp.measure(run, 0.05)
    assert not trace.enabled()
    assert out["a"]["summary"]["train.step"]["count"] >= 5
    assert out["coverage"]["train.step"] > 0.9
    # no device: the whole slice is one idle gap, put down to one place
    assert out["b"]["idle_pct"] == 100.0
    assert sum(out["b"]["idle_inner_pct"].values()) == pytest.approx(100.0)
    assert len(out["b"]["idle_inner_pct"]) == 1


def _tiny_run(cell, seed, device):
    """The tiny cell's program, built and warmed up as its window driver
    does, and the loop its driver profiles as ``run(seconds)``."""
    from benchmark.drivers import eval as ev
    from benchmark.drivers import train as tr
    from benchmark.harness import frames
    cfg, mix, fam = cell.config, cell.traffic, cell.family
    if mix["driver"] == "eval":
        b = cfg["eval"]["batch"]
        ring = frames.eval_ring(mix, cfg, seed, b, device, pin=False)
        weights = fam.make_weights(cfg, seed, device,
                                   ring[0]["image"][:ev.CALIB])
        prog = fam.EvalProgram(cfg, weights, device)
        ev.run_window(prog, ring, b, n_batches=mix["warmup_batches"])
        return lambda s: ev.run_window(prog, ring, b, seconds=s)
    ring, draws = tr._inputs(cell, seed, device)
    weights = fam.make_weights(cfg, seed, device, ring[0]["image"][:ev.CALIB])
    prog = fam.TrainProgram(cfg, weights, device)
    k = [0]

    def steps(s):
        t0 = time.perf_counter()
        while True:
            i = k[0] % len(ring)
            prog.step(prog.batch(ring[i]), draws[i])
            k[0] += 1
            if time.perf_counter() - t0 >= s:
                break

    steps(0.0)
    return steps


@pytest.mark.parametrize("workload", ["yolov5s-coco640-eval-b32",
                                      "yolov5s-coco640-train-b64"])
def test_measure_each_cell_at_a_tiny_size(tiny, workload):
    """The cell's program cut to a CPU size and driven by its window loop:
    every span of the cell's path, and the numbers its metrics read."""
    import torch
    run = _tiny_run(tiny(workload), 5, torch.device("cpu"))
    out = sp.measure(run, 0.3)
    summ = out["a"]["summary"]
    if "eval" in workload:
        assert {"eval.dispatch", "eval.accumulate", "eval.wait",
                "yolov5.forward", "ops.postprocess"} <= set(summ)
        assert summ["eval.accumulate"]["count"] == \
            summ["eval.dispatch"]["count"]
        assert out["coverage"]["eval"] > 0.5
        assert out["dispatch_ms.infer"] > 0
        assert 0 < out["accumulate_ms.infer"] <= \
            summ["eval.accumulate"]["host_ms"] / summ["eval.accumulate"][
                "count"]
    else:
        assert {"train.step", "train.forward", "train.loss",
                "train.backward", "train.allreduce", "train.optimizer",
                "train.ema", "yolov5.forward"} <= set(summ)
        assert summ["train.forward"]["count"] == summ["train.step"]["count"]
        assert out["coverage"]["train.step"] > 0.5
        assert out["launches_per_step.train"] == 0   # no device here


def test_cli_measures_the_drivers_slice(monkeypatch, capsys):
    """``python3 -m benchmark.harness.spans``: run.py with ``--trace 1``,
    whose driver's profiled loop ``measure`` runs first; the profiler's
    hook is put back after."""
    import json

    from benchmark import run as bench
    from benchmark.harness import trace as bench_trace
    from heltondetection_tpu_torch.utils import trace
    seen = []

    def loop():
        with trace.span("train.step"):
            with trace.span("train.forward"):
                time.sleep(0.002)

    def profile_slice(fn):
        seen.append(fn)
        return "slice"

    def main(argv):
        seen.append(argv)
        from benchmark.harness.trace import profile_slice as ps
        assert ps(loop) == "slice"
        return 0

    monkeypatch.setattr(bench_trace, "profile_slice", profile_slice)
    monkeypatch.setattr(bench, "main", main)
    assert sp.main(["--workload", "w", "--seed", "1"]) == 0
    assert seen == [["--workload", "w", "--seed", "1", "--trace", "1"],
                    loop]
    assert bench_trace.profile_slice is profile_slice
    got = json.loads(capsys.readouterr().out.splitlines()[-1])["spans"]
    assert got["a"]["summary"]["train.step"]["count"] == 1
    assert got["coverage"]["children"] > 0.5
