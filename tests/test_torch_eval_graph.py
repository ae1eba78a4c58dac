"""The evaluator's CUDA graphs (``engine/evaluator.py:GraphedStep``): a
replayed step gives the eager step's answers bit for bit, weights changed
in place included; a step that reads the host falls back to eager; the
kernels' launch counts and the tracer's spans and counters stay true.

The cases marked ``card`` need a CUDA card and skip without one; on the
card's machine (no JAX there, so without this directory's conftest):

    python -m pytest tests/test_torch_eval_graph.py -m card --noconftest -q

A tiny YOLOv5 (width 0.125, 64², B=4) keeps each case to seconds. The CPU
case holds the CPU path: an ``Evaluator`` there never captures.
"""

import numpy as np
import pytest
import torch

from heltondetection_tpu_torch.engine.evaluator import (Evaluator,
                                                        GraphedStep,
                                                        fetch_dets)
from heltondetection_tpu_torch.engine.runner import forward_for_eval
from heltondetection_tpu_torch.kernels import launch_counts
from heltondetection_tpu_torch.models.yolov5 import YOLOv5, packed_copy
from heltondetection_tpu_torch.ops.postprocess import make_fused_postprocess
from heltondetection_tpu_torch.utils import trace

NC, SIZE, B = 8, 64, 4
GRAPH_COUNTERS = ("eval.graph_capture", "eval.graph_replay",
                  "eval.graph_fallback")


@pytest.fixture(autouse=True)
def _tracer_off():
    trace.disable()
    yield
    trace.disable()


@pytest.fixture
def card():
    """The card, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: CUDA graphs run on the card")
    return torch.device("cuda", 0)


def _model(seed: int, dtype=torch.bfloat16) -> YOLOv5:
    torch.manual_seed(seed)
    return YOLOv5(NC, 0.33, 0.125, dtype=dtype).eval()


def _fused(seed: int, device, dtype=torch.bfloat16):
    """(the packed network on ``device``, the fused step over it)."""
    net = packed_copy(_model(seed, dtype)).to(
        device, memory_format=torch.channels_last)
    post = make_fused_postprocess(NC)
    return net, lambda images: post(net(images.float() / 255.0))


def _frames(n: int, seed: int = 1):
    g = torch.Generator().manual_seed(seed)
    return [torch.randint(0, 256, (B, SIZE, SIZE, 3), dtype=torch.uint8,
                          generator=g) for _ in range(n)]


def _batches(frames):
    for k, x in enumerate(frames):
        yield {"image": x, "img_id": list(range(k * B, k * B + B)),
               "scale": [1.0] * B, "pad_x": [0.0] * B, "pad_y": [0.0] * B,
               "orig_hw": [(SIZE, SIZE)] * B}


class _Sink:
    def __init__(self):
        self.dets = {}

    def add_det(self, img_id, boxes, scores, classes):
        self.dets[img_id] = (np.array(boxes), np.array(scores),
                             np.array(classes))


def _counts():
    return {k: trace.counts[k] for k in GRAPH_COUNTERS}


def _moved(before):
    return {k: trace.counts[k] - before[k] for k in GRAPH_COUNTERS}


def _np(t: torch.Tensor) -> np.ndarray:
    """On the host as numpy; bf16 widened to float32, which is exact."""
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def _eager(step, x, device):
    with torch.inference_mode():
        return [_np(t) for t in step(x.to(device))]


def _assert_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_cpu_evaluator_never_captures():
    """On the CPU every batch runs the step eagerly: no counter moves, no
    ``eval.graph`` span, and the dets are the step's own."""
    _, step = _fused(0, "cpu", torch.float32)
    ev = Evaluator(None, NC, step_fn=step, device="cpu")
    assert all(isinstance(s, GraphedStep) for s in ev._steps)
    frames = _frames(3)
    before = _counts()
    trace.enable()
    sink = _Sink()
    assert ev.collect(_batches(frames), sink) == 3 * B
    got = trace.take()
    assert _moved(before) == dict.fromkeys(GRAPH_COUNTERS, 0)
    assert not set(GRAPH_COUNTERS) & set(got["counters"])
    assert "eval.graph" not in got["summary"]
    for k, x in enumerate(frames):
        ob, os_, oc, ov = _eager(step, x, "cpu")
        for i in range(B):
            if not ov[i].any():
                assert k * B + i not in sink.dets
                continue
            x1, y1, x2, y2 = [np.clip(ob[i][ov[i]][:, j], 0, SIZE)
                              for j in range(4)]
            _assert_equal(sink.dets[k * B + i],
                          (np.stack([x1, y1, x2 - x1, y2 - y1], -1),
                           os_[i][ov[i]], oc[i][ov[i]]))


@pytest.mark.card
def test_replay_equals_eager_bit_for_bit(card):
    """Dets and head logits of four batches, eager then captured then
    replayed, with the weights changed in place before the last: each the
    eager step's, bit for bit."""
    net, _ = _fused(0, card)
    post = make_fused_postprocess(NC)

    def step(images):
        raw = net(images.float() / 255.0)
        dets = post(raw)
        return (*dets, *[p[0] for p in raw],
                *[c for p in raw for c in p[1]])

    graphed = GraphedStep(step)
    other = packed_copy(_model(1)).state_dict()
    before = _counts()
    for k, x in enumerate(_frames(4)):
        if k == 3:
            net.load_state_dict(other)       # copies in place
        xd = x.pin_memory().to(card, non_blocking=True)
        with torch.inference_mode():
            got = [_np(t) for t in graphed(xd)]
        _assert_equal(got, _eager(step, x, card))
    assert _moved(before) == {"eval.graph_capture": 1,
                              "eval.graph_replay": 3,
                              "eval.graph_fallback": 0}


@pytest.mark.card
@pytest.mark.parametrize("route", ["fused", "unfused"])
def test_evaluator_routes_give_the_eager_dets(card, route):
    """Both YOLOv5 routes through ``Evaluator``: whether the step captures
    or falls back, each batch's dets are the eager step's, also after
    ``load_state_dict`` between batches (as ``run_eval``'s reused nets);
    one of capture and fallback happens, once."""
    if route == "fused":
        net, step = _fused(0, card)
        ev = Evaluator(None, NC, step_fn=step, device=card)
        other = packed_copy(_model(1)).state_dict()
    else:
        net = _model(0)
        ev = Evaluator(forward_for_eval(net, NC, device=card), NC,
                       device=card)
        other = _model(1).state_dict()
    before = _counts()
    for k, x in enumerate(_frames(4)):
        if k == 3:
            net.load_state_dict(other)
        got = fetch_dets(ev._dispatch(x.pin_memory()))
        _assert_equal(got, _eager(ev._step, x, card))
    moved = _moved(before)
    assert moved["eval.graph_capture"] + moved["eval.graph_fallback"] == 1
    assert moved["eval.graph_replay"] == 3 * moved["eval.graph_capture"]


@pytest.mark.card
def test_step_that_reads_the_host_falls_back(card):
    """A step with an ``.item()`` cannot be captured: it runs eagerly from
    the second batch on, with the eager answers."""
    _, fused = _fused(0, card)
    reads = []

    def step(images):
        dets = fused(images)
        reads.append(dets[1].sum().item())
        return dets

    ev = Evaluator(None, NC, step_fn=step, device=card)
    before = _counts()
    for x in _frames(3):
        got = fetch_dets(ev._dispatch(x.pin_memory()))
        _assert_equal(got, _eager(fused, x, card))
    assert _moved(before) == {"eval.graph_capture": 0,
                              "eval.graph_replay": 0,
                              "eval.graph_fallback": 1}
    assert len(reads) == 3           # the capture's try stopped at its read


@pytest.mark.card
def test_replays_count_one_nms_fixpoint_launch_a_batch(card):
    _, step = _fused(0, card)
    ev = Evaluator(None, NC, step_fn=step, device=card)
    n0 = launch_counts["nms_fixpoint"]
    before = _counts()
    assert ev.collect(_batches(_frames(5)), _Sink()) == 5 * B
    assert launch_counts["nms_fixpoint"] - n0 == 5
    assert _moved(before)["eval.graph_replay"] == 4


@pytest.mark.card
def test_traced_capture_and_graph_span(card):
    """With the tracer on, the capture raises nothing, each graphed batch
    shows one device-timed ``eval.graph`` span, and ``take`` reports the
    counters."""
    _, step = _fused(0, card)
    ev = Evaluator(None, NC, step_fn=step, device=card)
    trace.enable()
    assert ev.collect(_batches(_frames(3)), _Sink()) == 3 * B
    got = trace.take()
    spans = [s for s in got["spans"] if s["name"] == "eval.graph"]
    assert len(spans) == 2
    assert all(s["device_ms"] is not None and s["device_ms"] > 0
               for s in spans)
    assert all(s["parent"] == "eval.dispatch" for s in spans)
    c = got["counters"]
    assert c["eval.graph_capture"] == 1 and c["eval.graph_replay"] == 2
    assert "eval.graph_fallback" not in c
    assert c["kernel.nms_fixpoint"] == 3
    # the eager batch's forward has device events; the capture's none
    fwd = [s for s in got["spans"] if s["name"] == "yolov5.forward"]
    assert [s["device_ms"] is not None for s in fwd] == [True, False]
