"""The port's serving layer (engine/serve.py) on the CPU, as
tests/test_serve.py tests the reference's: dynamic batching must be
COMPOSITION-TRANSPARENT (whatever batch a request lands in, its dets equal
a same-batch-size dispatch of that frame alone, exactly: model and
postprocess are per image), the batching mechanics (grouping, buckets,
padding stats, drain on close), failure isolation, and the stdlib HTTP
front end. One test holds the port's batcher against the reference's on
the same weights and frames (the det multiset, at the bounds of
tests/test_torch_port_serve.py).

Every wait here has a timeout, and server threads are daemons shut down in
a ``finally``.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (imported before the JAX package, as its tests do)

from heltondetection_tpu.engine.infer import Detector as JDetector
from heltondetection_tpu.engine.serve import \
    BatchingDetector as JBatchingDetector

from heltondetection_tpu_torch.engine.infer import Detector
from heltondetection_tpu_torch.engine.serve import (BatchingDetector,
                                                    make_http_server)
from heltondetection_tpu_torch.kernels import launch_counts
from heltondetection_tpu_torch.parallel.mesh import Mesh

from test_torch_port_model import jax_variables, port_model
from test_torch_port_serve import (NC, SIZE, _assert_same_dets, _noise,
                                   make_steps)

WAIT = 60.0          # seconds: every future, join and close is bounded


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def weights():
    jmodel, variables = jax_variables(nc=NC, seed=3, head_scale=0.25)
    return jmodel, variables, port_model(variables, NC)


@pytest.fixture(scope="module")
def steps(weights):
    return make_steps(weights, max_det=30, multi_label=False)


@pytest.fixture(scope="module")
def detector(steps):
    return Detector(steps[1], NC, SIZE, device="cpu")


def _frames(n, seed=0, hw=(96, SIZE)):
    return [_noise(hw + (3,), seed * 100 + k) for k in range(n)]


def _equal(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_batching_matches_single_image(detector):
    """Concurrent submitters, an odd total (padded tail), a small batch:
    every request's result is bit-identical to a batch-4 dispatch of that
    frame with copies of itself."""
    frames = _frames(13, seed=3)
    want = [detector.detect_batch([f] * 4)[0] for f in frames]
    before = dict(launch_counts)
    with BatchingDetector(detector, batch_size=4, max_wait_ms=30.0) as bd:
        futs = [None] * len(frames)

        def client(lo, hi):
            for i in range(lo, hi):
                futs[i] = bd.submit(frames[i])

        threads = [threading.Thread(target=client, args=(i, min(i + 5, 13)),
                                    daemon=True) for i in range(0, 13, 5)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT)
            assert not t.is_alive()
        got = [f.result(timeout=WAIT) for f in futs]
        stats = bd.stats()
    assert launch_counts == before            # CPU tensors: no kernel
    assert stats["requests"] == 13 and stats["batches"] >= 4
    assert stats["dispatched_slots"] - stats["padded_slots"] == 13
    assert len(got[0][1]) > 0
    for w, g in zip(want, got):
        _equal(w, g)


def test_matches_jax_batching_detector(steps, detector):
    """The same frames through the reference's BatchingDetector and the
    port's: the same det multiset per request."""
    frames = _frames(5, seed=4)        # largest side = SIZE: padding only
    jdet = JDetector(None, NC, SIZE, detect_fn=steps[0])
    with JBatchingDetector(jdet, batch_size=4, max_wait_ms=20.0) as jbd:
        want = [f.result(timeout=WAIT)
                for f in [jbd.submit(f) for f in frames]]
    with BatchingDetector(detector, batch_size=4, max_wait_ms=20.0) as bd:
        got = [f.result(timeout=WAIT) for f in [bd.submit(f) for f in frames]]
    for g, w in zip(got, want):
        _assert_same_dets(g, w)


def test_partial_batch_padding_and_latency_bound(detector):
    """A lone request must not wait for a full batch: the max_wait_ms
    deadline dispatches a padded partial batch."""
    with BatchingDetector(detector, batch_size=8, max_wait_ms=10.0,
                          batch_buckets=(8,)) as bd:
        b, s, c = bd.detect(_frames(1, seed=5)[0], timeout=WAIT)
        stats = bd.stats()
    assert stats == {"requests": 1, "batches": 1, "padded_slots": 7,
                     "dispatched_slots": 8}
    assert b.shape[1] == 4 and len(b) == len(s) == len(c)


def test_adaptive_batch_buckets_and_warmup(detector):
    """Under light load the dispatcher sends the SMALLEST bucket that holds
    the collection; the result equals a dispatch of that frame at that
    bucket size. ``warmup`` runs every bucket and counts no request."""
    calls = []

    def counting(x):
        calls.append(int(x.shape[0]))
        return detector._detect(x)

    det = Detector(counting, NC, SIZE, device="cpu")
    with BatchingDetector(det, batch_size=8, max_wait_ms=10.0,
                          batch_buckets=(2,)) as bd:
        assert bd.batch_buckets == [2, 8]
        bd.warmup()
        assert calls == [2, 8] and bd.stats()["requests"] == 0
        frame = _frames(1, seed=5)[0]
        got = bd.detect(frame, timeout=WAIT)
        stats = bd.stats()
    assert calls == [2, 8, 2]
    assert stats["batches"] == 1 and stats["padded_slots"] == 1
    assert stats["dispatched_slots"] == 2
    _equal(detector.detect_batch([frame] * 2)[0], got)
    with pytest.raises(ValueError, match="batch_buckets"):
        BatchingDetector(detector, batch_size=8, batch_buckets=(16,))
    with pytest.raises(ValueError, match=">= 1"):
        BatchingDetector(detector, batch_size=0)
    with BatchingDetector(detector, batch_size=8,
                          batch_buckets=(1, 4)) as bd2:
        assert bd2.batch_buckets == [1, 4, 8]


def test_close_drains_and_rejects_and_reset_stats(detector):
    bd = BatchingDetector(detector, batch_size=4, max_wait_ms=5.0)
    futs = [bd.submit(f) for f in _frames(3, seed=7)]
    assert bd.close(timeout=WAIT) is True
    for f in futs:           # pending work resolves on close
        boxes, scores, classes = f.result(timeout=WAIT)
        assert boxes.shape[1] == 4
    with pytest.raises(RuntimeError, match="closed"):
        bd.submit(_frames(1)[0])
    assert bd.close(timeout=WAIT) is True          # idempotent
    assert bd.stats()["requests"] == 3
    bd.reset_stats()
    assert bd.stats() == {"requests": 0, "batches": 0, "padded_slots": 0,
                          "dispatched_slots": 0}


def test_rejects_tta_detector(detector):
    tta = Detector(detector._detect, NC, SIZE, tta=True, device="cpu")
    with pytest.raises(ValueError, match="tta=False"):
        BatchingDetector(tta)


class _FakeDet:
    """Minimal Detector stand-in with exactly the surface BatchingDetector
    touches (.tta, .img_size, .device, .mesh, ._steps, ._to_source), a
    gate to hold the dispatcher mid-batch, and scripted failures."""
    tta = False
    img_size = 64
    device = torch.device("cpu")
    mesh = Mesh((device,))

    @property
    def _steps(self):
        return [self._detect]

    def __init__(self):
        self.calls = 0
        self.fail_on = set()       # 1-based _detect call numbers that raise
        self.poison_on = set()     # call numbers whose dets fail at the fetch
        self.gate = threading.Event()
        self.gate.set()

    def _detect(self, x):
        assert self.gate.wait(WAIT)
        self.calls += 1
        if self.calls in self.fail_on:
            raise RuntimeError("dispatch boom")
        n = int(x.shape[0])
        if self.calls in self.poison_on:
            return (_FetchPoison(),) * 4
        return (torch.zeros((n, 5, 4)), torch.zeros((n, 5)),
                torch.zeros((n, 5), dtype=torch.int32),
                torch.ones((n, 5), dtype=torch.bool))

    def _to_source(self, b, s, c, v, meta, hw):
        return b[v], s[v], c[v]


class _FetchPoison:
    """Dets that fail when the host reads them: an asynchronous device
    failure surfacing at the fetch."""

    def numpy(self):
        raise RuntimeError("device fell over at fetch")


def test_dispatch_failure_still_drains_in_flight():
    """A failed launch must fail ONLY its own futures; batches already in
    flight must resolve even with no further traffic."""
    det = _FakeDet()
    det.gate.clear()               # hold the dispatcher before _detect
    frame = _frames(1, seed=13, hw=(48, 64))[0]
    bd = BatchingDetector(det, batch_size=1, max_wait_ms=1.0,
                          max_in_flight=2)
    try:
        fa = bd.submit(frame)      # call 1: launch ok, stays in flight
        fb = bd.submit(frame)      # call 2: launch raises
        det.fail_on = {2}
        det.gate.set()
        with pytest.raises(RuntimeError, match="dispatch boom"):
            fb.result(timeout=WAIT)
        b, s, c = fa.result(timeout=WAIT)   # in-flight batch still resolves
        assert b.shape == (5, 4)
        fc = bd.submit(frame)      # dispatcher alive for later requests
        assert fc.result(timeout=WAIT)[0].shape == (5, 4)
    finally:
        det.gate.set()
        assert bd.close(timeout=WAIT) is True


def test_fetch_failure_fails_batch_not_dispatcher():
    """A failure at the fetch must set the exception on that batch's
    futures and leave the dispatcher serving."""
    det = _FakeDet()
    det.poison_on = {1}
    frame = _frames(1, seed=17, hw=(48, 64))[0]
    bd = BatchingDetector(det, batch_size=1, max_wait_ms=1.0)
    try:
        with pytest.raises(RuntimeError, match="fell over at fetch"):
            bd.detect(frame, timeout=WAIT)
        b, s, c = bd.detect(frame, timeout=WAIT)   # dispatcher survived
        assert b.shape == (5, 4)
    finally:
        assert bd.close(timeout=WAIT) is True


def _serve(bd, **kw):
    srv = make_http_server(bd, host="127.0.0.1", port=0, **kw)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    return srv, th, f"http://127.0.0.1:{srv.server_address[1]}"


def _stop(srv, th):
    srv.shutdown()
    srv.server_close()
    th.join(timeout=10)
    assert not th.is_alive()


def test_http_server_detect_healthz_400_404(detector):
    cv2 = pytest.importorskip("cv2")
    frame = _frames(1, seed=9)[0]
    want_b, want_s, want_c = detector.detect_batch([frame] * 2)[0]
    assert len(want_b)
    names = ["a", "b"]             # shorter than the class count on purpose
    bd = BatchingDetector(detector, batch_size=2, max_wait_ms=5.0)
    srv, th, url = _serve(bd, class_names=names)
    try:
        ok, buf = cv2.imencode(".png", cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
        assert ok
        req = urllib.request.Request(url + "/detect", data=buf.tobytes(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=WAIT) as r:
            out = json.loads(r.read())
        np.testing.assert_allclose(out["boxes"], want_b, atol=0.01)
        np.testing.assert_allclose(out["scores"], want_s, atol=1e-4)
        assert out["classes"] == want_c.tolist()
        assert out["names"] == [names[c] if c < 2 else str(c) for c in want_c]

        with urllib.request.urlopen(url + "/healthz", timeout=WAIT) as r:
            hz = json.loads(r.read())
        assert hz["ok"] is True and hz["requests"] == 1
        assert hz["dispatched_slots"] - hz["padded_slots"] == 1

        for path, data, code in (("/detect", b"not-an-image", 400),
                                 ("/nowhere", b"x", 404),
                                 ("/nowhere", None, 404)):
            bad = urllib.request.Request(url + path, data=data)
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(bad, timeout=WAIT)
            assert ei.value.code == code
            assert "error" in json.loads(ei.value.read())
    finally:
        _stop(srv, th)
        assert bd.close(timeout=WAIT) is True


def test_http_batcher_error_returns_500():
    """Batcher exceptions come back as a JSON 500, not a dropped connection
    or a pinned handler thread; the server stays up."""
    cv2 = pytest.importorskip("cv2")
    det = _FakeDet()
    det.fail_on = {1}
    bd = BatchingDetector(det, batch_size=1, max_wait_ms=1.0)
    srv, th, url = _serve(bd, request_timeout=WAIT)
    try:
        ok, buf = cv2.imencode(".png", _frames(1, seed=19, hw=(48, 64))[0])
        assert ok
        req = urllib.request.Request(url + "/detect", data=buf.tobytes(),
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=WAIT)
        assert ei.value.code == 500
        assert "dispatch boom" in json.loads(ei.value.read())["error"]
        with urllib.request.urlopen(req, timeout=WAIT) as r:   # still up
            assert len(json.loads(r.read())["boxes"]) == 5
    finally:
        _stop(srv, th)
        assert bd.close(timeout=WAIT) is True
