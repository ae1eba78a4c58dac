"""Serving layer: dynamic request batching onto the batched serve step;
counterpart of heltondetection_tpu/engine/serve.py.

Serving traffic arrives one frame at a time; the device wants batches.
:class:`BatchingDetector` bridges the two:

* client threads submit single frames (``submit`` → future, ``detect`` →
  blocking) and letterbox on THEIR thread, so host preprocessing scales
  with client concurrency;
* one dispatcher thread groups requests into batches of ``batch_size`` (or
  the smallest of ``batch_buckets`` that holds them, the tail padded by
  repetition), stacks them into pinned memory, and launches batch k+1
  before it reads batch k: uploads, the step and the dets' copies back
  are queued without a wait, and up to ``max_in_flight`` batches are
  outstanding before the dispatcher waits on the oldest one's event (the
  pipelining of the port's ``Evaluator``);
* results come back per request in source-image coordinates, the contract
  of ``Detector.detect_image``. Within one batch size a frame's result does
  not depend on who else is in the batch (model and postprocess are per
  image); across batch sizes cuDNN may pick other algorithms, which can
  differ in the last float bits.

``serve_http`` is a dependency-free (stdlib ``http.server``) front end:
POST an encoded image to ``/detect``, get JSON detections back;
``GET /healthz`` reports liveness and the batching stats.
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from heltondetection_tpu_torch.data.letterbox import letterbox_np
from heltondetection_tpu_torch.engine.evaluator import (dispatch_sharded,
                                                        fetch_dets)
from heltondetection_tpu_torch.device import resolve_device
from heltondetection_tpu_torch.engine.infer import Detector

_log = logging.getLogger("heltondetection_tpu_torch")


class BatchingDetector:
    """Dynamic batcher over a :class:`Detector`'s serve step.

    Args:
      detector: a non-TTA Detector (TTA multiplies dispatches per frame,
        the wrong trade for throughput serving: raise rather than silently
        serve at a third of the speed).
      batch_size: the largest device batch. Bigger amortizes launch
        overhead; use 8-16 when p99 latency matters more than img/s.
      max_wait_ms: how long the dispatcher waits to fill a batch before
        sending it partially full (the latency bound under light load).
      max_in_flight: device batches outstanding before the dispatcher
        blocks on the oldest fetch. 2 = classic double buffering.
      batch_buckets: opt-in adaptive batching: extra batch sizes to serve
        at. A partially filled collection dispatches the SMALLEST bucket
        that holds it, so light load (clients < batch) stops paying for
        padded slots. Default: ``batch_size`` only, which keeps results
        bit-stable across load. ``warmup()`` runs every bucket once.
      mesh: a ``parallel.mesh.Mesh`` (default: the detector's): each
        batch is split by rows over its devices, one server feeding every
        local card. The detector must have been built over that mesh
        (``load_detector(..., mesh=mesh)``), and ``batch_size`` and every
        bucket must divide by its device count: one that does not raises
        (the reference silently drops such buckets).
    """

    def __init__(self, detector: Detector, *, batch_size: int = 8,
                 max_wait_ms: float = 5.0, max_in_flight: int = 2,
                 mesh=None, batch_buckets: Optional[Sequence[int]] = None):
        if detector.tta:
            raise ValueError(
                "BatchingDetector serves the single-view path; construct "
                "the Detector with tta=False (TTA triples device work per "
                "frame: opt into it per request via Detector directly)")
        if batch_size < 1 or max_in_flight < 1:
            raise ValueError("batch_size and max_in_flight must be >= 1")
        if mesh is None:
            mesh = detector.mesh
        elif mesh != detector.mesh:
            raise ValueError("the detector was not built over this mesh: "
                             "build it with load_detector(..., mesh=mesh)")
        self.mesh = mesh
        self._det = detector
        self.batch_size = batch_size
        if batch_buckets is None:
            buckets = {batch_size}
        else:
            buckets = {int(b) for b in batch_buckets} | {batch_size}
            if any(b < 1 or b > batch_size for b in buckets):
                raise ValueError(
                    f"batch_buckets must lie in [1, batch_size]; got "
                    f"{sorted(buckets)}")
        bad = sorted(b for b in buckets if b % mesh.size)
        if bad:
            raise ValueError(
                f"batch_size and batch_buckets must divide by the mesh's "
                f"{mesh.size} devices; {bad} do not")
        self.batch_buckets = sorted(buckets)
        self.max_wait_s = max_wait_ms / 1e3
        self.max_in_flight = max_in_flight
        self._q: "queue.Queue" = queue.Queue()
        self._closed = False
        # orders every submit against close()'s poison put: without it a
        # submitter that passed the _closed check could be descheduled and
        # enqueue AFTER the poison, leaving its future unresolved forever
        self._submit_lock = threading.Lock()
        self._stats = {"requests": 0, "batches": 0, "padded_slots": 0,
                       "dispatched_slots": 0}
        self._stats_lock = threading.Lock()
        self._worker = threading.Thread(target=self._dispatch_loop,
                                        name="batching-detector",
                                        daemon=True)
        self._worker.start()

    # -- client API ---------------------------------------------------------

    def submit(self, img_rgb: np.ndarray) -> Future:
        """Enqueue one RGB frame; the future resolves to
        ``(boxes_xyxy, scores, classes)`` in source coordinates."""
        # letterbox on the CALLER's thread: host preprocessing then scales
        # with client concurrency instead of serializing in the dispatcher
        lb, _, meta = letterbox_np(img_rgb, np.zeros((0, 4), np.float32),
                                   self._det.img_size)
        fut: Future = Future()
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("BatchingDetector is closed")
            self._q.put((lb, meta, img_rgb.shape[:2], fut))
        with self._stats_lock:
            self._stats["requests"] += 1
        return fut

    def detect(self, img_rgb: np.ndarray, timeout: Optional[float] = None
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Blocking convenience wrapper over :meth:`submit`."""
        return self.submit(img_rgb).result(timeout)

    def stats(self) -> Dict[str, int]:
        with self._stats_lock:
            return dict(self._stats)

    def reset_stats(self) -> None:
        """Zero the batching counters (e.g. after warmup, so fill and
        padding percentages reflect only the measured window)."""
        with self._stats_lock:
            for k in self._stats:
                self._stats[k] = 0

    def warmup(self) -> None:
        """Run every batch bucket once on blank frames on the detector's
        device, so production traffic never pays a first-shape cost (cuDNN
        picks its algorithms per shape, the decode tables are built per
        input size). Raises if that device is CUDA and there is none."""
        resolve_device(self._det.device)
        s = self._det.img_size
        for b in self.batch_buckets:
            fetch_dets(self._dispatch(
                torch.zeros((b, s, s, 3), dtype=torch.uint8)))

    def close(self, timeout: float = 30.0) -> bool:
        """Drain pending requests and stop the dispatcher. Returns True if
        the drain completed within ``timeout``; on False the (daemon)
        dispatcher is still draining: callers keeping the process alive
        will still see their futures resolve, but exiting now abandons
        them."""
        with self._submit_lock:
            if not self._closed:
                self._closed = True
                self._q.put(None)   # wake + poison (ordered after all submits)
        self._worker.join(timeout)
        if self._worker.is_alive():
            _log.warning(
                "BatchingDetector.close: drain still running after %.0fs "
                "(pending requests only resolve while the process lives)",
                timeout)
            return False
        return True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- dispatcher ---------------------------------------------------------

    def _collect_batch(self):
        """Block for the first request, then fill up to batch_size for at
        most max_wait_s. Returns a list of request tuples, or None on
        shutdown (pending items drain first: the poison is queued last)."""
        first = self._q.get()
        if first is None:
            return None
        items = [first]
        deadline = time.monotonic() + self.max_wait_s
        while len(items) < self.batch_size:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                self._q.put(None)      # keep the poison for the outer loop
                break
            items.append(nxt)
        return items

    def _dispatch(self, x: torch.Tensor):
        """The detector's steps on ``x``, one part a device of the mesh
        (``dispatch_sharded``), not waited for."""
        return dispatch_sharded(self._det._steps, x, self.mesh)

    def _launch(self, items):
        """Stack one collection into the smallest bucket that holds it
        (pinned on CUDA) and enqueue upload, step and the dets' copies
        back. Returns (the dispatched dets, for ``fetch_dets``; bucket)."""
        dev = self._det.device
        real = len(items)
        bucket = next(b for b in self.batch_buckets if b >= real)
        s = self._det.img_size
        x = torch.empty((bucket, s, s, 3), dtype=torch.uint8,
                        pin_memory=dev.type == "cuda")
        xn = x.numpy()
        for i in range(bucket):                       # tail: repeat the last
            xn[i] = items[min(i, real - 1)][0]
        return self._dispatch(x), bucket

    def _resolve(self, out, items):
        # the step is asynchronous on CUDA: device-side failures surface
        # HERE at the wait, not at the launch. A raise must fail this
        # batch's futures, never kill the dispatcher thread (that would
        # wedge every later request).
        try:
            ob, os_, oc, ov = fetch_dets(out)
        except Exception as e:
            _log.exception("BatchingDetector: fetching a batch failed")
            for _, _, _, fut in items:
                if fut.set_running_or_notify_cancel():
                    fut.set_exception(e)
            return
        for i, (_, meta, hw, fut) in enumerate(items):
            if fut.set_running_or_notify_cancel():
                try:
                    fut.set_result(self._det._to_source(
                        ob[i], os_[i], oc[i], ov[i], meta, hw))
                except Exception as e:   # pragma: no cover
                    fut.set_exception(e)

    def _dispatch_loop(self):
        in_flight = []                 # [(dispatched dets, items)]
        while True:
            items = self._collect_batch()
            if items is None:
                break
            try:
                out, bucket = self._launch(items)
                in_flight.append((out, items))
                with self._stats_lock:
                    self._stats["batches"] += 1
                    self._stats["padded_slots"] += bucket - len(items)
                    self._stats["dispatched_slots"] += bucket
            except Exception as e:
                _log.exception("BatchingDetector: launching a batch failed")
                for _, _, _, fut in items:
                    if fut.set_running_or_notify_cancel():
                        fut.set_exception(e)
                # fall through to the drain loop: earlier batches already
                # in flight must still resolve even if no traffic follows
            # fetch the OLDEST batch only once max_in_flight are queued:
            # the device computes batch k while the host stacks batch k+1
            while len(in_flight) >= self.max_in_flight \
                    or (self._q.empty() and in_flight):
                self._resolve(*in_flight.pop(0))
        for entry in in_flight:        # drain on shutdown
            self._resolve(*entry)


def make_http_server(batcher: BatchingDetector, *, host: str = "0.0.0.0",
                     port: int = 8000,
                     class_names: Optional[Sequence[str]] = None,
                     request_timeout: float = 120.0):
    """Build (without starting) the stdlib HTTP server over a
    :class:`BatchingDetector`. ``port=0`` binds an ephemeral port
    (``server_address[1]`` reports it).

    POST /detect   body = encoded image (JPEG/PNG/…; decoded with OpenCV,
                   which is imported at the first such request)
                   → {"boxes": [[x1,y1,x2,y2]…], "scores": […],
                      "classes": […], "names": […]?}
    GET  /healthz  → {"ok": true, …batching stats}

    Thread-per-connection (``ThreadingHTTPServer``): N concurrent clients
    become N submitters into the batcher, which is exactly what keeps the
    device batch full.
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def _json(self, code: int, payload: Dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"ok": True, **batcher.stats()})
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/detect":
                self._json(404, {"error": "unknown path"})
                return
            import cv2
            n = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(n)
            img = cv2.imdecode(np.frombuffer(raw, np.uint8),
                               cv2.IMREAD_COLOR)
            if img is None:
                self._json(400, {"error": "could not decode image"})
                return
            # bounded wait + JSON error responses: a wedged or failed batch
            # must not pin this handler thread forever or drop the
            # connection without a body
            try:
                boxes, scores, classes = batcher.detect(
                    cv2.cvtColor(img, cv2.COLOR_BGR2RGB),
                    timeout=request_timeout)
            except TimeoutError:
                self._json(503, {"error": f"detection timed out after "
                                          f"{request_timeout:g}s"})
                return
            except Exception as e:
                self._json(500, {"error": f"{type(e).__name__}: {e}"})
                return
            out = {"boxes": boxes.round(2).tolist(),
                   "scores": scores.round(4).tolist(),
                   "classes": classes.tolist()}
            if class_names is not None:
                # a name list shorter than the model's class count must not
                # drop the connection bodyless (IndexError past the try)
                out["names"] = [class_names[c] if 0 <= c < len(class_names)
                                else str(int(c)) for c in classes]
            self._json(200, out)

        def log_message(self, *a):     # quiet; the package logger owns IO
            pass

    return ThreadingHTTPServer((host, port), Handler)


def serve_http(batcher: BatchingDetector, *, host: str = "0.0.0.0",
               port: int = 8000,
               class_names: Optional[Sequence[str]] = None):
    """Blocking front end: build the server and run it until interrupted."""
    srv = make_http_server(batcher, host=host, port=port,
                           class_names=class_names)
    _log.info("serving on http://%s:%d (batch %d)",
              *srv.server_address[:2], batcher.batch_size)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        # Ctrl-C is the documented way to stop `--mode serve`: shut down
        # cleanly instead of letting the interrupt traceback out of main
        _log.info("interrupt received, shutting down")
    finally:
        srv.server_close()
