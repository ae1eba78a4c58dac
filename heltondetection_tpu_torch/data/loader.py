"""Batch loaders: threads decode and augment on the host, the device gets
fixed-shape uint8 batches through pinned memory; counterpart of
heltondetection_tpu/data/loader.py.

Deterministic: every sample is seeded by (seed, epoch, index), so threads
change only when a sample is computed, never what it is. Every wait has a
timeout (``WAIT_S``): a wedged worker raises instead of hanging the run.
Closing a batch iterator closes the ones it reads from explicitly, so its
worker threads stop before ``close()`` returns (an interpreter that keeps
a closed generator's frame alive would otherwise leave them running).
The reference's ``device_prep`` has no counterpart: the train step divides
by 255 itself.

A pipeline with ``sample_batch`` (``data/native_loader.py``) assembles each
whole batch in one call on the loader's own C++ pool (:class:`NativePool`,
made at first use and closed by ``close()``), on one producer thread that
keeps ``prefetch`` batches ready; any other pipeline's samples fan out over
``num_workers`` threads.
"""

from __future__ import annotations

import logging
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from contextlib import closing
from typing import Any, Dict, Iterator, List

import numpy as np
import torch

from heltondetection_tpu_torch.device import resolve_device

WAIT_S = 600.0   # the longest any wait of a loader may take


def _prefetched(it: Iterator, depth: int) -> Iterator:
    """Run ``it`` on a background thread, keeping ``depth`` items ready.

    Abandoning the consumer (break, GC, an exception) closes this
    generator, which tells the producer to stop and joins it. A producer
    that raises hands its exception to the consumer; one that yields
    nothing for ``WAIT_S`` seconds raises TimeoutError here."""
    q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
    end = object()
    stop = threading.Event()

    def producer():
        try:
            for item in it:
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
            q.put(end, timeout=WAIT_S)
        except BaseException as e:  # surfaced to the consumer
            try:
                q.put(e, timeout=WAIT_S)
            except queue.Full:
                pass
        finally:
            if hasattr(it, "close"):   # release its worker threads now
                it.close()

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            try:
                item = q.get(timeout=WAIT_S)
            except queue.Empty:
                raise TimeoutError(f"loader produced nothing for {WAIT_S} s")
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        while True:  # unblock a producer stuck on a full queue
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join(timeout=30.0)
        if t.is_alive():
            logging.getLogger("heltondetection_tpu_torch").error(
                "loader producer thread did not stop within 30 s")


def _stack(samples: List[Dict], keys) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k in keys:
        v0 = samples[0][k]
        if isinstance(v0, np.ndarray):
            out[k] = np.stack([s[k] for s in samples])
        else:
            out[k] = [s[k] for s in samples]
    return out


def _padded(samples: List[Dict], pad_to: int) -> List[Dict]:
    """``samples`` with its last sample repeated with ``img_id=None`` up to
    ``pad_to``."""
    while len(samples) < pad_to:
        pad = dict(samples[-1])
        pad["img_id"] = None
        samples.append(pad)
    return samples


def _sample_batches(sample, idx_batches, num_workers: int, prefetch: int,
                    pad_to: int = 0) -> Iterator[List[Dict]]:
    """The samples of each index batch, fanned out over ``num_workers``
    threads at sample granularity with ``prefetch`` batches in flight
    (serially when ``num_workers`` ≤ 1). ``pad_to`` pads a short batch
    (:func:`_padded`)."""
    if num_workers <= 1:
        for idxs in idx_batches:
            yield _padded([sample(i) for i in idxs], pad_to)
        return
    pool = ThreadPoolExecutor(num_workers)
    try:
        pending = []
        it = iter(idx_batches)
        for idxs in it:
            pending.append([pool.submit(sample, i) for i in idxs])
            if len(pending) >= prefetch:
                break
        while pending:
            futs = pending.pop(0)
            nxt = next(it, None)
            if nxt is not None:
                pending.append([pool.submit(sample, i) for i in nxt])
            yield _padded([f.result(timeout=WAIT_S) for f in futs], pad_to)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


class _LoaderBase:
    """The native pool of a ``sample_batch`` pipeline, ``close()`` and the
    context manager."""

    _pool = None

    def _native_pool(self):
        """The loader's C++ pool of ``num_workers`` threads, made at first
        use. One per loader: ``hd_pool_run`` is not reentrant, and an
        abandoned epoch's producer is joined before the next one starts."""
        if self._pool is None:
            from heltondetection_tpu_torch.data.native_loader import \
                NativePool
            self._pool = NativePool(self.num_workers)
        return self._pool

    def close(self) -> None:
        """Release the C++ pool and the pipeline's threads."""
        if self._pool is not None:
            self._pool.close()
            self._pool = None
        if hasattr(self.pipe, "close"):
            self.pipe.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class TrainLoader(_LoaderBase):
    """Shuffled fixed-size batches of augmented train samples, on
    ``device`` (CUDA unless ``device="cpu"``).

    Each epoch draws the reference's (seed, epoch) permutation and drops
    the last short batch. A background thread stacks each batch and pins
    it; ``epoch()`` starts its copy to the card without waiting for it
    (a ``non_blocking`` upload from pinned memory), so the copy overlaps
    the step still running there. Images stay uint8. ``keys`` names the
    sample keys a batch carries (``DEVICE_AUG_KEYS`` for
    ``DeviceAugPipeline`` and ``NativeDeviceAugPipeline``). A pipeline
    with ``sample_batch`` makes each batch in one call on the loader's
    C++ pool.

    ``batch_size`` is the global batch. ``shard=(pid, nproc)`` (the
    reference's, DistributedSampler's counterpart): every process draws the
    same (seed, epoch) permutation and takes the contiguous rows
    ``[pid·b/n, (pid+1)·b/n)`` of each global batch, so the union of the
    processes' slices is the one-process batch; ``batch_size`` must divide
    by ``nproc``. The native ``sample_batch`` path gets the same slice
    (every sample is seeded by its index, so it is the same rows)."""

    KEYS = ("image", "gt_boxes", "gt_cls", "gt_mask")
    # the keys of DeviceAugPipeline's samples
    DEVICE_AUG_KEYS = ("images4", "boxes4", "cls4", "mask4", "mosaic4")

    def __init__(self, pipeline, batch_size: int, *, seed: int = 0,
                 num_workers: int = 8, prefetch: int = 4, device=None,
                 keys=None, shard=(0, 1)):
        self.device = resolve_device(device)
        self.pipe = pipeline
        self.batch_size = batch_size        # the global batch
        self.seed = seed
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.keys = tuple(keys or self.KEYS)
        pid, nproc = shard
        if batch_size % nproc:
            raise ValueError(f"batch_size {batch_size} must divide by the "
                             f"process count {nproc}")
        if not 0 <= pid < nproc:
            raise ValueError(f"shard {shard}: process {pid} of {nproc}")
        self.shard = (pid, nproc)
        self._lo = pid * (batch_size // nproc)
        self._hi = self._lo + batch_size // nproc

    def steps_per_epoch(self) -> int:
        return len(self.pipe) // self.batch_size

    def host_batches(self, epoch: int) -> Iterator[Dict[str, Any]]:
        """The epoch's batches (this process's rows of each) as the
        reference yields them: dicts of numpy arrays."""
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, epoch]))
        order = rng.permutation(len(self.pipe))
        bs = self.batch_size
        idx_batches = [[int(i) for i in
                        order[b * bs:(b + 1) * bs][self._lo:self._hi]]
                       for b in range(self.steps_per_epoch())]
        if hasattr(self.pipe, "sample_batch"):
            pool = self._native_pool()
            for idxs in idx_batches:
                batch = self.pipe.sample_batch(idxs, epoch, pool)
                yield {k: batch[k] for k in self.keys}
            return
        with closing(_sample_batches(
                lambda i: self.pipe.sample(i, epoch), idx_batches,
                self.num_workers, self.prefetch)) as batches:
            for samples in batches:
                yield _stack(samples, self.keys)

    def epoch(self, epoch: int) -> Iterator[Dict[str, torch.Tensor]]:
        pin = self.device.type == "cuda"

        def staged():
            with closing(self.host_batches(epoch)) as batches:
                for batch in batches:
                    t = {k: torch.from_numpy(v) for k, v in batch.items()}
                    yield ({k: v.pin_memory() for k, v in t.items()} if pin
                           else t)

        with closing(_prefetched(staged(), self.prefetch)) as batches:
            for batch in batches:
                yield {k: v.to(self.device, non_blocking=pin)
                       for k, v in batch.items()}


class EvalLoader(_LoaderBase):
    """Fixed-shape eval batches of host numpy arrays (the ``Evaluator``
    uploads them); the last short batch is padded with ``img_id=None``
    rows, which the evaluator skips. A pipeline with ``sample_batch``
    makes each batch in one call on the loader's C++ pool, on a producer
    thread ``prefetch`` batches ahead."""

    KEYS = ("image", "img_id", "scale", "pad_x", "pad_y", "orig_hw")

    def __init__(self, pipeline, batch_size: int, *, num_workers: int = 8,
                 prefetch: int = 4):
        self.pipe = pipeline
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.prefetch = prefetch

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        n, bs = len(self.pipe), self.batch_size
        idx_batches = [list(range(b, min(b + bs, n))) for b in range(0, n, bs)]
        if hasattr(self.pipe, "sample_batch"):
            pool = self._native_pool()
            batches = _prefetched(
                (_padded(self.pipe.sample_batch(idxs, pool), bs)
                 for idxs in idx_batches), self.prefetch)
        else:
            batches = _sample_batches(self.pipe.sample, idx_batches,
                                      self.num_workers, self.prefetch,
                                      pad_to=bs)
        with closing(batches):
            for samples in batches:
                yield _stack(samples, self.KEYS)
