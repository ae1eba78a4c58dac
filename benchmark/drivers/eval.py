"""The eval window: ``Evaluator.collect`` over a ring of letterboxed batches
for ``--seconds``, as ``run_eval`` drives it, with the harness's recorder in
place of ``DetEval``.

``infer_img_per_s`` is every frame whose dets reached the recorder over
the window; ``infer_p95_ms`` the 95th percentile over every batch of the
time from when the feed hands the batch to ``collect`` to when ``collect``
has accumulated its dets, which is when it asks for the batch after next
(``collect`` keeps one batch in flight). The program's dets of a sample of
the window's batches, drawn from the seed, are held to the reference's
once the window has closed and the program is freed, and where the family
has a dense head, so are the timed network's head logits of those
batches, read just before it is freed."""

from __future__ import annotations

import gc
import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness import frames
from benchmark.harness.timing import cuda_ms
from benchmark.reference import compare
from benchmark.reference.common import no_tf32

REF_BLOCK = 8                  # images a reference forward
CALIB = 8                      # frames that calibrate BatchNorm


class Feed:
    """The batches ``collect`` iterates: ring batches with fresh image ids
    (seq·B + row), until ``seconds`` have passed since the first was asked
    for, or ``n_batches`` were handed. Keeps the ask times, and a seeded
    reservoir of ``keep`` batch numbers whose dets the recorder keeps."""

    def __init__(self, ring: List[Dict], batch: int, *, seconds: float = None,
                 n_batches: int = None, keep: int = 0, seed: int = 0):
        self.ring, self.batch = ring, batch
        self.seconds, self.n_batches = seconds, n_batches
        self.keep = keep
        self.rng = np.random.default_rng([seed, 3])
        self.asks: List[float] = []
        self.kept: List[int] = []
        self.handed = 0

    def __iter__(self):
        return self

    def __next__(self):
        now = time.perf_counter()
        self.asks.append(now)
        if (self.seconds is not None and self.handed and
                now - self.asks[0] >= self.seconds) or \
                (self.n_batches is not None and
                 self.handed >= self.n_batches):
            raise StopIteration
        seq = self.handed
        self.handed += 1
        if len(self.kept) < self.keep:
            self.kept.append(seq)
        elif self.keep:
            j = int(self.rng.integers(0, seq + 1))
            if j < self.keep:
                self.kept[j] = seq
        r = self.ring[seq % len(self.ring)]
        b = self.batch
        return dict(r, img_id=list(range(seq * b, seq * b + b)))

    def latencies_ms(self, end: float) -> List[float]:
        """Per handed batch, ms from its hand-out to its accumulation."""
        done = self.asks[2:] + [end, end]
        return [(done[k] - self.asks[k]) * 1e3 for k in range(self.handed)]


class Recorder:
    """The harness's ``add_det``: counts frames and keeps the dets of the
    feed's kept batches."""

    def __init__(self, feed: Feed):
        self.feed = feed
        self.dets: Dict[int, Dict] = {}

    def add_det(self, img_id, boxes_xywh, scores, classes):
        seq = img_id // self.feed.batch
        if seq in self.feed.kept:
            self.dets[img_id] = {"boxes": np.array(boxes_xywh, np.float32),
                                 "scores": np.array(scores, np.float32),
                                 "classes": np.array(classes, np.int64)}

    def sample(self) -> Dict[int, List[Dict]]:
        """{kept batch: its images' dets} (an image without dets: empty)."""
        b = self.feed.batch
        empty = {"boxes": np.zeros((0, 4), np.float32),
                 "scores": np.zeros(0, np.float32),
                 "classes": np.zeros(0, np.int64)}
        return {s: [self.dets.get(s * b + r, empty) for r in range(b)]
                for s in sorted(self.feed.kept)}


def run_window(prog, ring, batch: int, *, seconds=None, n_batches=None,
               keep=0, seed=0, alter=None):
    """One pass of ``collect``; returns (feed, recorder, frames counted,
    window seconds). ``alter`` wraps the recorder (a fault)."""
    feed = Feed(ring, batch, seconds=seconds, n_batches=n_batches, keep=keep,
                seed=seed)
    rec = Recorder(feed)
    n = prog.evaluator.collect(feed, alter(rec) if alter else rec)
    end = time.perf_counter()
    return feed, rec, n, end - feed.asks[0]


def program_maps(cell, prog, ring, kept, device):
    """The timed network's head logits of the kept batches, {batch: per
    level}, where the family has a dense head (``program_maps``)."""
    fn = getattr(cell.family, "program_maps", None)
    if fn is None:
        return None
    return {s: fn(cell.config, prog, ring[s % len(ring)]["image"].to(device))
            for s in kept}


def check(cell, weights, ring, sample: Dict[int, List[Dict]], device,
          maps=None) -> Dict[str, float]:
    """The program's sampled dets against the reference's, and its head
    logits ``maps`` (from :func:`program_maps`) against the reference's;
    with ``maps``, also the dets against the reference's decode,
    selection and NMS of those same logits (``post_gap``): the network
    checked from the frames, the rest from the network's own output."""
    cfg, fam = cell.config, cell.family
    model = fam.reference_model(cfg, weights, device).eval()
    gaps = {"score": [], "box": [], "missed": [], "wanted": [],
            "score_images": [], "box_images": [], "box_missed": [],
            "missed10": [], "wanted10": [], "inner": []}
    offs, sizes, post = [], None, [0, 0]
    with torch.no_grad(), no_tf32():
        for seq, dets in sample.items():
            r = ring[seq % len(ring)]
            for lo in range(0, len(dets), REF_BLOCK):
                hi = min(lo + REF_BLOCK, len(dets))
                images = r["image"][lo:hi].to(device)
                ref_dets, cb, cs, ref_maps = fam.reference_dets(cfg, model,
                                                                images)
                metas = [{"scale": r["scale"][i], "pad_x": r["pad_x"][i],
                          "pad_y": r["pad_y"][i], "h": r["orig_hw"][i][0],
                          "w": r["orig_hw"][i][1]} for i in range(lo, hi)]
                g = compare.det_gaps(dets[lo:hi], ref_dets, cb, cs, metas)
                for k in gaps:
                    gaps[k] += g[k]
                if maps is not None:
                    got = [m[lo:hi] for m in maps[seq]]
                    o, sizes = compare.map_off_counts(got, ref_maps)
                    offs += o
                    u, t = compare.post_unmatched(
                        dets[lo:hi], fam.reference_post(cfg, got), metas)
                    post = [post[0] + u, post[1] + t]
    out = compare.det_numbers(gaps)
    if sizes is not None:
        out.update(compare.map_numbers(offs, sizes))
        out["post_gap"] = post[0] / max(post[1], 1)
    return out


def free() -> None:
    """Return what the program held to the device, once the caller has
    dropped its references."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def readings(cell, seed: int, device, *, control: bool = False,
             fault=None, alter=None) -> Dict[str, float]:
    """The compared numbers of one seed without a timed window: the
    program (or with ``control`` its int8 serving program) over the ring
    once, every batch compared; planted faults: ``fault(program)`` breaks
    the program's network first, ``alter`` wraps the recorder."""
    cfg, mix, fam = cell.config, cell.traffic, cell.family
    b = cfg["eval"]["batch"]
    ring = frames.eval_ring(mix, cfg, seed, b, device,
                            pin=device.type == "cuda")
    weights = fam.make_weights(cfg, seed, device, ring[0]["image"][:CALIB])
    calib = torch.cat([r["image"] for r in ring])[:32] if control else None
    prog = fam.EvalProgram(cfg, weights, device, quant_calib=calib)
    if fault is not None:
        fault(prog)
    n = min(mix["check_batches"], len(ring))
    _, rec, _, _ = run_window(prog, ring, b, n_batches=n, keep=n, seed=seed,
                              alter=alter)
    sample = rec.sample()
    maps = program_maps(cell, prog, ring, sample, device)
    del prog
    free()
    return check(cell, weights, ring, sample, device, maps)


def run(cell, seed: int, seconds: float, trace: bool, device, clock) -> Dict:
    cfg, mix, fam = cell.config, cell.traffic, cell.family
    b = cfg["eval"]["batch"]
    ring = frames.eval_ring(mix, cfg, seed, b, device, pin=True)
    clock.mark("frames")
    weights = fam.make_weights(cfg, seed, device, ring[0]["image"][:CALIB],
                               clock)
    prog = fam.EvalProgram(cfg, weights, device)
    clock.mark("model")
    run_window(prog, ring, b, n_batches=mix["warmup_batches"])
    x = ring[0]["image"].to(device)
    if trace:
        raw = prog.trunk(x)
        prog.post(raw)
    torch.cuda.synchronize()
    clock.mark("warm-up")
    setup_s = clock.setup_s()

    feed, rec, n_img, window = run_window(
        prog, ring, b, seconds=seconds, keep=mix["check_batches"], seed=seed)
    lat = feed.latencies_ms(feed.asks[0] + window)
    out = {"attempted": feed.handed * b, "failed": feed.handed * b - n_img,
           "e2e": {"infer_img_per_s": n_img / window,
                   "infer_p95_ms": statistics.quantiles(lat, n=20)[-1],
                   "setup_s": setup_s},
           "memory_peak_bytes": torch.cuda.max_memory_allocated(device)}
    if trace:
        from benchmark.harness.trace import profile_slice
        sl = profile_slice(lambda: run_window(
            prog, ring, b, seconds=min(1.0, seconds)))
        raw = prog.trunk(x)
        out["record"] = {
            "kind": "infer", "slice": sl,
            "flops_per_img": fam.infer_flops(cfg),
            "img_per_s": out["e2e"]["infer_img_per_s"],
            "spans_ms": {"trunk": cuda_ms(lambda: prog.trunk(x), 10),
                         "post": cuda_ms(lambda: prog.post(raw), 10)}}
        del raw
    sample = rec.sample()
    maps = program_maps(cell, prog, ring, sample, device)
    del prog
    free()
    out["check"] = check(cell, weights, ring, sample, device, maps)
    return out
