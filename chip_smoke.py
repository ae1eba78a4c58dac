#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (heltondetection_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line) when it
fails:

1. the card's name and power limit, from nvidia-smi;
2. build every CUDA kernel of csrc/ (nms_fixpoint, nms_mask, iou_matrix),
   all nvcc processes at once;
3. hold each kernel against its plain PyTorch version on the card:
   - the NMS keep masks exactly (a bitmask: no tolerance): nms_fixpoint and
     nms_mask on random boxes at B=8 N=1024, on class-offset boxes with
     zeroed padding rows, on a 1024-deep suppression chain, on identical
     boxes (one kept per image) and on boxes that do not overlap (all
     kept); nms_fixpoint also at B=1, at B=64 (its clusters run in waves)
     and at the largest N its shared memory allows (2400 on an H100; one
     more word must raise), with its build alone holding as many bits as
     the plain suppression matrix; nms_mask also at N=2048, and the two
     kernels against each other on one input;
   - iou_matrix within 1 ulp (bit equality is expected), both of its
     stores: the float4 store (M a multiple of 4) at (1024, 8192), at a
     ragged (1000, 25200) whose zero-area rows must give exact zeros, at
     N = 1 and at the tall narrow (65536, 128); the float store at
     M % 4 = 1, 2 and 3 ((1000, 25201), (63, 130), (257, 1023)) and M = 1;
     N not a multiple of the 16-row tile in most of them;
4. the main path, a full-width YOLOv5s (80 classes, 640², bf16, random
   weights from seed 0), driven through four paths, each with the launch
   counts reset just before and read just after:
   a. serve: six frames of mixed sizes in two requests through
      make_packed_serve_step + Detector; nms_fixpoint must launch. The dets
      must be finite, inside their frames, and equal to the dets of the
      plain NMS on the same candidates; the f32 network must match its CPU
      run on a small input (TF32 off);
   b. eval: 64 seeded frames of mixed sizes, letterboxed to 640², with
      seeded ground truth, in batches of 32 through the port's Evaluator,
      on the unfused route (forward_for_eval + make_postprocess; nms_mask
      must launch) and on the packed route (step_fn=make_packed_serve_step;
      nms_fixpoint must launch). On the unfused route's candidates, the
      dets and COCO stats through the kernel must equal those of
      batched_nms on CPU copies. Gt boxes painted into raw head maps
      through the decode inverse must score AP > 0.99 through nms_mask,
      with and without a letterbox inverse. Random weights score AP near 0
      on the noise frames; the point there is the path, not the score;
   c. iou: the public op ops.boxes.iou_matrix at (1024, 25200); iou_matrix
      must launch (the kernel has no caller in the reference package but
      its tests, so its op is its path);
   d. serving: the seed-0 weights are written with save_eval_variables
      beside a config file in a temporary directory. load_detector(config
      file, ckpt=dir) must give the dets of a Detector built by hand from
      the same weights and settings on phase 4a's frames.
      load_detector(..., tta=True) on 8 frames of mixed sizes must launch
      nms_fixpoint three times (one per view), its dets finite and inside
      their frames, and the fusion on the card must equal
      weighted_boxes_fusion on CPU copies of the views' dets (boxes within
      1e-3 px, scores within 1e-6, classes and valid exactly).
      BatchingDetector(batch_size=16, batch_buckets=(4, 16)) after
      warmup(): 8 client threads send 16 frames each through submit, every
      future must resolve within a timeout to exactly what
      Detector.detect_batch gives that frame at one of the two bucket
      sizes; the stats must add up, nms_fixpoint must launch once per
      batch, close() must return True. The HTTP front end answers
      /healthz (no image decoder is promised on the card's machine);
5. times on the card: each kernel through its wrapper by CUDA events over
   back-to-back calls (host launch cost included), its device time by
   kernel name from torch.profiler, and its plain version, beside the
   kernel's bound: nms_fixpoint at B=1, 8, 32 and 64 N=1024, with its build
   timed alone (a build-only instance), so scan = whole - build; nms_mask
   at B=32 N=1024 and B=8 N=2048, its build and scan kernels read apart by
   name; iou_matrix at (1024, 25200) and (65536, 128). Then the serve step at B=32 with its
   breakdown, the unfused eval step's breakdown (CUDA events around each
   part, and the profiler's device-busy time, idle share and top kernels
   of each step), and eval images/s (host accumulate included) on both
   routes at B=32; TTA per batch of 8 and of 32 with WBF's share (CUDA
   events and the host clock), and the BatchingDetector's img/s, mean
   fill and request latency at 8 clients. No single PyTorch call
   computes greedy NMS or a pairwise IoU matrix (there is no torchvision),
   so library_ms is null for every kernel.

The lines before the last are the serve, eval and serving lines, the
kernels line, {"kernels": [...]}, and the card's nvidia-smi line; the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and non-tensor f32 FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
NMS_OPS_PER_PAIR = 14   # min, max x4, sub x2, mul, add x2, sub, mul, cmp
IOU_OPS_PER_PAIR = 13   # min, max x4, sub x2, mul, add, sub, add, div
NO_LIBRARY = ("no single PyTorch call computes it (greedy NMS and the "
              "pairwise IoU matrix are torchvision ops, and there is no "
              "torchvision)")


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    if not out:
        raise RuntimeError("nvidia-smi reported no GPU")
    return out[0]


def sorted_boxes(rng, b, n, size=640.0):
    """(b, n, 4) random xyxy boxes, each image's rows in score order."""
    xy = rng.uniform(0, size * 0.8, (b, n, 2))
    wh = rng.uniform(4, size * 0.3, (b, n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def class_offset_boxes(rng, b, n, n_pad, num_classes=80):
    """Class-offset boxes as the NMS entries build them, with the last
    n_pad rows zeroed (inert padding)."""
    boxes = sorted_boxes(rng, b, n)
    cls = rng.integers(0, num_classes, (b, n, 1)).astype(np.float32)
    boxes = boxes + cls * np.float32(8192.0)
    boxes[:, n - n_pad:] = 0.0
    return boxes


def chain_boxes(n):
    """n-deep alternating chain: box i suppresses only box i+1 at 0.65."""
    i = np.arange(n, dtype=np.float32)
    return np.stack([i * 2.0, np.zeros(n), i * 2.0 + 10.0,
                     np.full(n, 10.0)], -1).astype(np.float32)[None]


def identical_boxes(b, n):
    """Every row the same box: only row 0 of each image is kept."""
    return np.tile(np.array([10.0, 20.0, 110.0, 90.0], np.float32),
                   (b, n, 1))


def disjoint_boxes(b, n):
    """Boxes on a grid, none touching another: every row is kept."""
    i = np.arange(n, dtype=np.float32)
    x, y = (i % 64) * 20.0, (i // 64) * 20.0
    one = np.stack([x, y, x + 10.0, y + 10.0], -1).astype(np.float32)
    return np.broadcast_to(one, (b, n, 4)).copy()


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean ms of fn() over iters runs, by CUDA events after warmup."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profiled_ms(fn, iters: int, names) -> dict:
    """Device ms per call of fn() of each kernel whose name holds one of
    names, from torch.profiler's key_averages() over iters calls after one
    warm-up call; None where the trace shows no such kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(names)
    for evt in prof.key_averages():
        for name in names:
            if name in evt.key and evt.device_time_total > 0:
                out[name] = (out[name] or 0.0) + \
                    evt.device_time_total / iters / 1e3
    return out


def device_kernels(fn, iters: int) -> list:
    """[(name, device ms per call), ...] of every kernel, copy and fill
    that fn() runs on the card, most time first, from torch.profiler over
    iters calls after one warm-up call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = [(evt.key, evt.device_time_total / iters / 1e3)
            for evt in prof.key_averages()
            if str(evt.device_type).endswith("CUDA")]
    return sorted(rows, key=lambda r: -r[1])


def device_busy_ms(fn) -> float:
    """Device ms of everything one call of fn() runs on the card, from a
    CUDA-only torch.profiler trace (no host events: cheap enough for a call
    of tens of thousands of launches)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(evt.device_time_total for evt in prof.key_averages()) / 1e3


def nms_bound_ms(b: int, n: int) -> tuple:
    """Least time for the keep mask of (b, n, 4) boxes: bytes (boxes read,
    mask written) over HBM rate, pairwise tests over the f32 rate."""
    t_bytes = (b * n * 16 + b * n) / HBM_BYTES_PER_S
    t_ops = b * n * (n - 1) / 2 * NMS_OPS_PER_PAIR / F32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes > t_ops else "operations")


def iou_bound_ms(n: int, m: int) -> tuple:
    """Least time for the (n, m) IoU matrix: both box sets read and the f32
    matrix written over HBM rate, the pairwise ops over the f32 rate."""
    t_bytes = (4 * n * m + 16 * (n + m)) / HBM_BYTES_PER_S
    t_ops = n * m * IOU_OPS_PER_PAIR / F32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes > t_ops else "operations")


def max_ulp(a, b) -> int:
    """Largest distance in float32 ulps between two non-negative tensors
    (+0.0 folds -0.0 onto +0.0)."""
    import torch
    ia = (a.float() + 0.0).view(torch.int32).long()
    ib = (b.float() + 0.0).view(torch.int32).long()
    return int((ia - ib).abs().max())


def _logit(p: float) -> float:
    return float(np.log(p / (1 - p)))


def paint_raw_maps(gts_cxcywh, classes, img_size, nc):
    """Raw YOLOv5 head maps (numpy, one image) that decode to the given gt
    boxes: each box goes to the level and anchor nearest its shape,
    through the inverse of the v6.1 decode."""
    from heltondetection_tpu_torch.ops.anchors import (YOLOV5_ANCHORS,
                                                       YOLOV5_STRIDES)
    raws = [np.full((1, img_size // s, img_size // s, 3 * (5 + nc)), -12.0,
                    np.float32) for s in YOLOV5_STRIDES]
    for (cx, cy, w, h), c in zip(gts_cxcywh, classes):
        best = None
        for lvl, anchors in enumerate(YOLOV5_ANCHORS):
            for ai, (aw, ah) in enumerate(anchors):
                if w < 4 * aw and h < 4 * ah:
                    err = abs(np.log(w / aw)) + abs(np.log(h / ah))
                    if best is None or err < best[0]:
                        best = (err, lvl, ai, aw, ah)
        _, lvl, ai, aw, ah = best
        stride = YOLOV5_STRIDES[lvl]
        gx, gy = int(cx / stride), int(cy / stride)
        sig = [(cx / stride - gx + 0.5) / 2.0, (cy / stride - gy + 0.5) / 2.0,
               np.sqrt(w / aw) / 2.0, np.sqrt(h / ah) / 2.0]
        if not all(0 < s_ < 1 for s_ in sig):
            raise ValueError(f"gt {(cx, cy, w, h)} cannot be painted")
        base = ai * (5 + nc)
        raws[lvl][0, gy, gx, base:base + 5] = [_logit(s_) for s_ in sig] + [9.0]
        raws[lvl][0, gy, gx, base + 5 + int(c)] = 9.0
    return raws


def eval_batches(rng, n_frames, batch, img_size, letterbox_np):
    """Seeded frames of mixed sizes (uint8 noise), letterboxed to
    img_size², in batches for the Evaluator, and their seeded gt as
    (img_id, boxes xywh, classes) in source coordinates."""
    sizes = [(480, 640), (720, 1280), (640, 640), (375, 500), (1080, 1920),
             (640, 427), (512, 512), (300, 400)]
    batches, gts = [], []
    for start in range(0, n_frames, batch):
        imgs, ids, scales, pxs, pys, hws = [], [], [], [], [], []
        for k in range(start, min(start + batch, n_frames)):
            h, w = sizes[k % len(sizes)]
            frame = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
            n_gt = int(rng.integers(2, 9))
            wh = rng.uniform(0.03, 0.5, (n_gt, 2)) * [w, h]
            xy = rng.uniform(0, 1, (n_gt, 2)) * ([w, h] - wh)
            gts.append((k, np.concatenate([xy, wh], 1),
                        rng.integers(0, 80, n_gt)))
            lb, _, meta = letterbox_np(frame, np.zeros((0, 4), np.float32),
                                       img_size)
            imgs.append(lb)
            ids.append(k)
            scales.append(meta["scale"])
            pxs.append(meta["pad_x"])
            pys.append(meta["pad_y"])
            hws.append((h, w))
        batches.append({"image": np.stack(imgs), "img_id": ids,
                        "scale": scales, "pad_x": pxs, "pad_y": pys,
                        "orig_hw": hws})
    return batches, gts


SMOKE_CONFIG = """\
from heltondetection_tpu_torch.configs.base import (ExperimentConfig,
                                                    ModelConfig, TestConfig)

config = ExperimentConfig(
    name="chip_smoke",
    model=ModelConfig(family="yolov5", variant="s", num_classes=80,
                      img_size=640, dtype="bfloat16"),
    test=TestConfig(conf_thres=0.001, iou_thres=0.65))
"""


def check_dets(frame, dets, num_classes=80) -> int:
    """Dets of one frame are finite, inside it and in range; returns their
    count."""
    boxes, scores, classes = dets
    h, w = frame.shape[:2]
    if not (np.isfinite(boxes).all() and np.isfinite(scores).all()):
        raise AssertionError("non-finite dets")
    if ((boxes[:, [0, 2]] < 0).any() or (boxes[:, [0, 2]] > w).any()
            or (boxes[:, [1, 3]] < 0).any() or (boxes[:, [1, 3]] > h).any()):
        raise AssertionError("dets outside their frame")
    if ((scores <= 0) | (scores > 1)).any() or \
            ((classes < 0) | (classes >= num_classes)).any():
        raise AssertionError("scores or classes out of range")
    return len(scores)


def same_dets(a, b) -> bool:
    return all(x.shape == y.shape and np.array_equal(x, y)
               for x, y in zip(a, b))


def client_load(batcher, frames, n_clients, per_client, timeout=120.0):
    """n_clients threads, each sending per_client frames one after the
    other through submit and waiting for each answer. Returns
    ([(frame index, dets)], [latency s], wall s); a request that does not
    resolve within the timeout fails the run."""
    import threading
    results, latencies, errors = [], [], []
    lock = threading.Lock()

    def client(k):
        try:
            for j in range(per_client):
                idx = (k * per_client + j) % len(frames)
                t0 = time.perf_counter()
                dets = batcher.submit(frames[idx]).result(timeout=timeout)
                dt = time.perf_counter() - t0
                with lock:
                    results.append((idx, dets))
                    latencies.append(dt)
        except Exception as e:              # raised again by the caller
            with lock:
                errors.append(e)

    threads = [threading.Thread(target=client, args=(k,), daemon=True)
               for k in range(n_clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout * per_client)
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads) or \
            len(results) != n_clients * per_client:
        raise AssertionError(f"only {len(results)} of "
                             f"{n_clients * per_client} requests resolved")
    return results, latencies, wall


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        import heltondetection_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}",
              file=sys.stderr)
        return 2
    from heltondetection_tpu_torch.data.letterbox import letterbox_np
    from heltondetection_tpu_torch.engine.evaluator import (
        Evaluator, make_packed_serve_step, multilabel_candidates)
    from heltondetection_tpu_torch.engine.infer import Detector
    from heltondetection_tpu_torch.engine.runner import (forward_for_eval,
                                                         load_detector)
    from heltondetection_tpu_torch.engine.serve import (BatchingDetector,
                                                        make_http_server)
    from heltondetection_tpu_torch.kernels import (KERNELS, build,
                                                   launch_counts,
                                                   reset_launch_counts)
    from heltondetection_tpu_torch.kernels import iou as iou_kernel
    from heltondetection_tpu_torch.kernels import nms as nms_kernel
    from heltondetection_tpu_torch.models.yolov5 import (build_yolov5,
                                                         decode_full,
                                                         packed_copy)
    from heltondetection_tpu_torch.ops.boxes import (box_iou_matrix,
                                                     iou_matrix)
    from heltondetection_tpu_torch.ops.nms import (batched_nms,
                                                   nms_mask_fixpoint,
                                                   nms_mask_seq,
                                                   suppression_matrix)
    from heltondetection_tpu_torch.ops.postprocess import (
        _MAX_WH, fused_select_decode_packed, nms_sorted_candidates)
    from heltondetection_tpu_torch.ops.wbf import weighted_boxes_fusion
    from heltondetection_tpu_torch.utils.ckpt import save_eval_variables
    from heltondetection_tpu_torch.utils.cocoeval import DetEval

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # 1. device
    smi = nvidia_smi_line()
    log(f"device: {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")

    # 2. build
    t0 = time.perf_counter()
    built = build.build_all(KERNELS)
    log(f"build: {len(built)} kernel(s) in "
        f"{time.perf_counter() - t0:.2f} s wall")
    for name, (lib, secs, report) in built.items():
        log(f"  {name}: {lib.name} {secs:.2f} s")
        for line in report.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                log(f"    {line.strip()}")

    # 3a. nms_fixpoint vs plain, exact
    rng = np.random.default_rng(0)
    thr = 0.65
    cases = {
        "random B=8 N=1024": sorted_boxes(rng, 8, 1024),
        "class-offset, 300 padding rows, B=8 N=1024":
            class_offset_boxes(rng, 8, 1024, 300),
        "1024-deep chain": chain_boxes(1024),
    }
    # rows kept per image where the answer is known without the plain scan
    known_kept = {"identical boxes B=2 N=1024": 1,
                  "no overlap B=2 N=1024": 1024}
    fix_rng = np.random.default_rng(3)
    n_max = nms_kernel.nms_fixpoint_max_n(dev)
    clusters = nms_kernel.nms_fixpoint_clusters(dev, 1024)
    log(f"nms_fixpoint: N up to {n_max}; {clusters} images' clusters of "
        f"four blocks run at once at N=1024 (a larger batch runs in waves)")
    fix_cases = dict(cases)
    fix_cases.update({
        "random B=1 N=1024": sorted_boxes(fix_rng, 1, 1024),
        "class-offset, 200 padding rows, B=64 N=1024 (cluster waves)":
            class_offset_boxes(fix_rng, 64, 1024, 200),
        "identical boxes B=2 N=1024": identical_boxes(2, 1024),
        "no overlap B=2 N=1024": disjoint_boxes(2, 1024),
        f"random B=4 N={n_max} (the largest N)":
            sorted_boxes(fix_rng, 4, n_max),
    })
    mismatches = 0
    max_abs_err = 0.0
    for label, boxes in fix_cases.items():
        t = torch.from_numpy(boxes).to(dev)
        got = nms_kernel.nms_fixpoint(t, thr)
        bits = nms_kernel.nms_fixpoint_build(t, thr)
        torch.cuda.synchronize()
        want = nms_mask_fixpoint(t, thr)
        want_bits = suppression_matrix(t, thr).sum((-1, -2))
        diff = int((got != want).sum())
        mismatches += diff
        max_abs_err = max(max_abs_err,
                          float((got.float() - want.float()).abs().max()))
        bits_equal = torch.equal(bits.long(), want_bits.long())
        log(f"nms_fixpoint vs plain [{label}]: {diff} of {got.numel()} "
            f"differ, {int(got.sum())} kept; build alone sets "
            f"{int(bits.sum())} bits, plain S {int(want_bits.sum())}")
        if not bits_equal:
            raise AssertionError(f"nms_fixpoint's build sets other bits "
                                 f"than the plain S [{label}]")
        if label == "1024-deep chain":
            seq = nms_mask_seq(t[0], thr)
            if not torch.equal(seq, got[0]) or int(got.sum()) != 512:
                raise AssertionError("chain: kernel disagrees with the "
                                     "sequential greedy scan")
        if label in known_kept and not bool(
                (got.sum(-1) == known_kept[label]).all()):
            raise AssertionError(f"nms_fixpoint [{label}] kept "
                                 f"{got.sum(-1).tolist()} per image")
    if mismatches:
        raise AssertionError(f"kernel keep masks differ from the plain "
                             f"version in {mismatches} places")
    try:
        nms_kernel.nms_fixpoint(torch.zeros((1, n_max + 32, 4), device=dev),
                                thr)
    except ValueError as e:
        log(f"nms_fixpoint at N={n_max + 32} raises: {e}")
    else:
        raise AssertionError(f"nms_fixpoint ran at N={n_max + 32}, past "
                             f"its shared memory")

    # 3b. nms_mask vs plain (the batched row scan), exact
    cases2 = dict(cases)
    cases2["class-offset, 500 padding rows, B=4 N=2048"] = \
        class_offset_boxes(rng, 4, 2048, 500)
    for label in known_kept:
        cases2[label] = fix_cases[label]
    mask_err = 0.0
    for label, boxes in cases2.items():
        t = torch.from_numpy(boxes).to(dev)
        got = nms_kernel.nms_mask(t, thr)
        torch.cuda.synchronize()
        want = nms_mask_seq(t, thr)
        diff = int((got != want).sum())
        mask_err = max(mask_err,
                       float((got.float() - want.float()).abs().max()))
        log(f"nms_mask vs plain [{label}]: {diff} of {got.numel()} differ, "
            f"{int(got.sum())} kept")
        if diff:
            raise AssertionError(f"nms_mask differs from the plain row scan "
                                 f"in {diff} places [{label}]")
        if label == "1024-deep chain" and int(got.sum()) != 512:
            raise AssertionError("chain: nms_mask kept "
                                 f"{int(got.sum())}, not 512")
        if label in known_kept and not bool(
                (got.sum(-1) == known_kept[label]).all()):
            raise AssertionError(f"nms_mask [{label}] kept "
                                 f"{got.sum(-1).tolist()} per image")
    t = torch.from_numpy(cases["random B=8 N=1024"]).to(dev)
    k1, k2 = nms_kernel.nms_fixpoint(t, thr), nms_kernel.nms_mask(t, thr)
    if not torch.equal(k1, k2):
        raise AssertionError("nms_mask and nms_fixpoint disagree on one "
                             "input")
    log("nms_mask == nms_fixpoint on the random B=8 N=1024 input")

    # 3c. iou_matrix vs plain, within 1 ulp, both stores
    iou_ulp, iou_err = 0, 0.0
    iou_stores = set()
    for n, m, n_zero in ((1024, 8192, 0), (1000, 25200, 37),
                         (1000, 25201, 37), (63, 130, 5), (257, 1023, 0),
                         (1, 25200, 0), (1024, 1, 0), (65536, 128, 100)):
        a = torch.from_numpy(sorted_boxes(rng, 1, n)[0]).to(dev)
        b = torch.from_numpy(sorted_boxes(rng, 1, m)[0]).to(dev)
        zero_rows = torch.arange(n_zero, device=dev) * 7
        a[zero_rows] = 0.0
        got = iou_kernel.iou_matrix(a, b)
        torch.cuda.synchronize()
        want = box_iou_matrix(a, b)
        ulp = max_ulp(got, want)
        err = float((got - want).abs().max())
        n_diff = int((got != want).sum())
        iou_ulp, iou_err = max(iou_ulp, ulp), max(iou_err, err)
        store = "float4" if m % 4 == 0 else "float"
        iou_stores.add(store)
        log(f"iou_matrix vs plain [({n}, {m}), {store} store, {n_zero} "
            f"zero-area rows]: {n_diff} of {got.numel()} differ, max {ulp} "
            f"ulp, max abs err {err:.3g}")
        if tuple(got.shape) != (n, m) or ulp > 1:
            raise AssertionError(f"iou_matrix is {ulp} ulp from the plain "
                                 f"version at ({n}, {m})")
        if n_zero and bool((got[zero_rows] != 0).any()):
            raise AssertionError("zero-area rows gave non-zero IoU")
        del got, want
    if iou_stores != {"float4", "float"}:
        raise AssertionError(f"iou_matrix stores exercised: {iou_stores}")

    log(f"[phases 1-3 done at {time.perf_counter() - t_start:.1f} s]")
    # 4a. the serve path
    t0 = time.perf_counter()
    model = build_yolov5("s", 80, dtype=torch.bfloat16, device=dev,
                         generator=torch.Generator().manual_seed(0))
    step = make_packed_serve_step(model, 80, conf_thres=0.001,
                                  iou_thres=thr, pre_nms_topk=1024,
                                  device=dev)
    detector = Detector(step, 80, 640, device=dev)
    log(f"model: YOLOv5s 80 classes bf16, built in "
        f"{time.perf_counter() - t0:.2f} s")
    frame_rng = np.random.default_rng(1)
    requests = [[(480, 640), (720, 1280), (640, 640), (375, 500)],
                [(1080, 1920), (640, 427)]]
    requests = [[frame_rng.integers(0, 256, hw + (3,)).astype(np.uint8)
                 for hw in req] for req in requests]
    detector.detect_batch(requests[0])            # warm-up, not counted
    torch.cuda.synchronize()
    reset_launch_counts()
    answers = [detector.detect_batch(req) for req in requests]
    torch.cuda.synchronize()
    counts = dict(launch_counts)
    log(f"serve path: {sum(map(len, requests))} frames in {len(requests)} "
        f"requests, launches {counts}")
    if counts["nms_fixpoint"] < 1:
        raise AssertionError("nms_fixpoint was not launched on the serve "
                             "path")
    n_dets = 0
    for req, ans in zip(requests, answers):
        for frame, dets in zip(req, ans):
            if check_dets(frame, dets) == 0:
                raise AssertionError("a frame got no dets")
            n_dets += len(dets[1])
    log(f"dets: {n_dets} over {sum(map(len, requests))} frames, finite and "
        f"inside their frames")

    # the same candidates through the kernel and through the plain NMS
    packed_model = packed_copy(model).to(memory_format=torch.channels_last)
    x = torch.from_numpy(np.stack([
        frame_rng.integers(0, 256, (640, 640, 3)).astype(np.uint8)
        for _ in range(8)])).to(dev)
    with torch.inference_mode():
        cands = fused_select_decode_packed(
            packed_model(x.float() / 255.0), 80, topk=1024,
            conf_thres=0.001)
        on_card = [t.cpu() for t in nms_sorted_candidates(
            *cands, iou_thres=thr, max_det=None)]
        plain = nms_sorted_candidates(*(t.cpu() for t in cands),
                                      iou_thres=thr, max_det=None)
        cb, cs, cc = cands
        nb = torch.where((cs > 0)[..., None],
                         cb + cc.float()[..., None] * _MAX_WH,
                         torch.zeros_like(cb))
        keep_k = nms_kernel.nms_fixpoint(nb.contiguous(), thr)
        keep_p = nms_mask_fixpoint(nb, thr)
        step_out = [t.cpu() for t in step(x)]
    for a, b in zip(on_card, plain):
        if not torch.equal(a, b):
            raise AssertionError("dets through the kernel differ from the "
                                 "plain NMS on the same candidates")
    serve_vs_plain = all(torch.equal(a, b) for a, b in zip(step_out, plain))
    cand_diff = int((keep_k != keep_p).sum())
    if cand_diff:
        raise AssertionError(f"kernel keep mask on serve candidates differs "
                             f"in {cand_diff} places")
    log(f"serve candidates B=8: dets through the kernel == plain NMS dets "
        f"({int(plain[3].sum())} kept of {int((cs > 0).sum())}); keep masks "
        f"equal; serve step == plain: {serve_vs_plain}")
    if not serve_vs_plain:
        raise AssertionError("the serve step's dets differ from the plain "
                             "NMS dets on the same frames")

    # the serve step at B=32 now, before the other paths run: phase 5 times
    # it again after them, and the two are printed side by side
    xb = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (32, 640, 640, 3)).astype(np.uint8)).to(dev)
    step_ms_early = cuda_ms(lambda: step(xb), 10)

    # f32 network on the card vs on the CPU, small input, TF32 off
    model32 = build_yolov5("s", 80, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    xs = torch.from_numpy(frame_rng.uniform(
        0, 1, (2, 128, 128, 3)).astype(np.float32))
    with torch.inference_mode():
        ref = model32(xs)
        got = model32.to(dev)(xs.to(dev))
    net_err = max(float((g.cpu() - r).abs().max()) for g, r in zip(got, ref))
    scale = max(float(r.abs().max()) for r in ref)
    log(f"f32 network card vs CPU, 2x128x128: max abs err {net_err:.3g} "
        f"(max |logit| {scale:.3g})")
    if not net_err <= 1e-3 * max(1.0, scale):
        raise AssertionError("f32 network on the card disagrees with the CPU")
    del model32, got, ref

    log(f"[phase 4a done at {time.perf_counter() - t_start:.1f} s]")
    # 4b. the eval path, both routes
    t0 = time.perf_counter()
    batches, gts = eval_batches(np.random.default_rng(2), 64, 32, 640,
                                letterbox_np)
    log(f"eval data: 64 frames letterboxed to 640² in "
        f"{time.perf_counter() - t0:.2f} s, "
        f"{sum(len(g[2]) for g in gts)} gt boxes")

    def gt_eval():
        ev = DetEval(80)
        for img_id, xywh, classes in gts:
            ev.add_gt(img_id, xywh, classes)
        return ev

    fwd = forward_for_eval(model, 80, device=dev)
    kw = dict(conf_thres=0.001, iou_thres=thr, pre_nms_topk=1024,
              max_det=300)
    routes = {
        "unfused": (Evaluator(fwd, 80, device=dev, **kw), "nms_mask"),
        "packed": (Evaluator(None, 80, device=dev, step_fn=(
            make_packed_serve_step(model, 80, device=dev, **kw))),
            "nms_fixpoint"),
    }
    eval_stats, eval_counts, eval_rates = {}, {}, {}
    for name, (ev, kernel) in routes.items():
        ev.run(batches[:1], det_eval=DetEval(80))        # warm-up
        torch.cuda.synchronize()
        reset_launch_counts()
        stats = ev.run(batches, det_eval=gt_eval())
        torch.cuda.synchronize()
        eval_counts[name] = dict(launch_counts)
        eval_stats[name] = stats
        eval_rates[name] = [stats["images_per_sec"]] + [
            ev.run(batches, det_eval=gt_eval())["images_per_sec"]
            for _ in range(2)]
        log(f"eval [{name}]: {stats['num_images']} images, "
            f"{stats['images_per_sec']:.2f} img/s (host accumulate "
            f"included; repeats {eval_rates[name][1]:.2f}, "
            f"{eval_rates[name][2]:.2f}), AP {stats['AP']:.6f} AP50 "
            f"{stats['AP50']:.6f}, launches {eval_counts[name]}")
        if eval_counts[name][kernel] < 1:
            raise AssertionError(f"{kernel} was not launched on the "
                                 f"{name} eval route")
        if stats["num_images"] != 64 or not all(
                math.isfinite(v) and -1.0 <= v <= 1.0
                for k, v in stats.items()
                if k not in ("images_per_sec", "num_images")):
            raise AssertionError(f"eval [{name}]: bad stats {stats}")

    # the host side of one eval batch of 32: staging the uint8 frames in
    # pinned memory, and the accumulate (letterbox inverse and add_det)
    meta0 = (batches[0]["img_id"], batches[0]["scale"], batches[0]["pad_x"],
             batches[0]["pad_y"], batches[0]["orig_hw"])
    t0 = time.perf_counter()
    torch.from_numpy(batches[0]["image"]).pin_memory()
    pin_ms = (time.perf_counter() - t0) * 1e3
    out0 = routes["unfused"][0]._dispatch(batches[0]["image"])
    out0[1].synchronize()
    t0 = time.perf_counter()
    n_img0 = Evaluator._accumulate(gt_eval(), out0, meta0)
    acc_ms = (time.perf_counter() - t0) * 1e3
    log(f"eval host side, one batch of {n_img0} images: pinned staging "
        f"{pin_ms:.3f} ms, accumulate {acc_ms:.3f} ms "
        f"({int(out0[0][3].sum())} dets)")

    # the unfused route's candidates through nms_mask and through the plain
    # batched_nms on CPU copies: the same dets and the same stats
    ev_k, ev_p = gt_eval(), gt_eval()
    n_kept = 0
    for batch in batches:
        meta = (batch["img_id"], batch["scale"], batch["pad_x"],
                batch["pad_y"], batch["orig_hw"])
        with torch.inference_mode():
            cand = multilabel_candidates(
                *fwd(torch.from_numpy(batch["image"]).to(dev)),
                topk=1024, conf_thres=0.001)
            nms_kw = dict(iou_thres=thr, score_thres=0.001,
                          pre_nms_topk=1024, max_det=300)
            dets_k = tuple(t.cpu() for t in batched_nms(*cand, **nms_kw))
            dets_p = batched_nms(*(t.cpu() for t in cand), **nms_kw)
        for a, b in zip(dets_k, dets_p):
            if not torch.equal(a, b):
                raise AssertionError("eval dets through nms_mask differ "
                                     "from the plain batched_nms's")
        n_kept += int(dets_k[3].sum())
        Evaluator._accumulate(ev_k, (dets_k, None), meta)
        Evaluator._accumulate(ev_p, (dets_p, None), meta)
    s_k, s_p = ev_k.summarize(), ev_p.summarize()
    if s_k != s_p:
        raise AssertionError(f"stats through nms_mask {s_k} != plain {s_p}")
    log(f"eval candidates, 64 frames: dets and stats through nms_mask == "
        f"plain batched_nms on CPU copies ({n_kept} dets, AP {s_k['AP']:.6f})")

    # painted gt at 640²: AP > 0.99 through nms_mask, with and without a
    # letterbox inverse (a 1280x1248 source at scale 0.5, pad_x 8)
    gts_lb = [(100.0, 120.0, 60.0, 80.0), (320.0, 300.0, 200.0, 150.0),
              (500.0, 520.0, 24.0, 30.0), (200.0, 450.0, 300.0, 260.0),
              (560.0, 90.0, 90.0, 60.0), (420.0, 600.0, 12.0, 16.0)]
    gt_cls = [0, 17, 42, 79, 5, 63]
    raws = [torch.from_numpy(r).to(dev)
            for r in paint_raw_maps(gts_lb, gt_cls, 640, 80)]
    painted = Evaluator(lambda images: decode_full(raws, 80), 80,
                        conf_thres=0.1, pre_nms_topk=1024, max_det=300,
                        device=dev)
    geometry = {}
    for label, (s_, px, py, hw) in {
            "identity": (1.0, 0.0, 0.0, (640, 640)),
            "letterbox": (0.5, 8.0, 0.0, (1280, 1248))}.items():
        ev = DetEval(80)
        xywh = []
        for cx, cy, w, h in gts_lb:
            x1 = np.clip((cx - w / 2 - px) / s_, 0, hw[1])
            y1 = np.clip((cy - h / 2 - py) / s_, 0, hw[0])
            x2 = np.clip((cx + w / 2 - px) / s_, 0, hw[1])
            y2 = np.clip((cy + h / 2 - py) / s_, 0, hw[0])
            xywh.append((x1, y1, x2 - x1, y2 - y1))
        ev.add_gt("painted", xywh, gt_cls)
        reset_launch_counts()
        stats = painted.run([{
            "image": np.zeros((1, 640, 640, 3), np.uint8),
            "img_id": ["painted"], "scale": [s_], "pad_x": [px],
            "pad_y": [py], "orig_hw": [hw]}], det_eval=ev)
        geometry[label] = stats["AP"]
        log(f"painted gt at 640² [{label}]: AP {stats['AP']:.6f} AP50 "
            f"{stats['AP50']:.6f}, launches {dict(launch_counts)}")
        if launch_counts["nms_mask"] < 1 or not stats["AP"] > 0.99:
            raise AssertionError(f"painted gt [{label}]: AP {stats['AP']} "
                                 f"or no nms_mask launch")

    log(f"[phase 4b done at {time.perf_counter() - t_start:.1f} s]")
    # 4c. the iou op's path
    a_iou = torch.from_numpy(sorted_boxes(rng, 1, 1024)[0]).to(dev)
    b_iou = torch.from_numpy(sorted_boxes(rng, 1, 25200)[0]).to(dev)
    reset_launch_counts()
    iou_out = iou_matrix(a_iou, b_iou)
    torch.cuda.synchronize()
    iou_counts = dict(launch_counts)
    log(f"iou path: ops.boxes.iou_matrix (1024, 25200), launches "
        f"{iou_counts}")
    if iou_counts["iou_matrix"] < 1 or tuple(iou_out.shape) != (1024, 25200):
        raise AssertionError("iou_matrix was not launched by its op")

    log(f"[phase 4c done at {time.perf_counter() - t_start:.1f} s]")
    # 4d. the serving surface: load_detector, TTA/WBF, BatchingDetector
    import tempfile
    import threading
    import urllib.request
    with tempfile.TemporaryDirectory() as tmp:
        ckpt_dir = os.path.join(tmp, "ckpt")
        save_eval_variables(ckpt_dir, model.state_dict(), 0)
        cfg_path = os.path.join(tmp, "chip_smoke_cfg.py")
        with open(cfg_path, "w") as f:
            f.write(SMOKE_CONFIG)
        loaded = load_detector(cfg_path, ckpt=ckpt_dir)
        tta_det = load_detector(cfg_path, ckpt=ckpt_dir, tta=True)
    if loaded.device != dev or tta_det.device != dev:
        raise AssertionError(f"load_detector chose {loaded.device}")
    by_hand = Detector(make_packed_serve_step(
        model, 80, conf_thres=0.001, iou_thres=thr, max_det=300,
        multi_label=False, device=dev), 80, 640, device=dev)
    frames6 = [f for req in requests for f in req]
    loaded.detect_batch(frames6)                  # warm-up, not counted
    torch.cuda.synchronize()
    reset_launch_counts()
    got6 = loaded.detect_batch(frames6)
    torch.cuda.synchronize()
    load_counts = dict(launch_counts)
    want6 = by_hand.detect_batch(frames6)
    n_loaded = sum(check_dets(f, d) for f, d in zip(frames6, got6))
    log(f"load_detector(config file, ckpt dir): {n_loaded} dets over "
        f"{len(frames6)} frames, launches {load_counts}")
    if load_counts["nms_fixpoint"] != 1 or n_loaded == 0:
        raise AssertionError("load_detector's path did not launch "
                             "nms_fixpoint once, or found nothing")
    if not all(same_dets(g, w) for g, w in zip(got6, want6)):
        raise AssertionError("load_detector's dets differ from the "
                             "hand-built Detector's on the same weights")
    log("load_detector's dets == the hand-built Detector's, exactly")

    tta_sizes = [(480, 640), (720, 1280), (640, 640), (375, 500),
                 (1080, 1920), (640, 427), (512, 512), (300, 400)]
    frames8 = [frame_rng.integers(0, 256, hw + (3,)).astype(np.uint8)
               for hw in tta_sizes]
    tta_det.detect_batch(frames8)                 # warm-up: both sizes
    torch.cuda.synchronize()
    reset_launch_counts()
    fused8 = tta_det.detect_batch(frames8)
    torch.cuda.synchronize()
    tta_counts = dict(launch_counts)
    n_fused = sum(check_dets(f, d) for f, d in zip(frames8, fused8))
    with torch.inference_mode():
        x8, metas8 = tta_det._letterbox(frames8, 640)
        views = tta_det._view_dets(frames8, x8, metas8)
        cat = [torch.cat([v[k] for v in views], 1) for k in range(4)]
        wbf_kw = dict(n_views=3, iou_thres=tta_det.wbf_iou, max_out=300)
        on_card = [t.cpu() for t in weighted_boxes_fusion(*cat, **wbf_kw)]
        on_cpu = weighted_boxes_fusion(*(t.cpu() for t in cat), **wbf_kw)
    wbf_box_err = float((on_card[0] - on_cpu[0]).abs().max())
    wbf_score_err = float((on_card[1] - on_cpu[1]).abs().max())
    n_cand = int(cat[3].sum())
    log(f"TTA path: 8 frames, 3 views, launches {tta_counts}; {n_cand} "
        f"candidates of {cat[3].numel()} valid → {n_fused} fused dets; WBF "
        f"card vs CPU: boxes {wbf_box_err:.3g} px, scores "
        f"{wbf_score_err:.3g}, classes equal "
        f"{torch.equal(on_card[2], on_cpu[2])}, valid equal "
        f"{torch.equal(on_card[3], on_cpu[3])}")
    if tta_counts["nms_fixpoint"] != 3:
        raise AssertionError(f"TTA launched nms_fixpoint "
                             f"{tta_counts['nms_fixpoint']} times, not 3")
    if tuple(cat[0].shape) != (8, 900, 4) or n_fused == 0:
        raise AssertionError("TTA views are not (8, 900, 4), or nothing "
                             "was fused")
    if not (wbf_box_err <= 1e-3 and wbf_score_err <= 1e-6
            and torch.equal(on_card[2], on_cpu[2])
            and torch.equal(on_card[3], on_cpu[3])):
        raise AssertionError("WBF on the card differs from WBF on the CPU")
    if int(on_card[3].sum()) != n_fused:
        raise AssertionError("detect_batch's fused dets are not the "
                             "fusion of the views")

    pool = frames8 + frames6 + [frames8[0][::-1].copy(),
                                frames8[2][:, ::-1].copy()]     # 16 frames

    def alone_at(frame, bucket):
        """What detect_batch([frame] * bucket)[0] gives, the frame
        letterboxed once."""
        x1, metas1 = loaded._letterbox([frame], 640)
        out = [t[0].cpu().numpy() for t in loaded._detect(
            x1.expand(bucket, -1, -1, -1).contiguous())]
        return loaded._to_source(*out, metas1[0], frame.shape[:2])

    if not same_dets(alone_at(pool[1], 4), loaded.detect_batch(
            [pool[1]] * 4)[0]):
        raise AssertionError("alone_at is not detect_batch of copies")
    refs = {b: [alone_at(f, b) for f in pool] for b in (4, 16)}
    n_bucket_differs = sum(not same_dets(a, b)
                           for a, b in zip(refs[4], refs[16]))
    batcher = BatchingDetector(loaded, batch_size=16, batch_buckets=(4, 16))
    try:
        batcher.warmup()
        batcher.reset_stats()
        torch.cuda.synchronize()
        reset_launch_counts()
        results, latencies, load_wall = client_load(batcher, pool, 8, 16)
        torch.cuda.synchronize()
        batch_counts = dict(launch_counts)
        stats = batcher.stats()
        srv = make_http_server(batcher, host="127.0.0.1", port=0)
        th = threading.Thread(target=srv.serve_forever, daemon=True)
        th.start()
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{srv.server_address[1]}/healthz",
                    timeout=30) as r:
                healthz = json.loads(r.read())
        finally:
            srv.shutdown()
            srv.server_close()
            th.join(timeout=10)
    finally:
        closed = batcher.close(timeout=60.0)
    at_bucket = {4: 0, 16: 0}
    for idx, dets in results:
        check_dets(pool[idx], dets)
        hit = [b for b in (4, 16) if same_dets(dets, refs[b][idx])]
        if not hit:
            raise AssertionError(f"a batched request's dets equal neither "
                                 f"bucket's Detector.detect_batch (frame "
                                 f"{idx})")
        at_bucket[hit[0]] += 1
    fill = stats["requests"] / max(stats["dispatched_slots"], 1)
    lat = np.sort(np.asarray(latencies)) * 1e3
    log(f"BatchingDetector: 8 clients x 16 frames, all 128 resolved, each "
        f"equal to Detector.detect_batch at a bucket size ({at_bucket}; "
        f"{n_bucket_differs} of 16 frames differ between the buckets); "
        f"stats {stats}, launches {batch_counts}, healthz {healthz}, "
        f"close() {closed}")
    if stats["requests"] != 128 or \
            stats["dispatched_slots"] - stats["padded_slots"] != 128:
        raise AssertionError(f"BatchingDetector stats do not add up: {stats}")
    if batch_counts["nms_fixpoint"] != stats["batches"]:
        raise AssertionError("nms_fixpoint did not launch once per batch")
    if not closed or healthz.get("ok") is not True or \
            healthz.get("requests") != 128:
        raise AssertionError(f"close() {closed}, healthz {healthz}")

    log(f"[phase 4d done at {time.perf_counter() - t_start:.1f} s]")
    # 5. times: CUDA events over back-to-back wrapper calls (the host's
    # launch cost included), and each kernel's device time by name from
    # torch.profiler
    def show(x):
        return "not measured" if x is None else f"{x:.4f} ms"

    def minus(a, b):
        return None if a is None or b is None else a - b

    times = {}
    for b in (1, 8, 32, 64):
        boxes = torch.from_numpy(class_offset_boxes(
            np.random.default_rng(b), b, 1024, 200)).to(dev)
        dev_ms = profiled_ms(
            lambda: (nms_kernel.nms_fixpoint(boxes, thr),
                     nms_kernel.nms_fixpoint_build(boxes, thr)), 20,
            ("nms_fixpoint_kernel", "nms_fixpoint_build_kernel"))
        whole = dev_ms["nms_fixpoint_kernel"]
        build_only = dev_ms["nms_fixpoint_build_kernel"]
        t = times[b] = {
            "ms": cuda_ms(lambda: nms_kernel.nms_fixpoint(boxes, thr), 50),
            "build_ms": cuda_ms(
                lambda: nms_kernel.nms_fixpoint_build(boxes, thr), 50),
            "device_ms": whole, "build_device_ms": build_only,
            "scan_device_ms": minus(whole, build_only),
            "plain_ms": cuda_ms(lambda: nms_mask_fixpoint(boxes, thr), 5,
                                warmup=1),
            "bound": nms_bound_ms(b, 1024),
        }
        log(f"nms_fixpoint B={b} N=1024: events {t['ms']:.4f} ms (build "
            f"alone {t['build_ms']:.4f} ms) | device {show(whole)} = build "
            f"{show(build_only)} + scan {show(t['scan_device_ms'])} | plain "
            f"{t['plain_ms']:.4f} ms | bound {t['bound'][0]:.5f} ms "
            f"({t['bound'][1]})")

    mask_times = {}
    for b, n in ((32, 1024), (8, 2048)):
        boxes = torch.from_numpy(class_offset_boxes(
            np.random.default_rng(n + b), b, n, n // 5)).to(dev)
        dev_ms = profiled_ms(lambda: nms_kernel.nms_mask(boxes, thr), 20,
                             ("nms_mask_build_kernel", "nms_mask_scan_kernel"))
        build_dev = dev_ms["nms_mask_build_kernel"]
        scan_dev = dev_ms["nms_mask_scan_kernel"]
        t = mask_times[(b, n)] = {
            "ms": cuda_ms(lambda: nms_kernel.nms_mask(boxes, thr), 50),
            "device_ms": None if build_dev is None or scan_dev is None
            else build_dev + scan_dev,
            "build_device_ms": build_dev, "scan_device_ms": scan_dev,
            "plain_ms": cuda_ms(lambda: nms_mask_seq(boxes, thr), 3,
                                warmup=1),
            "bound": nms_bound_ms(b, n),
        }
        log(f"nms_mask B={b} N={n}: events {t['ms']:.4f} ms | device "
            f"{show(t['device_ms'])} = build {show(build_dev)} + scan "
            f"{show(scan_dev)} | plain {t['plain_ms']:.4f} ms | bound "
            f"{t['bound'][0]:.5f} ms ({t['bound'][1]})")

    del iou_out
    iou_times = {}
    for n, m in ((1024, 25200), (65536, 128)):
        ia = torch.from_numpy(sorted_boxes(rng, 1, n)[0]).to(dev)
        ib = torch.from_numpy(sorted_boxes(rng, 1, m)[0]).to(dev)
        t = iou_times[(n, m)] = {
            "ms": cuda_ms(lambda: iou_kernel.iou_matrix(ia, ib), 20),
            "device_ms": profiled_ms(
                lambda: iou_kernel.iou_matrix(ia, ib), 10,
                ("iou_matrix_kernel",))["iou_matrix_kernel"],
            "plain_ms": cuda_ms(lambda: box_iou_matrix(ia, ib), 10),
            "bound": iou_bound_ms(n, m),
        }
        log(f"iou_matrix ({n}, {m}): events {t['ms']:.4f} ms | device "
            f"{show(t['device_ms'])} | plain {t['plain_ms']:.4f} ms | "
            f"bound {t['bound'][0]:.5f} ms ({t['bound'][1]})")
        del ia, ib
    iou_t, iou_tall = iou_times[(1024, 25200)], iou_times[(65536, 128)]

    probe = torch.zeros((8, 900), device=dev)
    launch_us = cuda_ms(lambda: probe.add_(1.0), 2000, warmup=100) * 1e3
    log(f"eager launch floor: {launch_us:.2f} us per back-to-back "
        f"elementwise launch on a (8, 900) tensor")
    with torch.inference_mode():
        step_ms = cuda_ms(lambda: step(xb), 10)
        xf = xb.float() / 255.0
        fwd_ms = cuda_ms(lambda: packed_model(xf), 10)
        outs = packed_model(xf)
        sel_ms = cuda_ms(lambda: fused_select_decode_packed(
            outs, 80, topk=1024, conf_thres=0.001), 10)
        cands32 = fused_select_decode_packed(outs, 80, topk=1024,
                                             conf_thres=0.001)
        nms_ms = cuda_ms(lambda: nms_sorted_candidates(
            *cands32, iou_thres=thr, max_det=None), 10)
        del outs, cands32
        # the unfused eval step: forward + decode_full, candidates, NMS
        ev_step_ms = cuda_ms(lambda: routes["unfused"][0]._step(xb), 5)
        fd_ms = cuda_ms(lambda: fwd(xb), 5)
        dec = fwd(xb)
        ml_ms = cuda_ms(lambda: multilabel_candidates(
            *dec, topk=1024, conf_thres=0.001), 10)
        cand = multilabel_candidates(*dec, topk=1024, conf_thres=0.001)
        bn_ms = cuda_ms(lambda: batched_nms(
            *cand, iou_thres=thr, score_thres=0.001, pre_nms_topk=1024,
            max_det=300), 10)
        del dec, cand
        serve_kernels = device_kernels(lambda: step(xb), 5)
        ev_kernels = device_kernels(
            lambda: routes["unfused"][0]._step(xb), 3)

    log(f"[phase 5 kernels and steps done at {time.perf_counter() - t_start:.1f} s]")
    # TTA per batch of 8 and of 32 (the 8 frames four times): the whole
    # detect_batch by the host clock, the three views and the fusion apart
    # by CUDA events (the rescaled view's host letterbox falls in "views")
    tta_times = {}
    for frames_b in (frames8, frames8 * 4):
        nb_ = len(frames_b)
        tta_det.detect_batch(frames_b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            tta_det.detect_batch(frames_b)
        whole_ms = (time.perf_counter() - t0) * 1e3 / 2
        with torch.inference_mode():
            xb_, metas_ = tta_det._letterbox(frames_b, 640)
            views_ms = cuda_ms(
                lambda: tta_det._view_dets(frames_b, xb_, metas_), 2,
                warmup=1)
            views_ = tta_det._view_dets(frames_b, xb_, metas_)
            cat_ = [torch.cat([v[k] for v in views_], 1) for k in range(4)]
            wbf_ms = cuda_ms(lambda: weighted_boxes_fusion(*cat_, **wbf_kw),
                             2, warmup=1)
            wbf_dev = device_busy_ms(
                lambda: weighted_boxes_fusion(*cat_, **wbf_kw))
        tta_times[nb_] = {
            "detect_batch_ms": whole_ms, "views_ms": views_ms,
            "wbf_ms": wbf_ms, "wbf_share": wbf_ms / whole_ms,
            "wbf_device_busy_ms": wbf_dev,
            "wbf_steps": int(cat_[3].sum(-1).max()),
        }
        t = tta_times[nb_]
        log(f"TTA B={nb_} 640x640 bf16, 3 views: detect_batch "
            f"{whole_ms:.3f} ms (host clock, letterboxes included) | views "
            f"{views_ms:.3f} ms | WBF {wbf_ms:.3f} ms ({t['wbf_steps']} "
            f"steps; device busy {wbf_dev:.3f} ms of it), "
            f"{t['wbf_share']:.3f} of the whole")
        del xb_, views_, cat_
    serving = {
        "tta": {str(k): v for k, v in tta_times.items()},
        "batching": {
            "clients": 8, "requests": 128, "batch_size": 16,
            "batch_buckets": [4, 16], "img_per_s": 128 / load_wall,
            "wall_s": load_wall, "mean_fill": fill,
            "batches": stats["batches"],
            "latency_ms_p50": float(lat[len(lat) // 2]),
            "latency_ms_p99": float(lat[min(len(lat) - 1,
                                            int(len(lat) * 0.99))]),
            "latency_ms_max": float(lat[-1]),
            "answers_at_bucket": {str(k): v for k, v in at_bucket.items()},
            "frames_differing_between_buckets": n_bucket_differs,
        },
        "wbf_card_vs_cpu": {"box_err_px": wbf_box_err,
                            "score_err": wbf_score_err},
    }
    bt = serving["batching"]
    log(f"BatchingDetector, 8 closed-loop clients, mixed-size frames "
        f"letterboxed on the client threads: {bt['img_per_s']:.1f} img/s, "
        f"mean fill {fill:.3f} over {bt['batches']} batches, latency p50 "
        f"{bt['latency_ms_p50']:.2f} ms, p99 {bt['latency_ms_p99']:.2f} ms")

    log(f"[phase 5 TTA done at {time.perf_counter() - t_start:.1f} s]")
    def busy(rows, step_ms, kernel):
        """Device-busy ms, idle share, the NMS kernel's ms and the top six
        kernels of one step."""
        total = sum(ms for _, ms in rows)
        return {"device_busy_ms": total, "idle_share": 1.0 - total / step_ms,
                f"{kernel}_ms": sum(ms for k, ms in rows if kernel in k),
                "top_kernels": [[k[:80], ms] for k, ms in rows[:6]]}

    serve_dev = busy(serve_kernels, step_ms, "nms_fixpoint_kernel")
    ev_dev = busy(ev_kernels, ev_step_ms, "nms_mask")
    for label, d in (("serve", serve_dev), ("unfused eval", ev_dev)):
        log(f"{label} step B=32 on the device (profiler): busy "
            f"{d['device_busy_ms']:.3f} ms, idle share "
            f"{d['idle_share']:.3f}; top kernels: " + "; ".join(
                f"{k[:60]} {ms:.3f} ms" for k, ms in d["top_kernels"]))
    log(f"serve step B=32 640x640 bf16: {step_ms:.3f} ms/batch "
        f"({step_ms_early:.3f} ms right after phase 4a), "
        f"{32e3 / step_ms:.1f} img/s | forward {fwd_ms:.3f} ms, "
        f"select+decode {sel_ms:.3f} ms, nms_sorted_candidates "
        f"{nms_ms:.3f} ms (incl. kernel)")
    log(f"unfused eval step B=32 640x640 bf16: {ev_step_ms:.3f} ms/batch | "
        f"forward+decode_full {fd_ms:.3f} ms, multilabel_candidates "
        f"{ml_ms:.3f} ms, batched_nms {bn_ms:.3f} ms (incl. kernel)")

    t32 = times[32]
    m32, m2k = mask_times[(32, 1024)], mask_times[(8, 2048)]
    nms_keys = ("ms", "build_ms", "device_ms", "build_device_ms",
                "scan_device_ms", "plain_ms")
    kernels = [{
        "name": "nms_fixpoint", "route": "cuda",
        "source": "heltondetection_tpu_torch/csrc/nms_fixpoint.cu",
        "replaces": "heltondetection_tpu/ops/nms.py:219",
        "launches": counts["nms_fixpoint"],
        "launches_packed_eval": eval_counts["packed"]["nms_fixpoint"],
        "launches_load_detector": load_counts["nms_fixpoint"],
        "launches_tta": tta_counts["nms_fixpoint"],
        "launches_batching": batch_counts["nms_fixpoint"],
        "max_abs_err": max_abs_err,
        "shape": [32, 1024, 4],
        "ms": t32["ms"], "plain_ms": t32["plain_ms"],
        "bound_ms": t32["bound"][0], "bound_by": t32["bound"][1],
        "library_ms": None, "library_note": NO_LIBRARY,
        "device_ms": t32["device_ms"],
        "build_device_ms": t32["build_device_ms"],
        "scan_device_ms": t32["scan_device_ms"],
        "by_batch_n1024": {
            str(b): {**{k: t[k] for k in nms_keys if k in t},
                     "bound_ms": t["bound"][0]} for b, t in times.items()},
        "max_n": n_max, "clusters_at_once_n1024": clusters,
        "check": "exact keep masks (random, padding, 1024-deep chain, B=1, "
                 "B=64, identical, no overlap, largest N, serve "
                 "candidates); build alone sets the plain S's bits",
    }, {
        "name": "nms_mask", "route": "cuda",
        "source": "heltondetection_tpu_torch/csrc/nms_mask.cu",
        "replaces": "heltondetection_tpu/ops/nms.py:145",
        "launches": eval_counts["unfused"]["nms_mask"],
        "max_abs_err": mask_err,
        "shape": [32, 1024, 4],
        "ms": m32["ms"], "plain_ms": m32["plain_ms"],
        "bound_ms": m32["bound"][0], "bound_by": m32["bound"][1],
        "library_ms": None, "library_note": NO_LIBRARY,
        "device_ms": m32["device_ms"],
        "build_device_ms": m32["build_device_ms"],
        "scan_device_ms": m32["scan_device_ms"],
        "b8_n2048": {**{k: m2k[k] for k in nms_keys if k in m2k},
                     "bound_ms": m2k["bound"][0]},
        "check": "exact keep masks (random, padding, 1024-deep chain, "
                 "identical, no overlap, N=2048, equal to nms_fixpoint, "
                 "eval candidates)",
    }, {
        "name": "iou_matrix", "route": "cuda",
        "source": "heltondetection_tpu_torch/csrc/iou_matrix.cu",
        "replaces": "heltondetection_tpu/ops/boxes.py:143",
        "launches": iou_counts["iou_matrix"],
        "max_abs_err": iou_err, "max_ulp": iou_ulp,
        "shape": [1024, 25200],
        "ms": iou_t["ms"], "plain_ms": iou_t["plain_ms"],
        "bound_ms": iou_t["bound"][0], "bound_by": iou_t["bound"][1],
        "library_ms": None, "library_note": NO_LIBRARY,
        "device_ms": iou_t["device_ms"],
        "tall_65536x128": {
            "ms": iou_tall["ms"], "device_ms": iou_tall["device_ms"],
            "plain_ms": iou_tall["plain_ms"],
            "bound_ms": iou_tall["bound"][0],
            "bound_by": iou_tall["bound"][1]},
        "check": "within 1 ulp of box_iou_matrix, float4 store (1024x8192, "
                 "ragged 1000x25200 with zero-area rows, N=1, 65536x128) "
                 "and float store (M % 4 = 1, 2, 3 and M=1)",
    }]
    serve = {"serve_ms_per_batch_b32": step_ms,
             "serve_ms_per_batch_b32_after_4a": step_ms_early,
             "eager_launch_floor_us": launch_us,
             "serve_img_per_s_b32": 32e3 / step_ms,
             "forward_ms_b32": fwd_ms, "select_decode_ms_b32": sel_ms,
             "nms_sorted_candidates_ms_b32": nms_ms,
             "device_b32": serve_dev}
    evals = {f"{name}_{key}": eval_stats[name][key]
             for name in routes for key in ("images_per_sec", "AP", "AP50")}
    evals.update({f"{name}_images_per_sec_runs": eval_rates[name]
                  for name in routes})
    evals.update({"host_pin_ms_b32": pin_ms, "host_accumulate_ms_b32": acc_ms,
                  "unfused_step_ms_b32": ev_step_ms,
                  "unfused_device_b32": ev_dev,
                  "unfused_forward_decode_ms_b32": fd_ms,
                  "unfused_multilabel_ms_b32": ml_ms,
                  "unfused_batched_nms_ms_b32": bn_ms,
                  "painted_AP_identity": geometry["identity"],
                  "painted_AP_letterbox": geometry["letterbox"],
                  "wall_s": time.perf_counter() - t_start})
    log(json.dumps({"serve": serve}))
    log(json.dumps({"eval": evals}))
    log(json.dumps({"serving": serving}))
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
