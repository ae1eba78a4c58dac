#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (heltondetection_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line) when it
fails:

1. the card's name and power limit, from nvidia-smi;
2. build every CUDA kernel of the serve path from csrc/, all at once;
3. hold each kernel against its plain PyTorch version on the card, exactly
   (the NMS keep mask is a bitmask: no tolerance), on random boxes at
   B=8 N=1024, on class-offset boxes with zeroed padding rows, and on a
   1024-deep suppression chain;
4. the main path: a full-width YOLOv5s (80 classes, 640², bf16, random
   weights from seed 0) answers six frames of mixed sizes in two requests
   through make_packed_serve_step + Detector. The kernels' launch counts are
   reset just before and read just after; every kernel must have launched.
   Its dets must be finite, inside their frames, and equal to the dets of
   the plain NMS on the same candidates; the f32 network must match its CPU
   run on a small input (TF32 off);
5. times on the card (CUDA events): the kernel and its plain version at
   B=8 and B=32, N=1024, beside the kernel's bound, and the serve step at
   B=32 with its breakdown. No PyTorch call computes greedy NMS (there is no
   torchvision), so the kernel has no library yardstick: library_ms is null.

The two lines before the last are the kernels line, {"kernels": [...]},
and the card's nvidia-smi line; the last line is {"ok": true, "device":
{...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and non-tensor f32 FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
NMS_OPS_PER_PAIR = 14   # min, max x4, sub x2, mul, add x2, sub, mul, cmp


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
    """Class-offset boxes as nms_sorted_candidates builds them, with the last
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


def nms_bound_ms(b: int, n: int) -> tuple:
    """Least time for the keep mask of (b, n, 4) boxes: bytes (boxes read,
    mask written) over HBM rate, pairwise tests over the f32 rate."""
    t_bytes = (b * n * 16 + b * n) / HBM_BYTES_PER_S
    t_ops = b * n * (n - 1) / 2 * NMS_OPS_PER_PAIR / F32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes > t_ops else "operations")


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
    from heltondetection_tpu_torch.engine.evaluator import \
        make_packed_serve_step
    from heltondetection_tpu_torch.engine.infer import Detector
    from heltondetection_tpu_torch.kernels import (KERNELS, build,
                                                   launch_counts,
                                                   reset_launch_counts)
    from heltondetection_tpu_torch.kernels import nms as nms_kernel
    from heltondetection_tpu_torch.models.yolov5 import (build_yolov5,
                                                         packed_copy)
    from heltondetection_tpu_torch.ops.nms import (nms_mask_fixpoint,
                                                   nms_mask_seq)
    from heltondetection_tpu_torch.ops.postprocess import (
        _MAX_WH, fused_select_decode_packed, nms_sorted_candidates)

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

    # 3. kernel vs plain, exact
    rng = np.random.default_rng(0)
    thr = 0.65
    cases = {
        "random B=8 N=1024": sorted_boxes(rng, 8, 1024),
        "class-offset, 300 padding rows, B=8 N=1024":
            class_offset_boxes(rng, 8, 1024, 300),
        "1024-deep chain": chain_boxes(1024),
    }
    mismatches = 0
    max_abs_err = 0.0
    for label, boxes in cases.items():
        t = torch.from_numpy(boxes).to(dev)
        got = nms_kernel.nms_fixpoint(t, thr)
        torch.cuda.synchronize()
        want = nms_mask_fixpoint(t, thr)
        diff = int((got != want).sum())
        mismatches += diff
        max_abs_err = max(max_abs_err,
                          float((got.float() - want.float()).abs().max()))
        log(f"kernel vs plain [{label}]: {diff} of {got.numel()} differ, "
            f"{int(got.sum())} kept")
        if label == "1024-deep chain":
            seq = nms_mask_seq(t[0], thr)
            if not torch.equal(seq, got[0]) or int(got.sum()) != 512:
                raise AssertionError("chain: kernel disagrees with the "
                                     "sequential greedy scan")
    if mismatches:
        raise AssertionError(f"kernel keep masks differ from the plain "
                             f"version in {mismatches} places")

    # 4. the main path
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
    log(f"main path: {sum(map(len, requests))} frames in {len(requests)} "
        f"requests, launches {counts}")
    for name in KERNELS:
        if counts[name] < 1:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"main path")
    n_dets = 0
    for req, ans in zip(requests, answers):
        for frame, (boxes, scores, classes) in zip(req, ans):
            h, w = frame.shape[:2]
            if not (np.isfinite(boxes).all() and np.isfinite(scores).all()):
                raise AssertionError("non-finite dets")
            if len(scores) == 0:
                raise AssertionError("a frame got no dets")
            if ((boxes[:, [0, 2]] < 0).any() or (boxes[:, [0, 2]] > w).any()
                    or (boxes[:, [1, 3]] < 0).any()
                    or (boxes[:, [1, 3]] > h).any()):
                raise AssertionError("dets outside their frame")
            if ((scores <= 0) | (scores > 1)).any() or \
                    ((classes < 0) | (classes >= 80)).any():
                raise AssertionError("scores or classes out of range")
            n_dets += len(scores)
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

    # 5. times
    times = {}
    for b in (8, 32):
        boxes = torch.from_numpy(class_offset_boxes(
            np.random.default_rng(b), b, 1024, 200)).to(dev)
        times[b] = {
            "ms": cuda_ms(lambda: nms_kernel.nms_fixpoint(boxes, thr), 50),
            "plain_ms": cuda_ms(lambda: nms_mask_fixpoint(boxes, thr), 5,
                                warmup=1),
            "bound": nms_bound_ms(b, 1024),
        }
        log(f"nms_fixpoint B={b} N=1024: kernel {times[b]['ms']:.4f} ms, "
            f"plain {times[b]['plain_ms']:.4f} ms, bound "
            f"{times[b]['bound'][0]:.5f} ms ({times[b]['bound'][1]})")

    xb = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (32, 640, 640, 3)).astype(np.uint8)).to(dev)
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
    log(f"serve step B=32 640x640 bf16: {step_ms:.3f} ms/batch, "
        f"{32e3 / step_ms:.1f} img/s | forward {fwd_ms:.3f} ms, "
        f"select+decode {sel_ms:.3f} ms, nms_sorted_candidates "
        f"{nms_ms:.3f} ms (incl. kernel)")

    t32 = times[32]
    kernels = [{
        "name": "nms_fixpoint", "route": "cuda",
        "source": "heltondetection_tpu_torch/csrc/nms_fixpoint.cu",
        "replaces": "heltondetection_tpu/ops/nms.py:219",
        "launches": counts["nms_fixpoint"],
        "max_abs_err": max_abs_err,
        "shape": [32, 1024, 4],
        "ms": t32["ms"], "plain_ms": t32["plain_ms"],
        "bound_ms": t32["bound"][0], "bound_by": t32["bound"][1],
        "library_ms": None,
        "ms_b8": times[8]["ms"], "plain_ms_b8": times[8]["plain_ms"],
        "bound_ms_b8": times[8]["bound"][0],
        "check": "exact keep masks (random, padding, 1024-deep chain, "
                 "serve candidates)",
    }]
    serve = {"serve_ms_per_batch_b32": step_ms,
             "serve_img_per_s_b32": 32e3 / step_ms,
             "forward_ms_b32": fwd_ms, "select_decode_ms_b32": sel_ms,
             "nms_sorted_candidates_ms_b32": nms_ms,
             "wall_s": time.perf_counter() - t_start}
    log(json.dumps({"serve": serve}))
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
