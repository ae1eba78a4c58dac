#!/usr/bin/env python3
"""Check and time the port's ``iou_matrix`` CUDA kernel on one GPU.

    python3 tools/bench_iou_matrix.py [--sass OUT.sass]

Builds ``heltondetection_tpu_torch/csrc/iou_matrix.cu``, holds the kernel
against the plain ``box_iou_matrix`` (distance in float32 ulps; 0 is
expected) at shapes that reach both stores (M % 4 == 0 and not) and every
ragged edge, and times it at (1024, 25200), (1024, 25201) (the float
store) and (65536, 128): CUDA events over back-to-back wrapper calls, the
device time by kernel name from torch.profiler, the plain version, and
the bytes bound. ``--sass`` writes
the compiled code (``cuobjdump -sass``) to a file. Prints the card's name
and power limit first; fails without CUDA.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA's data sheet

CHECK_SHAPES = [(1024, 8192), (1000, 25200), (1000, 25201), (257, 1023),
                (63, 130), (1, 25200), (1, 5), (1024, 1), (130, 4),
                (65536, 128)]
TIME_SHAPES = [(1024, 25200), (1024, 25201), (65536, 128)]


def boxes(rng, n, size=640.0):
    xy = rng.uniform(0, size * 0.8, (n, 2))
    wh = rng.uniform(4, size * 0.3, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def max_ulp(a, b) -> int:
    import torch
    ia = (a + 0.0).view(torch.int32).long()
    ib = (b + 0.0).view(torch.int32).long()
    return int((ia - ib).abs().max())


def event_ms(fn, iters=50, warmup=5) -> float:
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


def device_ms(fn, name: str, iters=20):
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(e.device_time_total for e in prof.key_averages()
                if name in e.key)
    return total / iters / 1e3 if total else None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sass", help="write cuobjdump -sass of the library here")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("bench_iou_matrix: CUDA is not available", file=sys.stderr)
        return 2
    from heltondetection_tpu_torch.kernels import build
    from heltondetection_tpu_torch.kernels import iou as iou_kernel
    from heltondetection_tpu_torch.ops.boxes import box_iou_matrix

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    lib, secs, report = build.build_all(["iou_matrix"])["iou_matrix"]
    print(f"built {lib.name} in {secs:.2f} s")
    for line in report.splitlines():
        if "registers" in line or "Compiling" in line or "spill" in line:
            print("  " + line.strip())
    if args.sass:
        from torch.utils.cpp_extension import CUDA_HOME
        sass = subprocess.run(
            [os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass", str(lib)],
            capture_output=True, text=True, check=True).stdout
        os.makedirs(os.path.dirname(os.path.abspath(args.sass)),
                    exist_ok=True)
        with open(args.sass, "w") as f:
            f.write(sass)

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    ok = True
    for n, m in CHECK_SHAPES:
        a = torch.from_numpy(boxes(rng, n)).to(dev)
        b = torch.from_numpy(boxes(rng, m)).to(dev)
        a[::7] = 0.0                       # zero-area rows give exact zeros
        got = iou_kernel.iou_matrix(a, b)
        torch.cuda.synchronize()
        want = box_iou_matrix(a, b)
        ulp = max_ulp(got, want)
        ok &= ulp == 0
        print(f"check ({n}, {m}) {'float4' if m % 4 == 0 else 'float'} "
              f"store: max {ulp} ulp, {int((got != want).sum())} differ",
              flush=True)

    for n, m in TIME_SHAPES:
        a = torch.from_numpy(boxes(rng, n)).to(dev)
        b = torch.from_numpy(boxes(rng, m)).to(dev)
        bound = (4 * n * m + 16 * (n + m)) / HBM_BYTES_PER_S * 1e3
        ev = [event_ms(lambda: iou_kernel.iou_matrix(a, b)) for _ in range(3)]
        dv = device_ms(lambda: iou_kernel.iou_matrix(a, b),
                       "iou_matrix_kernel")
        plain = event_ms(lambda: box_iou_matrix(a, b), iters=10, warmup=2)
        print(f"time ({n}, {m}): events {ev[0]:.4f} {ev[1]:.4f} {ev[2]:.4f} "
              f"ms | device "
              f"{'not measured' if dv is None else f'{dv:.4f} ms'} | plain "
              f"{plain:.4f} ms | bytes bound {bound:.5f} ms", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
