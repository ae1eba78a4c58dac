"""Run one cell of ``BENCHMARK.json`` on the card(s) of this machine.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

Prints the card's name and power limit, then as the last line of standard
output one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``check``: each number compared with its limit. The same numbers end
standard error. Without a card, with fewer cards than the cell asks for,
or with JAX or the JAX package loaded once the window has closed, it
prints no result and exits 1.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(HERE)
# build and kernel caches at fixed paths inside the checkout
CACHES = {"TRITON_CACHE_DIR": os.path.join(HERE, ".cache", "triton"),
          "TORCH_EXTENSIONS_DIR": os.path.join(HERE, ".cache",
                                               "torch_extensions")}
FORBIDDEN = ("jax", "jaxlib", "flax", "heltondetection_tpu")


class Clock:
    """Set-up time from the process's start, with its parts; the parts
    named ``REFERENCE_PART`` are the reference's and no set-up of the
    program."""

    def __init__(self):
        self.parts = {}
        self.last = T0

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.parts[name] = now - self.last
        self.last = now

    def elapsed(self) -> float:
        return time.perf_counter() - T0

    def setup_s(self) -> float:
        """Set-up so far, less the reference's parts: importing, building,
        making frames and weights, the program's construction and warm-up."""
        from benchmark.reference.common import REFERENCE_PART
        return self.elapsed() - self.parts.get(REFERENCE_PART, 0.0)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} &
                  set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for k, v in CACHES.items():
        os.environ[k] = v
    sys.path.insert(0, CHECKOUT)

    import torch
    from benchmark.harness import cell as cells
    from benchmark.harness.timing import nvidia_smi_line

    cell = cells.load(args.workload)
    chips = cell.spec["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    card = nvidia_smi_line()
    print(f"card: {card}", flush=True)
    clock = Clock()
    clock.mark("import")
    device = torch.device("cuda", 0)
    from heltondetection_tpu_torch.kernels import KERNELS
    from heltondetection_tpu_torch.kernels.build import build_all
    build_all(KERNELS)
    clock.mark("kernel build")
    out = cell.driver.run(cell, args.seed, args.seconds, bool(args.trace),
                          device, clock)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 1
    check = {k: {"value": out["check"][k], "limit": lim}
             for k, lim in cell.limits.items()}
    correct = all(c["value"] <= c["limit"] for c in check.values())
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": chips,
                   "memory_peak_bytes": int(out["memory_peak_bytes"])}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"]}
    if args.trace:
        rec = out["record"]
        metrics = {}
        for m in cell.per_layer:
            v = cell.readers[m["name"]](rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}
        sl = rec["slice"]
        device_info.update(busy_s=sl.busy_s, window_s=sl.window_s)
        result["metrics"] = metrics
        result["device"] = device_info
        result["breakdown"] = {"device_ops": sl.device_ops,
                               "idle_gaps": sl.idle_gaps}
    else:
        result["metrics"] = {m["name"]: {"value": out["e2e"][m["name"]],
                                         "unit": m["unit"]}
                             for m in cell.end_to_end}
        result["device"] = device_info
    result["setup_parts_s"] = clock.parts
    result["card"] = card
    result["check"] = check
    print("info " + " ".join(f"{k}={v:.6g}" for k, v in
                             sorted(out["check"].items())), file=sys.stderr)
    for k, c in check.items():
        print(f"check {k} {c['value']:.6g} limit {c['limit']:.6g}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
