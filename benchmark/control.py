"""Readings of a cell's compared numbers over several seeds, in one
process, without the timed window: the program's (the lower readings), the
control's (the upper), or a planted fault's. The limits in
``checks/<workload>.json`` were set from these.

    python3 benchmark/control.py --workload <name> --seeds 1,2,3
        --mode program|control|half|alter [--out file.jsonl]

``control``: an eval cell's int8 serving program, a train cell's reference
computed in float8; ``half``: a train step that leaves half of the batch
out (the mean over the rest); ``alter``: an eval whose network gives the
first image of every batch its answers from other places (the family's
``alter_head``); ``alter-det``: an eval whose recorder gets the first image
of every batch with each det moved by twice its size. One JSON line a
seed.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


class Altered:
    """A recorder to which the first image of every batch arrives with
    each of its dets moved by twice its size: an answer altered after the
    network, in the evaluator's host side."""

    def __init__(self, rec):
        self.rec = rec

    def add_det(self, img_id, boxes_xywh, scores, classes):
        if img_id % self.rec.feed.batch == 0:
            boxes_xywh = boxes_xywh.copy()
            boxes_xywh[:, :2] += 2.0 * boxes_xywh[:, 2:] + 8.0
        self.rec.add_det(img_id, boxes_xywh, scores, classes)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", default="program",
                    choices=("program", "control", "half", "alter",
                             "alter-det"))
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(HERE))
    import torch
    from benchmark.harness import cell as cells
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 1
    cell = cells.load(args.workload)
    dev = torch.device("cuda", 0)
    from heltondetection_tpu_torch.kernels import KERNELS
    from heltondetection_tpu_torch.kernels.build import build_all
    build_all(KERNELS)
    kind = cell.traffic["driver"]
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        if kind == "eval":
            nums = cell.driver.readings(
                cell, seed, dev, control=args.mode == "control",
                fault=cell.family.alter_head if args.mode == "alter"
                else None,
                alter=Altered if args.mode == "alter-det" else None)
        else:
            nums = cell.driver.readings(
                cell, seed, dev, control=args.mode == "control",
                fault="half" if args.mode == "half" else None)
        line = json.dumps({"workload": args.workload, "mode": args.mode,
                           "seed": seed, "s": time.perf_counter() - t0,
                           **nums})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
