"""Fit dataset-specific YOLOv5 anchors (autoanchor) for a config;
counterpart of the JAX package's ``tools/autoanchor.py``.

    python -m heltondetection_tpu_torch.tools.autoanchor --config cfg.py
        [--anchor-t 4.0] [--generations 1000] [--seed 0]
        [--max-images 10000]

Measures the best possible recall (BPR) of the config's anchors (or the
v6.1 defaults) against the TRAIN split's labels at ``model.img_size``,
fits new anchors by k-means and genetic evolution (``data/autoanchor.py``)
and prints a config-ready ``model.anchors`` tuple. Paste the output into
the config (or set ``train.autoanchor=True`` to run the same check at the
start of training). Runs on the host only; no device is used.
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Sequence

from heltondetection_tpu_torch.configs.base import load_config
from heltondetection_tpu_torch.data.autoanchor import (anchor_stats,
                                                       dataset_label_wh,
                                                       fit_anchors)
from heltondetection_tpu_torch.engine.runner import _cfg_anchors, build_dataset
from heltondetection_tpu_torch.ops.anchors import YOLOV5_ANCHORS


def main(argv: Optional[Sequence[str]] = None) -> str:
    """Run the tool on ``argv`` (the command line when None); returns the
    text it printed."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", required=True)
    ap.add_argument("--anchor-t", type=float, default=4.0)
    ap.add_argument("--generations", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-images", type=int, default=10000,
                    help="label-sample cap for formats without annotation "
                         "metadata (COCO reads all labels without decode)")
    args = ap.parse_args(argv)
    printed: List[str] = []

    def say(line: str = "") -> None:
        print(line)
        printed.append(line)

    cfg = load_config(args.config)
    ds = build_dataset(cfg.data, "train")
    cur = _cfg_anchors(cfg) or YOLOV5_ANCHORS
    wh = dataset_label_wh(ds, cfg.model.img_size,
                          max_images=args.max_images, seed=args.seed)
    if not len(wh):
        raise SystemExit("no gt boxes found in the train split")
    st = anchor_stats(wh, cur, args.anchor_t)
    say(f"current anchors: BPR {st['bpr']:.4f}  fitness "
        f"{st['fitness']:.4f}  ({st['n_boxes']} boxes at "
        f"{cfg.model.img_size}^2)")
    fitted, new = fit_anchors(wh, anchor_t=args.anchor_t, seed=args.seed,
                              generations=args.generations)
    say(f"fitted  anchors: BPR {new['bpr']:.4f}  fitness "
        f"{new['fitness']:.4f}")
    if new["fitness"] <= st["fitness"]:
        say("fitted anchors do NOT beat the current set - keep it.")
    else:
        say("\npaste into the config:\n")
        say("    model.anchors = (")
        for level in fitted:
            say(f"        {level},")
        say("    )")
    return "\n".join(printed) + "\n"


if __name__ == "__main__":
    main()
