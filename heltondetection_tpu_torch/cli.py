"""Command line of the port; counterpart of heltondetection_tpu/cli.py.

    python -m heltondetection_tpu_torch.cli --mode serve --config cfg.py \
        --port 8000 --serve-batch 16

Only ``--mode serve`` is ported: it loads the config's newest checkpoint
(``cfg.eval.ckpt``) with ``load_detector`` and serves it over HTTP through a
``BatchingDetector``. The other modes of the reference raise, naming where
they stand in ROADMAP.md.
"""

from __future__ import annotations

import argparse
import sys

_NOT_PORTED = {
    "train": "run_train (ROADMAP A6-A9)",
    "eval": "run_eval (ROADMAP A9)",
    "test": "run_test (ROADMAP A9, A13)",
    "export": "engine/export.py (ROADMAP A13)",
}


def main(argv=None):
    p = argparse.ArgumentParser("heltondetection_tpu_torch")
    p.add_argument("--mode", required=True,
                   choices=["train", "eval", "test", "export", "serve"])
    p.add_argument("--config", required=True, help="python config file")
    p.add_argument("--host", default="0.0.0.0", help="serve mode: bind host")
    p.add_argument("--port", type=int, default=8000,
                   help="serve mode: bind port")
    p.add_argument("--serve-batch", type=int, default=16,
                   help="serve mode: largest device batch")
    p.add_argument("--serve-wait-ms", type=float, default=5.0,
                   help="serve mode: max wait to fill a batch")
    p.add_argument("--device", default=None,
                   help="torch device; CUDA unless given (e.g. cpu)")
    args = p.parse_args(argv)
    if args.mode != "serve":
        raise NotImplementedError(
            f"--mode {args.mode} is not ported yet: "
            f"{_NOT_PORTED[args.mode]}")

    from heltondetection_tpu_torch.configs.base import load_config
    from heltondetection_tpu_torch.engine.runner import load_detector
    from heltondetection_tpu_torch.engine.serve import (BatchingDetector,
                                                        serve_http)
    cfg = load_config(args.config)
    det = load_detector(cfg, tta=False, device=args.device)
    with BatchingDetector(det, batch_size=args.serve_batch,
                          max_wait_ms=args.serve_wait_ms) as batcher:
        serve_http(batcher, host=args.host, port=args.port,
                   class_names=cfg.data.class_names)
    return 0


if __name__ == "__main__":
    sys.exit(main())
