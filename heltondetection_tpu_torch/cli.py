"""Command line of the port; counterpart of heltondetection_tpu/cli.py.

    python -m heltondetection_tpu_torch.cli --mode train --config cfg.py
    python -m heltondetection_tpu_torch.cli --mode eval --config cfg.py
    python -m heltondetection_tpu_torch.cli --mode serve --config cfg.py \
        --port 8000 --serve-batch 16

``train`` runs ``run_train`` (resuming from the newest checkpoint in the
config's work dir unless ``--no-resume``); ``eval`` scores the config's
checkpoint (``cfg.eval.ckpt``) on its val set with ``run_eval``; ``serve``
loads it with ``load_detector`` and serves it over HTTP through a
``BatchingDetector``. Every mode runs on CUDA unless ``--device cpu``. The
other modes of the reference raise, naming where they stand in ROADMAP.md.
"""

from __future__ import annotations

import argparse
import sys

_NOT_PORTED = {
    "test": "run_test (ROADMAP A9, A13)",
    "export": "engine/export.py (ROADMAP A13)",
}


def main(argv=None):
    p = argparse.ArgumentParser("heltondetection_tpu_torch")
    p.add_argument("--mode", required=True,
                   choices=["train", "eval", "test", "export", "serve"])
    p.add_argument("--config", required=True, help="python config file")
    p.add_argument("--no-resume", action="store_true",
                   help="train mode: start fresh even if a checkpoint "
                        "exists")
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
    if args.mode in _NOT_PORTED:
        raise NotImplementedError(
            f"--mode {args.mode} is not ported yet: "
            f"{_NOT_PORTED[args.mode]}")

    from heltondetection_tpu_torch.configs.base import load_config
    from heltondetection_tpu_torch.device import resolve_device
    from heltondetection_tpu_torch.engine import runner
    dev = resolve_device(args.device)
    cfg = load_config(args.config)
    if args.mode == "train":
        best = runner.run_train(cfg, resume=not args.no_resume, device=dev)
        print(f"best val: {best}")
        return 0
    if args.mode == "eval":
        runner.run_eval(cfg, device=dev)
        return 0

    from heltondetection_tpu_torch.engine.serve import (BatchingDetector,
                                                        serve_http)
    det = runner.load_detector(cfg, tta=False, device=dev)
    with BatchingDetector(det, batch_size=args.serve_batch,
                          max_wait_ms=args.serve_wait_ms) as batcher:
        serve_http(batcher, host=args.host, port=args.port,
                   class_names=cfg.data.class_names)
    return 0


if __name__ == "__main__":
    sys.exit(main())
