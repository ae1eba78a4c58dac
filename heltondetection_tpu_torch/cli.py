"""Command line of the port; counterpart of heltondetection_tpu/cli.py.

    python -m heltondetection_tpu_torch.cli --mode train --config cfg.py
    python -m heltondetection_tpu_torch.cli --mode eval --config cfg.py \
        [--out dets.json]
    python -m heltondetection_tpu_torch.cli --mode test --config cfg.py \
        --source img.jpg|dir|video.mp4 [--out out.jpg]
    python -m heltondetection_tpu_torch.cli --mode export --config cfg.py \
        [--out model.pt2]
    python -m heltondetection_tpu_torch.cli --mode serve --config cfg.py \
        --port 8000 --serve-batch 16

``train`` runs ``run_train`` (resuming from the newest checkpoint in the
config's work dir unless ``--no-resume``); ``eval`` scores the config's
checkpoint (``cfg.eval.ckpt``) on its val set with ``run_eval``, logging
its artifacts, and with ``--out`` also writes the dets as a COCO results
JSON; ``test`` runs ``run_test`` on ``--source`` (rendered frames and, with
``test.save_heatmaps``, the heat-map panels go to ``--out``); ``export``
writes the checkpoint's serving program as a ``torch.export`` ``.pt2``
(``engine.export.load_serving_fn`` runs it; the NMS kernels are custom
ops of ``heltondetection_tpu_torch.kernels.ops``, so the package must be
importable where it is loaded); ``serve`` loads the checkpoint with
``load_detector`` and serves it over HTTP through a ``BatchingDetector``.
Every mode runs on CUDA unless ``--device cpu``. ``eval.int8`` scores,
and ``test.int8`` tests, serves and exports, the W8A8 int8 program
(``ops/quant.py``; its quant tree is cached beside the run).

The test, export and eval-artifact modes are held to the JAX package on
the CPU by ``JAX_PLATFORMS=cpu python -m pytest
tests/test_torch_port_{export,artifacts,run_test}.py``, and driven on the
card by ``python3 chip_smoke.py`` (phase 4i: both published configs
exported, loaded and held to their eager dets; ``run_test`` with its
panels; ``run_eval`` with ``dump_json`` and its artifacts).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser("heltondetection_tpu_torch")
    p.add_argument("--mode", required=True,
                   choices=["train", "eval", "test", "export", "serve"])
    p.add_argument("--config", required=True, help="python config file")
    p.add_argument("--source", default=None,
                   help="test mode: an image, a directory or a video")
    p.add_argument("--out", default=None,
                   help="eval: COCO results JSON; test: rendered output; "
                        "export: the .pt2 file (default model.pt2)")
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
    if args.mode == "test" and not args.source:
        p.error("--mode test requires --source")

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
        runner.run_eval(cfg, dump_json=args.out, device=dev)
        return 0
    if args.mode == "test":
        out = runner.run_test(cfg, args.source, args.out, device=dev)
        print({k: (v.tolist() if hasattr(v, "tolist") else v)
               for k, v in out.items()})
        return 0
    if args.mode == "export":
        from heltondetection_tpu_torch.engine.export import export_model
        model = runner.build_model(cfg.model, runner._config_num_classes(cfg))
        model.load_state_dict(runner._load_eval_variables(cfg))
        export_model(cfg, model, args.out or "model.pt2", device=dev)
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
