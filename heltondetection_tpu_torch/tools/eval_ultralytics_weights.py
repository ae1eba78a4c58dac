"""Score Ultralytics YOLOv5 weights through the port's eval; counterpart
of the JAX package's ``tools/eval_ultralytics_weights.py``, the oracle
evaluator of the reference's ``eval_yolov5_by_pycocotools.py``: official
weights scored by the stack's own backbone, neck, head, decode, NMS and
COCO eval (the reference's rows: yolov5s 30.928 / yolov5l 42.015
mAP50-95).

    python -m heltondetection_tpu_torch.tools.eval_ultralytics_weights \\
        --weights yolov5s.pt --variant s --ann instances_val2017.json \\
        --imgs val2017/ [--img-size 640] [--batch 32] [--conf 0.001] \\
        [--iou 0.65] [--int8 layer|flow] [--device cpu]

``--int8`` also quantizes the model (W8A8 post-training quantization,
``ops/quant.py``, calibrated on the first 32 frames letterboxed as the
eval letterboxes them) and scores the quantized program: the mAP cost of
int8 on real weights. The model runs on CUDA unless ``--device`` names
another device; without CUDA it raises rather than fall back to the CPU.
The official ``.pt`` files are full-model pickles, which execute code
when loaded: load only files you trust.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import numpy as np

from heltondetection_tpu_torch.data.augment import EvalPipeline
from heltondetection_tpu_torch.data.letterbox import letterbox_np
from heltondetection_tpu_torch.data.loader import EvalLoader
from heltondetection_tpu_torch.data.readers import COCODataset
from heltondetection_tpu_torch.device import resolve_device
from heltondetection_tpu_torch.engine.evaluator import Evaluator
from heltondetection_tpu_torch.engine.runner import forward_for_eval
from heltondetection_tpu_torch.ops.quant import (quantize_yolo,
                                                 quantize_yolo_flow)
from heltondetection_tpu_torch.utils.cocoeval import DetEval, format_summary
from heltondetection_tpu_torch.utils.torch_convert import \
    load_ultralytics_checkpoint

NUM_CLASSES = 80        # the official weights' COCO head
CALIB_FRAMES = 32


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """Run the tool on ``argv`` (the command line when None); returns the
    stats it scored (``Evaluator.run``'s dict)."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--weights", required=True)
    p.add_argument("--variant", default="s", choices=list("nsmlx"))
    p.add_argument("--ann", required=True)
    p.add_argument("--imgs", required=True)
    p.add_argument("--img-size", type=int, default=640)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--conf", type=float, default=0.001)
    p.add_argument("--iou", type=float, default=0.65)
    p.add_argument("--int8", choices=["layer", "flow"], default=None,
                   help="also quantize (W8A8 PTQ, ops/quant.py) and score "
                        "the quantized program — the real-weights mAP "
                        "delta measurement for the int8 serving path")
    p.add_argument("--device", default=None,
                   help="torch device (default: CUDA; 'cpu' to run there)")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    model, _ = load_ultralytics_checkpoint(args.weights, NUM_CLASSES,
                                           variant=args.variant, device=dev)
    ds = COCODataset(args.ann, args.imgs)

    quant = None
    if args.int8:
        nb = np.zeros((0, 4), np.float32)
        calib = np.stack([
            letterbox_np(ds.load(i)["image"], nb, args.img_size)[0]
            for i in range(min(CALIB_FRAMES, len(ds)))]).astype(np.uint8)
        quantize = (quantize_yolo_flow if args.int8 == "flow"
                    else quantize_yolo)
        quant = quantize(model, calib)

    fwd = forward_for_eval(model, NUM_CLASSES, device=dev, quant=quant)
    ev = Evaluator(fwd, NUM_CLASSES, conf_thres=args.conf,
                   iou_thres=args.iou, multi_label=True, device=dev)
    det = DetEval(NUM_CLASSES)
    ds.gt_for_eval(det)
    loader = EvalLoader(EvalPipeline(ds, args.img_size), args.batch)
    stats = ev.run(loader, det_eval=det)
    print(format_summary(stats))
    print(f"mAP50-95 = {stats['AP'] * 100:.3f}  AP50 = "
          f"{stats['AP50'] * 100:.3f}")
    print("reference oracle rows: yolov5s 30.928 / yolov5l 42.015 "
          "(README.md:133,135)")
    return stats


if __name__ == "__main__":
    main()
