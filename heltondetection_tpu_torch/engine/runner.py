"""The eval forward of a YOLOv5 model; counterpart of the YOLOv5 branch of
``_forward_for_eval`` in heltondetection_tpu/engine/runner.py. The rest of
the runner (train, eval and test orchestration, ``load_detector``) comes
with the training slice."""

from __future__ import annotations

from typing import Callable

import torch

from heltondetection_tpu_torch.device import resolve_device
from heltondetection_tpu_torch.models.yolov5 import YOLOv5, decode_full
from heltondetection_tpu_torch.ops.anchors import normalize_anchors


def forward_for_eval(model: YOLOv5, num_classes: int, anchors=None,
                     device=None) -> Callable:
    """``fwd(images (B, S, S, 3) uint8) → (boxes (B, N, 4), obj (B, N),
    cls (B, N, C))``: ``/255``, the model and ``decode_full``, the contract
    of ``Evaluator(forward_fn=…)`` and ``Detector(forward_fn=…)``. The
    model moves to ``device`` (CUDA unless ``device="cpu"``) in place, with
    channels-last weights; ``anchors`` replaces the v6.1 default set."""
    dev = resolve_device(device)
    if num_classes != model.num_classes:
        raise ValueError(f"num_classes {num_classes} != the model's "
                         f"{model.num_classes}")
    model = model.to(dev, memory_format=torch.channels_last).eval()
    kw = {} if anchors is None else {"anchors": normalize_anchors(anchors)}

    @torch.inference_mode()
    def fwd(images):
        x = torch.as_tensor(images, device=dev).float() / 255.0
        return decode_full(model(x), num_classes, **kw)

    return fwd
