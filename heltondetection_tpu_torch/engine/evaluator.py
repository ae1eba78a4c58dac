"""The fused packed-head serve step; counterpart of ``make_packed_serve_step``
in heltondetection_tpu/engine/evaluator.py. The ``Evaluator`` comes with
the evaluation slice."""

from __future__ import annotations

from typing import Callable, Optional

import torch

from heltondetection_tpu_torch.device import resolve_device
from heltondetection_tpu_torch.models.yolov5 import YOLOv5, packed_copy
from heltondetection_tpu_torch.ops.postprocess import make_fused_postprocess


def make_packed_serve_step(model: YOLOv5, num_classes: int, *,
                           conf_thres: float = 0.001, iou_thres: float = 0.65,
                           pre_nms_topk: int = 1024,
                           max_det: Optional[int] = None,
                           multi_label: bool = True, anchors=None,
                           device=None) -> Callable:
    """Build the serve step of a standard YOLOv5 ``model``: its weights are
    mapped once to the packed head (:func:`packed_copy`) on ``device`` (CUDA
    unless ``device="cpu"``), and ``step(images (B, S, S, 3) uint8 NHWC) →
    (boxes, scores, classes, valid)`` runs ``/255``, the model and the fused
    postprocess, dets (B, max_det or pre_nms_topk, …) in letterbox
    coordinates. ``multi_label=False`` keeps one class per box."""
    dev = resolve_device(device)
    if num_classes != model.num_classes:
        raise ValueError(f"num_classes {num_classes} != the model's "
                         f"{model.num_classes}")
    model_p = packed_copy(model).to(dev, memory_format=torch.channels_last)
    kw = {} if anchors is None else {"anchors": anchors}
    post = make_fused_postprocess(num_classes, conf_thres=conf_thres,
                                  iou_thres=iou_thres,
                                  pre_nms_topk=pre_nms_topk, max_det=max_det,
                                  max_cls_per_box=4 if multi_label else 1,
                                  **kw)

    @torch.inference_mode()
    def step(images):
        x = torch.as_tensor(images, device=dev).float() / 255.0
        return post(model_p(x))

    return step
