"""Model export; counterpart of heltondetection_tpu/engine/export.py.

The reference serializes its jitted serving function to StableHLO with the
weights baked in. The port's route is ``torch.export``: the serving
function becomes an ``ExportedProgram`` (an ATen graph, the weights inside
it) saved to a ``.pt2`` file, which :func:`load_serving_fn` runs again
without the model-building code. The NMS and IoU kernels appear in the
graph as the custom ops of ``kernels/ops.py``
(``torch.ops.heltondetection.*``): on CUDA tensors the loaded program
launches the kernels, on CPU tensors it runs their plain versions.

Shapes are fixed at export (one frame of ``img_size``², uint8 NHWC), as
the reference's are, and so is the device: a program exported on the card
runs there. With ``test.int8`` the program is the quantized one: the int8
weights, folded BatchNorm and activation scales are constants of the
``.pt2``, and its int8 products are ``aten._int_mm`` nodes.
"""

from __future__ import annotations

import os
from typing import Callable, Tuple

import torch
import torch.nn as nn

from heltondetection_tpu_torch.device import resolve_device


class _Serving(nn.Module):
    """The module ``torch.export`` traces: ``fn(model, *args)``, with
    ``model`` a submodule so that its weights go into the program."""

    def __init__(self, model: nn.Module, fn: Callable):
        super().__init__()
        self.model = model
        self.fn = fn

    def forward(self, *args):
        return self.fn(self.model, *args)


def export_serving_fn(model: nn.Module, fn: Callable, example_args: Tuple,
                      path: str) -> torch.export.ExportedProgram:
    """``torch.export`` ``fn(model, *example_args)`` at the example
    arguments' shapes and save the program to ``path`` (``.pt2``)."""
    with torch.no_grad():
        program = torch.export.export(_Serving(model, fn).eval(),
                                      tuple(example_args))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.export.save(program, path)
    return program


def load_serving_fn(path: str) -> Callable:
    """The program saved at ``path`` as a function of its inputs, run in
    inference mode. It registers the kernels' custom ops first
    (``kernels/ops.py``); no model code is needed."""
    from heltondetection_tpu_torch.kernels import ops  # noqa: F401
    module = torch.export.load(path).module()

    @torch.inference_mode()
    def serve(*args):
        return module(*args)

    return serve


def yolov5_serve(num_classes: int, *, conf_thres: float = 0.25,
                 iou_thres: float = 0.45, anchors=None) -> Callable:
    """``serve(net, images (B, S, S, 3) uint8) → (boxes, scores, classes,
    valid)``, the reference's YOLOv5 serving graph: ``/255`` → the standard
    head → ``decode_full`` (``anchors`` replaces the v6.1 default set) →
    the single-label :func:`~heltondetection_tpu_torch.engine.evaluator.
    make_postprocess`, its NMS the ``nms_mask`` op. What
    :func:`export_yolov5` exports, and run eagerly its reference."""
    from heltondetection_tpu_torch.engine.evaluator import make_postprocess
    from heltondetection_tpu_torch.models.yolov5 import decode_full
    from heltondetection_tpu_torch.ops.anchors import normalize_anchors
    post = make_postprocess(num_classes, conf_thres=conf_thres,
                            iou_thres=iou_thres, multi_label=False)
    kw = {} if anchors is None else {"anchors": normalize_anchors(anchors)}

    def serve(net, images_u8):
        return post(*decode_full(net(images_u8.float() / 255.0),
                                 num_classes, **kw))

    return serve


def faster_rcnn_serve(net, images_u8):
    """The FasterRCNN serving graph: ``/255`` → ``faster_rcnn_infer`` (RPN
    proposals, RoIAlign or RoIPool, the box head, the class-aware NMS;
    every NMS the ``nms_mask`` op) → the fixed dets. What
    :func:`export_faster_rcnn` exports."""
    from heltondetection_tpu_torch.models.faster_rcnn import \
        faster_rcnn_infer
    return faster_rcnn_infer(net, images_u8.float() / 255.0)


def export_yolov5(model, num_classes: int, img_size: int, path: str, *,
                  conf_thres: float = 0.25, iou_thres: float = 0.45,
                  anchors=None, device=None) -> torch.export.ExportedProgram:
    """Export :func:`yolov5_serve` of ``model`` (a standard-head YOLOv5,
    moved to ``device`` in place: CUDA unless ``device="cpu"``) for one
    frame of ``img_size``² to ``path``."""
    dev = resolve_device(device)
    serve = yolov5_serve(num_classes, conf_thres=conf_thres,
                         iou_thres=iou_thres, anchors=anchors)
    x = torch.zeros((1, img_size, img_size, 3), dtype=torch.uint8,
                    device=dev)
    return export_serving_fn(model.to(dev).eval(), serve, (x,), path)


def export_faster_rcnn(model, img_size: int, path: str, *, device=None
                       ) -> torch.export.ExportedProgram:
    """Export :func:`faster_rcnn_serve` of ``model`` (moved to ``device``
    in place) for one frame of ``img_size``² to ``path``."""
    dev = resolve_device(device)
    model = model.to(dev).eval()
    model.anchors(dev)      # made before the trace, a constant inside it
    x = torch.zeros((1, img_size, img_size, 3), dtype=torch.uint8,
                    device=dev)
    return export_serving_fn(model, faster_rcnn_serve, (x,), path)


def export_model(cfg, model, path: str, *, device=None
                 ) -> torch.export.ExportedProgram:
    """Family dispatch of ``--mode export``: the config's test thresholds
    and anchors for YOLOv5. ``test.int8`` exports the quantized program:
    the config's quant tree (``engine.runner._int8_quant_tree``,
    calibrated or from its cache) on a quantized copy of ``model``."""
    if getattr(cfg.test, "int8", False):
        from heltondetection_tpu_torch.engine.runner import _int8_quant_tree
        from heltondetection_tpu_torch.ops.quant import attach_quant
        model = model.to(resolve_device(device)).eval()
        model = attach_quant(model, _int8_quant_tree(cfg, model))
    if cfg.model.family == "yolov5":
        from heltondetection_tpu_torch.engine.runner import _cfg_anchors
        return export_yolov5(model, model.num_classes, cfg.model.img_size,
                             path, conf_thres=cfg.test.conf_thres,
                             iou_thres=cfg.test.iou_thres,
                             anchors=_cfg_anchors(cfg), device=device)
    if cfg.model.family == "faster_rcnn":
        return export_faster_rcnn(model, cfg.model.img_size, path,
                                  device=device)
    raise ValueError(f"no export path for family {cfg.model.family!r}")
