"""heltondetection_tpu_torch — the PyTorch/CUDA port of heltondetection_tpu.

A second package beside the JAX one, with the same sub-package layout
(``ops/``, ``models/``, ``engine/``, ``data/``, ``utils/``) so each module
has a named counterpart. Hand-written CUDA kernels live in ``csrc/`` and are
built on first use by ``kernels/``; importing the package never builds or
needs ``nvcc``.

Ported so far: the YOLOv5 packed-head serve path (uint8 NHWC frames →
CSPDarknet → PAFPNv5 → packed head → fused select/decode → class-aware greedy
NMS on the ``nms_fixpoint`` CUDA kernel), the non-TTA ``Detector``, and the
COCO eval path (``forward_for_eval`` → ``decode_full`` → multi-label
candidates → ``batched_nms`` on the ``nms_mask`` CUDA kernel → letterbox
inverse → the port's own ``DetEval``) through ``Evaluator``. The pairwise
IoU op ``ops.boxes.iou_matrix`` runs the ``iou_matrix`` CUDA kernel.

Entry points run on CUDA unless the caller passes ``device="cpu"``; without
CUDA they raise (see :func:`heltondetection_tpu_torch.device.resolve_device`).
"""

__version__ = "0.1.0"

__all__ = ["build_yolov5", "make_packed_serve_step", "Detector",
           "Evaluator", "forward_for_eval", "resolve_device"]


def __getattr__(name):
    # lazy: importing the package pulls in no model code
    if name == "build_yolov5":
        from heltondetection_tpu_torch.models.yolov5 import build_yolov5
        return build_yolov5
    if name == "make_packed_serve_step":
        from heltondetection_tpu_torch.engine.evaluator import \
            make_packed_serve_step
        return make_packed_serve_step
    if name == "Detector":
        from heltondetection_tpu_torch.engine.infer import Detector
        return Detector
    if name == "Evaluator":
        from heltondetection_tpu_torch.engine.evaluator import Evaluator
        return Evaluator
    if name == "forward_for_eval":
        from heltondetection_tpu_torch.engine.runner import forward_for_eval
        return forward_for_eval
    if name == "resolve_device":
        from heltondetection_tpu_torch.device import resolve_device
        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
