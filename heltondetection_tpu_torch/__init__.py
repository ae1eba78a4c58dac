"""heltondetection_tpu_torch — the PyTorch/CUDA port of heltondetection_tpu.

A second package beside the JAX one, with the same sub-package layout
(``ops/``, ``models/``, ``engine/``, ``data/``, ``utils/``) so each module
has a named counterpart. Hand-written CUDA kernels live in ``csrc/`` and are
built on first use by ``kernels/``; importing the package never builds or
needs ``nvcc``.

Ported so far: the YOLOv5 packed-head serve path (uint8 NHWC frames →
CSPDarknet → PAFPNv5 → packed head → fused select/decode → class-aware greedy
NMS on the ``nms_fixpoint`` CUDA kernel); the serving surface over it
(``load_detector`` from a config file and a checkpoint directory, the
``Detector`` with TTA views fused by WBF, ``BatchingDetector`` and its HTTP
front end, ``python -m heltondetection_tpu_torch.cli --mode serve``); and
the COCO eval path (``forward_for_eval`` → ``decode_full`` → multi-label
candidates → ``batched_nms`` on the ``nms_mask`` CUDA kernel → letterbox
inverse → the port's own ``DetEval``) through ``Evaluator``. The pairwise
IoU op ``ops.boxes.iou_matrix`` runs the ``iou_matrix`` CUDA kernel. YOLOv5
training: ``run_train`` (seeded host augmentation, pinned uint8 uploads,
the packed train head and the v6.1 loss, AdamW with warmup and cosine, EMA,
checkpoints with resume, an in-loop ``run_eval``), and ``python -m
heltondetection_tpu_torch.cli --mode train|eval``. FasterRCNN inference
(ResNet or any registry backbone → FPN or PAFPNv8 → RPN proposals, whose
per-level NMS and final NMS run the ``nms_mask`` kernel → RoIAlign or
RoIPool → coupled or decoupled box head) through ``faster_rcnn_infer``,
``run_eval``, ``load_detector`` and ``BatchingDetector``, and its training
(``faster_rcnn_loss``, whose assigners run the ``iou_matrix`` kernel, and
``make_rcnn_train_step``) through ``run_train``. For both families,
``run_test`` with its heat-map panels, the eval artifacts (the COCO results
JSON, the per-class table, the confusion matrix and curve PNGs, the FLOPs
count, a C++ matcher) and ``engine.export`` (``torch.export`` to ``.pt2``:
the kernels are ``torch.library`` custom ops, ``kernels/ops.py``, so a
loaded program needs this package importable). W8A8 int8 serving for both
families (``ops/quant.py``: calibration and the quant trees, run on a copy
of the model; the int8 product ``ops/int8_conv.py`` on ``torch._int_mm``)
through ``eval.int8`` and ``test.int8``; the device letterbox
(``ops/letterbox.py``) and the Ultralytics state-dict loader
(``utils/torch_convert.py``). Data parallelism (``parallel/mesh.py``, on
``torch.distributed``): ``run_train`` under ``torchrun`` trains both
families over processes and cards, and one process evaluates and serves
over every local card; the reference's spatial sharding is not ported.

Entry points run on CUDA unless the caller passes ``device="cpu"``; without
CUDA they raise (see :func:`heltondetection_tpu_torch.device.resolve_device`).
"""

__version__ = "0.1.0"

# name → module that defines it; resolved on first access, so importing
# the package pulls in no model code
_EXPORTS = {
    "load_detector": "engine.runner",
    "BatchingDetector": "engine.serve",
    "serve_http": "engine.serve",
    "build_yolov5": "models.yolov5",
    "faster_rcnn_infer": "models.faster_rcnn",
    "make_packed_serve_step": "engine.evaluator",
    "Detector": "engine.infer",
    "Evaluator": "engine.evaluator",
    "forward_for_eval": "engine.runner",
    "run_train": "engine.runner",
    "run_eval": "engine.runner",
    "resolve_device": "device",
}
__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib
        module = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
