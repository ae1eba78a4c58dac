"""The three CUDA kernels as ``torch.library`` custom ops, so that
``torch.export`` (and any later graph capture) can trace a path through
them:

* ``torch.ops.heltondetection.nms_fixpoint(boxes (B, N, 4) f32, iou_thres)
  → keep (B, N) bool``;
* ``torch.ops.heltondetection.nms_mask(boxes, iou_thres) → keep (B, N)
  bool``;
* ``torch.ops.heltondetection.iou_matrix(boxes1 (N, 4) f32, boxes2 (M, 4)
  f32) → (N, M) f32``.

On CUDA tensors each op is its ctypes wrapper in :mod:`.nms` or
:mod:`.iou`, which launches the kernel (and adds one to its
``launch_counts`` entry) or raises; on CPU tensors it is the kernel's plain
PyTorch version (``ops.nms.nms_mask_fixpoint``, ``ops.nms.nms_mask_seq``,
``ops.boxes.box_iou_matrix``), which a trace could not follow (an N-step
loop, a data-dependent break) and so sits behind the op too. Each op's
fake gives the output's shape and dtype. Padding, the route by N and the
``*_max_n`` lookups stay with the callers (``ops/nms.py``,
``ops/boxes.py``), outside the ops.

Importing this module registers the ops; it builds nothing. A program
saved by ``torch.export`` that holds these ops loads only in a process
that has imported it (``engine.export.load_serving_fn`` does).
"""

from __future__ import annotations

import torch

from heltondetection_tpu_torch.kernels import iou as iou_kernel
from heltondetection_tpu_torch.kernels import nms as nms_kernel

NAMESPACE = "heltondetection"


def _keep_like(boxes: torch.Tensor) -> torch.Tensor:
    return boxes.new_empty(boxes.shape[:-1], dtype=torch.bool)


@torch.library.custom_op(f"{NAMESPACE}::nms_fixpoint", mutates_args=(),
                         device_types="cuda")
def nms_fixpoint(boxes: torch.Tensor, iou_thres: float) -> torch.Tensor:
    """Kernel ``nms_fixpoint`` (B1): the greedy keep mask of score-sorted,
    class-offset boxes, N a multiple of 32 that fits its shared memory."""
    return nms_kernel.nms_fixpoint(boxes, iou_thres)


@nms_fixpoint.register_kernel("cpu")
def _nms_fixpoint_cpu(boxes, iou_thres):
    from heltondetection_tpu_torch.ops.nms import nms_mask_fixpoint
    return nms_mask_fixpoint(boxes, iou_thres)


@nms_fixpoint.register_fake
def _nms_fixpoint_fake(boxes, iou_thres):
    return _keep_like(boxes)


@torch.library.custom_op(f"{NAMESPACE}::nms_mask", mutates_args=(),
                         device_types="cuda")
def nms_mask(boxes: torch.Tensor, iou_thres: float) -> torch.Tensor:
    """Kernel ``nms_mask`` (B2): the same mask through a global bitmask and
    a greedy row scan, N a multiple of 64."""
    return nms_kernel.nms_mask(boxes, iou_thres)


@nms_mask.register_kernel("cpu")
def _nms_mask_cpu(boxes, iou_thres):
    from heltondetection_tpu_torch.ops.nms import nms_mask_seq
    return nms_mask_seq(boxes, iou_thres)


@nms_mask.register_fake
def _nms_mask_fake(boxes, iou_thres):
    return _keep_like(boxes)


@torch.library.custom_op(f"{NAMESPACE}::iou_matrix", mutates_args=(),
                         device_types="cuda")
def iou_matrix(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Kernel ``iou_matrix`` (B3): pairwise IoU of xyxy boxes."""
    return iou_kernel.iou_matrix(boxes1, boxes2)


@iou_matrix.register_kernel("cpu")
def _iou_matrix_cpu(boxes1, boxes2):
    from heltondetection_tpu_torch.ops.boxes import box_iou_matrix
    return box_iou_matrix(boxes1, boxes2)


@iou_matrix.register_fake
def _iou_matrix_fake(boxes1, boxes2):
    return boxes1.new_empty((boxes1.shape[0], boxes2.shape[0]),
                            dtype=torch.float32)
