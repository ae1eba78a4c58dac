"""ctypes wrapper of ``csrc/iou_matrix.cu``: the pairwise IoU matrix on the
card. Counterpart of ``iou_matrix_pallas`` in
heltondetection_tpu/ops/boxes.py; its plain PyTorch version is
``ops.boxes.box_iou_matrix``."""

from __future__ import annotations

import ctypes

import torch

from heltondetection_tpu_torch.kernels import build, launch_counts

_lib = None
# The kernel's grid is one-dimensional over 16 x 128 tiles, so neither N
# nor M has a limit of its own short of the C int they are passed as
# (ctypes does not check the range itself).
_MAX_BOXES = 2 ** 31 - 1


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build.library("iou_matrix")))
        lib.iou_matrix_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.iou_matrix_launch.restype = ctypes.c_int
        lib.iou_matrix_error_string.argtypes = [ctypes.c_int]
        lib.iou_matrix_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(name: str, boxes: torch.Tensor) -> None:
    if not boxes.is_cuda:
        raise ValueError(f"iou_matrix needs CUDA tensors, {name} is on "
                         f"{boxes.device}")
    if boxes.dtype != torch.float32:
        raise ValueError(f"iou_matrix needs float32 boxes, {name} is "
                         f"{boxes.dtype}")
    if boxes.dim() != 2 or boxes.shape[1] != 4 or boxes.shape[0] == 0:
        raise ValueError(f"iou_matrix needs non-empty (N, 4) boxes, {name} "
                         f"is {tuple(boxes.shape)}")
    if not boxes.is_contiguous() or boxes.data_ptr() % 16:
        raise ValueError(f"iou_matrix needs contiguous 16-byte aligned "
                         f"boxes, {name} is not")


def iou_matrix(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """IoU (N, M) f32 of xyxy boxes (N, 4) × (M, 4) f32 on one CUDA device,
    any N ≥ 1 and M ≥ 1. Anything else raises. When M is a multiple of 4
    every output row starts 16-byte aligned and the kernel writes float4s;
    for any other M it writes single floats (see ``csrc/iou_matrix.cu``)."""
    _check("boxes1", boxes1)
    _check("boxes2", boxes2)
    if boxes1.device != boxes2.device:
        raise ValueError(f"iou_matrix needs one device, got {boxes1.device} "
                         f"and {boxes2.device}")
    n, m = boxes1.shape[0], boxes2.shape[0]
    if max(n, m) > _MAX_BOXES:
        raise ValueError(f"iou_matrix takes at most {_MAX_BOXES} boxes a "
                         f"side, got ({n}, {m})")
    vec = m % 4 == 0
    lib = _load()
    dev = boxes1.device
    with torch.cuda.device(dev):
        out = torch.empty((n, m), dtype=torch.float32, device=dev)
        if vec and out.data_ptr() % 16:
            raise RuntimeError("iou_matrix: the allocator returned an output "
                               "that is not 16-byte aligned")
        err = lib.iou_matrix_launch(
            boxes1.data_ptr(), boxes2.data_ptr(), out.data_ptr(), n, m,
            int(vec), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        msg = lib.iou_matrix_error_string(err).decode()
        raise RuntimeError(f"iou_matrix launch failed: {msg} ({err})")
    launch_counts["iou_matrix"] += 1
    return out
