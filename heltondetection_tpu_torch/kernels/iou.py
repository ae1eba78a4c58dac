"""ctypes wrapper of ``csrc/iou_matrix.cu``: the pairwise IoU matrix on the
card. Counterpart of ``iou_matrix_pallas`` in
heltondetection_tpu/ops/boxes.py; its plain PyTorch version is
``ops.boxes.box_iou_matrix``."""

from __future__ import annotations

import ctypes

import torch

from heltondetection_tpu_torch.kernels import build, launch_counts

_lib = None
_MAX_ROWS = 65535 * 32      # grid.y limit times the tile's 32 rows


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build.library("iou_matrix")))
        lib.iou_matrix_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
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
    any N ≥ 1 (up to 2,097,120) and M ≥ 1. Anything else raises; there is
    no other variant."""
    _check("boxes1", boxes1)
    _check("boxes2", boxes2)
    if boxes1.device != boxes2.device:
        raise ValueError(f"iou_matrix needs one device, got {boxes1.device} "
                         f"and {boxes2.device}")
    n, m = boxes1.shape[0], boxes2.shape[0]
    if n > _MAX_ROWS:
        raise ValueError(f"iou_matrix takes at most {_MAX_ROWS} rows, "
                         f"got {n}")
    lib = _load()
    dev = boxes1.device
    with torch.cuda.device(dev):
        out = torch.empty((n, m), dtype=torch.float32, device=dev)
        err = lib.iou_matrix_launch(
            boxes1.data_ptr(), boxes2.data_ptr(), out.data_ptr(), n, m,
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        msg = lib.iou_matrix_error_string(err).decode()
        raise RuntimeError(f"iou_matrix launch failed: {msg} ({err})")
    launch_counts["iou_matrix"] += 1
    return out
