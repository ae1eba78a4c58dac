"""ctypes wrapper of ``csrc/nms_fixpoint.cu``: the exact greedy NMS keep mask
on the card. Counterpart of ``nms_mask_fixpoint_pallas`` in
heltondetection_tpu/ops/nms.py; its plain PyTorch version is
``ops.nms.nms_mask_fixpoint``."""

from __future__ import annotations

import ctypes

import torch

from heltondetection_tpu_torch.kernels import build, launch_counts

_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build.library("nms_fixpoint")))
        lib.nms_fixpoint_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_void_p]
        lib.nms_fixpoint_launch.restype = ctypes.c_int
        lib.nms_fixpoint_smem_bytes.argtypes = [ctypes.c_int]
        lib.nms_fixpoint_smem_bytes.restype = ctypes.c_longlong
        lib.nms_fixpoint_smem_limit.argtypes = [ctypes.c_int]
        lib.nms_fixpoint_smem_limit.restype = ctypes.c_longlong
        lib.nms_fixpoint_error_string.argtypes = [ctypes.c_int]
        lib.nms_fixpoint_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def nms_fixpoint(boxes: torch.Tensor, iou_thres: float) -> torch.Tensor:
    """Keep mask (B, N) bool of score-sorted, class-offset boxes (B, N, 4)
    f32 on a CUDA device. N must be a positive multiple of 32 and the
    block's bitmask must fit in shared memory (N ≤ 1280 on an H100).
    Anything else raises; there is no other variant."""
    if not boxes.is_cuda:
        raise ValueError(f"nms_fixpoint needs a CUDA tensor, got {boxes.device}")
    if boxes.dtype != torch.float32:
        raise ValueError(f"nms_fixpoint needs float32 boxes, got {boxes.dtype}")
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"nms_fixpoint needs (B, N, 4) boxes, "
                         f"got {tuple(boxes.shape)}")
    if not boxes.is_contiguous():
        raise ValueError("nms_fixpoint needs contiguous boxes")
    b, n, _ = boxes.shape
    if b == 0 or n == 0 or n % 32:
        raise ValueError(f"nms_fixpoint needs B > 0 and N a positive "
                         f"multiple of 32, got B={b} N={n}")
    lib = _load()
    dev = boxes.device
    with torch.cuda.device(dev):
        need = lib.nms_fixpoint_smem_bytes(n)
        limit = lib.nms_fixpoint_smem_limit(dev.index)
        if need > limit:
            raise ValueError(f"nms_fixpoint at N={n} needs {need} bytes of "
                             f"shared memory; the device allows {limit}")
        keep = torch.empty((b, n), dtype=torch.bool, device=dev)
        err = lib.nms_fixpoint_launch(
            boxes.data_ptr(), keep.data_ptr(), b, n, float(iou_thres),
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        msg = lib.nms_fixpoint_error_string(err).decode()
        raise RuntimeError(f"nms_fixpoint launch failed: {msg} ({err})")
    launch_counts["nms_fixpoint"] += 1
    return keep
