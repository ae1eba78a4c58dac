"""ctypes wrappers of the greedy NMS keep-mask kernels on the card:

* ``nms_fixpoint`` (``csrc/nms_fixpoint.cu``), counterpart of
  ``nms_mask_fixpoint_pallas`` in heltondetection_tpu/ops/nms.py; plain
  PyTorch version ``ops.nms.nms_mask_fixpoint``.
* ``nms_mask`` (``csrc/nms_mask.cu``), counterpart of ``nms_mask_pallas``;
  plain PyTorch version ``ops.nms.nms_mask_seq``.
"""

from __future__ import annotations

import ctypes

import torch

from heltondetection_tpu_torch.kernels import build, launch_counts

_libs = {}


def _load(name: str) -> ctypes.CDLL:
    """Load ``csrc/<name>.cu``'s library (building it first if needed) and
    declare its C interface."""
    if name in _libs:
        return _libs[name]
    lib = ctypes.CDLL(str(build.library(name)))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    launch = getattr(lib, f"{name}_launch")
    if name == "nms_fixpoint":
        launch.argtypes = [ptr, ptr, i32, i32, ctypes.c_float, ptr]
    else:
        launch.argtypes = [ptr, ptr, ptr, i32, i32, ctypes.c_float, ptr]
    launch.restype = i32
    getattr(lib, f"{name}_smem_bytes").argtypes = [i32]
    getattr(lib, f"{name}_smem_bytes").restype = ctypes.c_longlong
    getattr(lib, f"{name}_smem_limit").argtypes = [i32]
    getattr(lib, f"{name}_smem_limit").restype = ctypes.c_longlong
    getattr(lib, f"{name}_error_string").argtypes = [i32]
    getattr(lib, f"{name}_error_string").restype = ctypes.c_char_p
    _libs[name] = lib
    return lib


def _check_boxes(name: str, boxes: torch.Tensor, multiple: int) -> None:
    if not boxes.is_cuda:
        raise ValueError(f"{name} needs a CUDA tensor, got {boxes.device}")
    if boxes.dtype != torch.float32:
        raise ValueError(f"{name} needs float32 boxes, got {boxes.dtype}")
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"{name} needs (B, N, 4) boxes, "
                         f"got {tuple(boxes.shape)}")
    if not boxes.is_contiguous() or boxes.data_ptr() % 16:
        raise ValueError(f"{name} needs contiguous 16-byte aligned boxes")
    b, n, _ = boxes.shape
    if b == 0 or n == 0 or n % multiple:
        raise ValueError(f"{name} needs B > 0 and N a positive multiple of "
                         f"{multiple}, got B={b} N={n}")


def _check_smem(name: str, lib: ctypes.CDLL, n: int, dev) -> None:
    need = getattr(lib, f"{name}_smem_bytes")(n)
    limit = getattr(lib, f"{name}_smem_limit")(dev.index)
    if need > limit:
        raise ValueError(f"{name} at N={n} needs {need} bytes of shared "
                         f"memory; the device allows {limit}")


def _raise_on(name: str, lib: ctypes.CDLL, err: int) -> None:
    if err:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({err})")


def nms_fixpoint(boxes: torch.Tensor, iou_thres: float) -> torch.Tensor:
    """Keep mask (B, N) bool of score-sorted, class-offset boxes (B, N, 4)
    f32 on a CUDA device. N must be a positive multiple of 32 and the
    block's bitmask must fit in shared memory (N ≤ 1280 on an H100).
    Anything else raises; there is no other variant."""
    _check_boxes("nms_fixpoint", boxes, 32)
    b, n, _ = boxes.shape
    lib = _load("nms_fixpoint")
    dev = boxes.device
    with torch.cuda.device(dev):
        _check_smem("nms_fixpoint", lib, n, dev)
        keep = torch.empty((b, n), dtype=torch.bool, device=dev)
        err = lib.nms_fixpoint_launch(
            boxes.data_ptr(), keep.data_ptr(), b, n, float(iou_thres),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on("nms_fixpoint", lib, err)
    launch_counts["nms_fixpoint"] += 1
    return keep


def nms_mask(boxes: torch.Tensor, iou_thres: float) -> torch.Tensor:
    """Keep mask (B, N) bool of score-sorted, class-offset boxes (B, N, 4)
    f32 on a CUDA device, N a positive multiple of 64, any size the
    (B, N, N/64) uint64 scratch bitmask allows (N²/8 bytes per image).
    Anything else raises; there is no other variant."""
    _check_boxes("nms_mask", boxes, 64)
    b, n, _ = boxes.shape
    lib = _load("nms_mask")
    dev = boxes.device
    with torch.cuda.device(dev):
        _check_smem("nms_mask", lib, n, dev)
        scratch = torch.empty((b, n, n // 64), dtype=torch.int64, device=dev)
        keep = torch.empty((b, n), dtype=torch.bool, device=dev)
        err = lib.nms_mask_launch(
            boxes.data_ptr(), scratch.data_ptr(), keep.data_ptr(), b, n,
            float(iou_thres), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on("nms_mask", lib, err)
    launch_counts["nms_mask"] += 1
    return keep
