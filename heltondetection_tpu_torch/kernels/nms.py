"""ctypes wrappers of the greedy NMS keep-mask kernels on the card:

* ``nms_fixpoint`` (``csrc/nms_fixpoint.cu``), counterpart of
  ``nms_mask_fixpoint_pallas`` in heltondetection_tpu/ops/nms.py; plain
  PyTorch version ``ops.nms.nms_mask_fixpoint``.
* ``nms_mask`` (``csrc/nms_mask.cu``), counterpart of ``nms_mask_pallas``;
  plain PyTorch version ``ops.nms.nms_mask_seq``.

Both share the register-resident greedy scan of ``csrc/nms_scan.cuh``.
What a kernel needs of the device (shared memory, cluster residency, launch
attributes) is checked and set once per device and N, not per launch.
"""

from __future__ import annotations

import ctypes
import math

import torch

from heltondetection_tpu_torch.kernels import build, launch_counts

_libs = {}
# (kernel, device index, N) checked and prepared -> for nms_fixpoint, how
# many clusters the device holds at once
_ready = {}
_fixpoint_max_n = {}   # device index -> nms_fixpoint's largest N
_mask_max_n = {}       # device index -> nms_mask's largest N


def _load(name: str) -> ctypes.CDLL:
    """Load ``csrc/<name>.cu``'s library (building it first if needed) and
    declare its C interface."""
    if name in _libs:
        return _libs[name]
    lib = ctypes.CDLL(str(build.library(name)))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == "nms_fixpoint":
        lib.nms_fixpoint_launch.argtypes = [ptr, ptr, i32, i32, f32, ptr]
        lib.nms_fixpoint_build_launch.argtypes = [ptr, ptr, i32, i32, f32,
                                                  ptr]
        lib.nms_fixpoint_build_launch.restype = i32
        lib.nms_fixpoint_prepare.argtypes = [i32, i32]
        lib.nms_fixpoint_prepare.restype = i32
        lib.nms_fixpoint_smem_bytes.argtypes = [i32]
        lib.nms_fixpoint_smem_bytes.restype = ctypes.c_longlong
        lib.nms_fixpoint_smem_limit.argtypes = [i32]
        lib.nms_fixpoint_smem_limit.restype = ctypes.c_longlong
    else:
        lib.nms_mask_launch.argtypes = [ptr, ptr, ptr, i32, i32, f32, ptr]
        lib.nms_mask_max_n.argtypes = [i32]
        lib.nms_mask_max_n.restype = ctypes.c_longlong
    getattr(lib, f"{name}_launch").restype = i32
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


def _check_smem(lib: ctypes.CDLL, n: int, dev) -> None:
    """Each block of an image's cluster holds all N boxes and N/4 rows of
    the bitmask; raise unless that fits one block's shared memory."""
    need = lib.nms_fixpoint_smem_bytes(n)
    limit = lib.nms_fixpoint_smem_limit(dev.index)
    if need > limit:
        raise ValueError(f"nms_fixpoint at N={n} needs {need} bytes of "
                         f"shared memory per block; the device allows "
                         f"{limit}")


def _raise_on(name: str, lib: ctypes.CDLL, err: int) -> None:
    if err:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({err})")


def _prepare(name: str, lib: ctypes.CDLL, n: int, dev) -> None:
    """Check once per (device, N) that the kernel can run at N, and set its
    launch attributes; raise if it cannot."""
    key = (name, dev.index, n)
    if key in _ready:
        return
    clusters = None
    if name == "nms_fixpoint":
        _check_smem(lib, n, dev)
        clusters = lib.nms_fixpoint_prepare(dev.index, n)
        if clusters < 0:
            _raise_on(name, lib, -clusters)
        if clusters == 0:
            raise RuntimeError(f"nms_fixpoint at N={n}: the device cannot "
                               f"hold one cluster of its blocks at once")
    elif n > nms_mask_max_n(dev):
        raise ValueError(f"nms_mask takes N up to {nms_mask_max_n(dev)} on "
                         f"{dev}, got N={n}")
    _ready[key] = clusters


def nms_fixpoint_max_n(device) -> int:
    """Largest N (a multiple of 32) whose per-block share of the bitmask
    fits a block's shared memory on ``device`` (2400 on an H100); found
    once per device."""
    index = torch.device(device).index or 0
    if index not in _fixpoint_max_n:
        lib = _load("nms_fixpoint")
        limit = lib.nms_fixpoint_smem_limit(index)
        n = 32
        while lib.nms_fixpoint_smem_bytes(n + 32) <= limit:
            n += 32
        _fixpoint_max_n[index] = n
    return _fixpoint_max_n[index]


def nms_mask_max_n(device) -> int:
    """Largest N (a multiple of 64) that :func:`nms_mask` takes on
    ``device``: one image's (N, N) scratch bitmask, N²/8 bytes, must fit the
    device's memory (about 800,000 on an 80 GB H100), and its scan's N/8
    bytes of words a block's shared memory (about 1.8 million); found once
    per device. Whether a batch's bitmask can be allocated now is the
    allocator's to say."""
    index = torch.device(device).index or 0
    if index not in _mask_max_n:
        limit = int(_load("nms_mask").nms_mask_max_n(index))
        if limit < 0:
            _raise_on("nms_mask", _load("nms_mask"), -limit)
        mem = torch.cuda.get_device_properties(index).total_memory
        n = int(math.isqrt(mem * 8)) // 64 * 64
        _mask_max_n[index] = min(limit // 64 * 64, n)
    return _mask_max_n[index]


def nms_fixpoint_clusters(device, n: int) -> int:
    """How many images :func:`nms_fixpoint` runs at once at N on
    ``device`` (one cluster of four blocks each, in one GPC); a larger
    batch runs in waves."""
    dev = torch.device("cuda", torch.device(device).index or 0)
    with torch.cuda.device(dev):
        _prepare("nms_fixpoint", _load("nms_fixpoint"), n, dev)
    return _ready[("nms_fixpoint", dev.index, n)]


def nms_fixpoint(boxes: torch.Tensor, iou_thres: float) -> torch.Tensor:
    """Keep mask (B, N) bool of score-sorted, class-offset boxes (B, N, 4)
    f32 on a CUDA device, one cluster of four blocks per image. N must be a
    positive multiple of 32 and each block's quarter of the bitmask must
    fit its shared memory (N ≤ 2400 on an H100). Anything else raises;
    there is no other variant."""
    _check_boxes("nms_fixpoint", boxes, 32)
    b, n, _ = boxes.shape
    lib = _load("nms_fixpoint")
    dev = boxes.device
    with torch.cuda.device(dev):
        _prepare("nms_fixpoint", lib, n, dev)
        keep = torch.empty((b, n), dtype=torch.bool, device=dev)
        err = lib.nms_fixpoint_launch(
            boxes.data_ptr(), keep.data_ptr(), b, n, float(iou_thres),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on("nms_fixpoint", lib, err)
    launch_counts["nms_fixpoint"] += 1
    return keep


def nms_fixpoint_build(boxes: torch.Tensor, iou_thres: float) -> torch.Tensor:
    """The bitmask build of :func:`nms_fixpoint` alone, for timing the build
    and the scan apart: returns the number of bits set in each image's
    suppression matrix (B,) int32, and no keep mask. No path calls it, and
    it adds nothing to ``launch_counts``."""
    _check_boxes("nms_fixpoint", boxes, 32)
    b, n, _ = boxes.shape
    lib = _load("nms_fixpoint")
    dev = boxes.device
    with torch.cuda.device(dev):
        _prepare("nms_fixpoint", lib, n, dev)
        bits = torch.zeros((b,), dtype=torch.int32, device=dev)
        err = lib.nms_fixpoint_build_launch(
            boxes.data_ptr(), bits.data_ptr(), b, n, float(iou_thres),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on("nms_fixpoint", lib, err)
    return bits


def nms_mask(boxes: torch.Tensor, iou_thres: float) -> torch.Tensor:
    """Keep mask (B, N) bool of score-sorted, class-offset boxes (B, N, 4)
    f32 on a CUDA device, N a positive multiple of 64 up to
    :func:`nms_mask_max_n`, through a (B, N, N/64) uint64 scratch bitmask
    (N²/8 bytes per image). Up to N = 16384 the scan keeps its words in
    registers, above in shared memory; the mask is the same. Anything else
    raises; there is no other variant."""
    _check_boxes("nms_mask", boxes, 64)
    b, n, _ = boxes.shape
    lib = _load("nms_mask")
    dev = boxes.device
    with torch.cuda.device(dev):
        _prepare("nms_mask", lib, n, dev)
        scratch = torch.empty((b, n, n // 64), dtype=torch.int64, device=dev)
        keep = torch.empty((b, n), dtype=torch.bool, device=dev)
        err = lib.nms_mask_launch(
            boxes.data_ptr(), scratch.data_ptr(), keep.data_ptr(), b, n,
            float(iou_thres), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on("nms_mask", lib, err)
    launch_counts["nms_mask"] += 1
    return keep
