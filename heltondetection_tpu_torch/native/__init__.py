"""Native (C++) host code of the port, built on first use with g++;
counterpart of the matcher half of heltondetection_tpu/native/__init__.py.

``cocoeval_core.cpp`` is COCOeval's greedy detection matching, which
``utils/cocoeval.py:DetEval`` hands to it when it builds. It is compiled
into ``_build/libcocoeval-<hash>.so`` beside the CUDA kernels' libraries
(the name carries the source's hash, so an edited source builds anew) and
bound with ctypes. Where there is no g++, or the build fails, DetEval runs
its numpy matcher, which gives the same answers (the tests hold the two to
each other). This is host code, not a device path. The reference's native
data loader (``loader_core.cpp``) is not ported (ROADMAP A6).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from heltondetection_tpu_torch.kernels.build import BUILD_DIR

_SRC = Path(__file__).resolve().parent / "cocoeval_core.cpp"

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
# how many (image, category, area range) matchings ran in C++; a caller may
# reset it to show that a path went through the native matcher
match_calls = 0


def library_path() -> Path:
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libcocoeval-{tag}.so"


def _build() -> Optional[Path]:
    """Compile the matcher unless it is built; the library is written under
    a temporary name and renamed into place, so a killed or concurrent
    build never leaves a truncated library at the final name. None when
    g++ is missing or fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", str(_SRC), "-o",
                        str(tmp)], check=True, capture_output=True,
                       timeout=120)
        os.replace(tmp, out)
        return out
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None


def get_cocoeval_lib() -> Optional[ctypes.CDLL]:
    """The matcher's library, built and loaded once per process; None where
    it cannot be built."""
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        lib.match_dets.argtypes = [ctypes.c_int, f64, ctypes.c_int,
                                   ctypes.c_int, f64, i64, i64, i64, i64]
        lib.match_dets.restype = None
        _LIB = lib
        return _LIB


def match_dets_native(iou_thrs: np.ndarray, ious: np.ndarray,
                      g_ig: np.ndarray, g_crowd: np.ndarray
                      ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Greedy matching in C++: (dtm (T, D), dt_ig (T, D)) int64, or None
    when the library is not available. ``ious`` (D, G) has the gts sorted
    non-ignored first, as ``g_ig`` and ``g_crowd`` are."""
    global match_calls
    lib = get_cocoeval_lib()
    if lib is None:
        return None
    t = len(iou_thrs)
    d, g = ious.shape
    dtm = np.empty((t, d), np.int64)
    dt_ig = np.empty((t, d), np.int64)
    lib.match_dets(t, np.ascontiguousarray(iou_thrs, np.float64), d, g,
                   np.ascontiguousarray(ious, np.float64),
                   np.ascontiguousarray(g_ig, np.int64),
                   np.ascontiguousarray(g_crowd, np.int64), dtm, dt_ig)
    match_calls += 1
    return dtm, dt_ig
