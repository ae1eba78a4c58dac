"""Native (C++) host code of the port, built on first use with g++;
counterpart of heltondetection_tpu/native/__init__.py.

``cocoeval_core.cpp`` is COCOeval's greedy detection matching, which
``utils/cocoeval.py:DetEval`` hands to it when it builds. It is compiled
into ``_build/libcocoeval-<hash>.so`` beside the CUDA kernels' libraries
(the name carries the source's hash, so an edited source builds anew) and
bound with ctypes. Where there is no g++, or the build fails, DetEval runs
its numpy matcher, which gives the same answers (the tests hold the two to
each other).

``loader_core.cpp`` is the data loader's pixel pipeline (libjpeg decode,
letterbox, mosaic-4, affine warp, HSV jitter, flip) and its persistent
batch thread pool, on OpenCV: ``_build/libloader-<hash>.so``, its plan
struct mirrored by :class:`HdPlan` (``data/native_loader.py`` builds the
plans). It needs the OpenCV (core, imgproc) and libjpeg development files;
where they or g++ are missing the build fails, :func:`get_loader_lib`
returns None and :func:`loader_build_error` says why, and the runner takes
the Python pipelines. Both are host code, not device paths, and nothing
builds at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

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


# -- the data loader's core --------------------------------------------------

_LDR_SRC = Path(__file__).resolve().parent / "loader_core.cpp"
_LDR_LOCK = threading.Lock()
_LDR_LIB: Optional[ctypes.CDLL] = None
_LDR_TRIED = False
_LDR_ERROR: Optional[str] = None


class HdPlan(ctypes.Structure):
    """Mirror of loader_core.cpp's ``hd_plan``: one sample's render plan."""
    _fields_ = [
        ("src", ctypes.c_void_p * 4),
        ("sh", ctypes.c_int * 4),
        ("sw", ctypes.c_int * 4),
        ("jpeg", ctypes.c_void_p * 4),
        ("jlen", ctypes.c_longlong * 4),
        ("n_tiles", ctypes.c_int),
        ("mode", ctypes.c_int),
        ("S", ctypes.c_int),
        ("xc", ctypes.c_int),
        ("yc", ctypes.c_int),
        ("do_affine", ctypes.c_int),
        ("m", ctypes.c_double * 6),
        ("do_hsv", ctypes.c_int),
        ("r0", ctypes.c_double),
        ("r1", ctypes.c_double),
        ("r2", ctypes.c_double),
        ("do_flip", ctypes.c_int),
        ("pad_value", ctypes.c_int),
        ("out", ctypes.c_void_p),
        ("status", ctypes.c_int),
    ]


def _pkg_config(*args: str) -> Optional[List[str]]:
    """``pkg-config <args> opencv4`` split into flags; None where pkg-config
    is missing or does not know opencv4."""
    try:
        r = subprocess.run(["pkg-config", *args, "opencv4"],
                           capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return r.stdout.split() if r.returncode == 0 else None


def loader_cflags() -> List[str]:
    """OpenCV's include flags: pkg-config's where it knows opencv4, else
    the Debian layout (``/usr/include/opencv4``)."""
    return _pkg_config("--cflags") or ["-I/usr/include/opencv4"]


def loader_build_command(out: str) -> List[str]:
    """The g++ command that builds the loader core into ``out``, with
    :func:`loader_cflags` and pkg-config's library directories."""
    ldirs = _pkg_config("--libs-only-L") or []
    return ["g++", "-O3", "-shared", "-fPIC", *loader_cflags(),
            str(_LDR_SRC), *ldirs, "-lopencv_core", "-lopencv_imgproc",
            "-ljpeg", "-pthread", "-o", out]


def loader_library_path() -> Path:
    """``_build/libloader-<hash>.so``; the hash covers the source and the
    build command, so an edited source or another OpenCV layout builds
    anew."""
    digest = hashlib.sha256(_LDR_SRC.read_bytes())
    digest.update(" ".join(loader_build_command("")).encode())
    return BUILD_DIR / f"libloader-{digest.hexdigest()[:12]}.so"


def _build_loader() -> Path:
    """Compile the loader core unless it is built, under a temporary name
    renamed into place (see :func:`_build`). Raises RuntimeError with the
    compiler's messages when it fails."""
    out = loader_library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        r = subprocess.run(loader_build_command(str(tmp)),
                           capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ did not run: {e}") from e
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({r.returncode}): "
                           f"{r.stderr.strip() or r.stdout.strip()}")
    os.replace(tmp, out)
    return out


def get_loader_lib() -> Optional[ctypes.CDLL]:
    """The loader core's library, built and loaded once per process; None
    where it cannot be built (:func:`loader_build_error` says why)."""
    global _LDR_LIB, _LDR_TRIED, _LDR_ERROR
    with _LDR_LOCK:
        if _LDR_TRIED:
            return _LDR_LIB
        _LDR_TRIED = True
        try:
            lib = ctypes.CDLL(str(_build_loader()))
        except (RuntimeError, OSError) as e:
            _LDR_ERROR = str(e)
            return None
        u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        c_int_p = ctypes.POINTER(ctypes.c_int)
        lib.hd_pool_create.argtypes = [ctypes.c_int]
        lib.hd_pool_create.restype = ctypes.c_void_p
        lib.hd_pool_destroy.argtypes = [ctypes.c_void_p]
        lib.hd_pool_destroy.restype = None
        lib.hd_pool_run.argtypes = [ctypes.c_void_p, ctypes.POINTER(HdPlan),
                                    ctypes.c_int]
        lib.hd_pool_run.restype = None
        lib.hd_run_plan.argtypes = [ctypes.POINTER(HdPlan)]
        lib.hd_run_plan.restype = None
        lib.hd_letterbox.argtypes = [u8, ctypes.c_int, ctypes.c_int, u8,
                                     ctypes.c_int, ctypes.c_int]
        lib.hd_letterbox.restype = None
        lib.hd_hsv_jitter.argtypes = [u8, ctypes.c_int, ctypes.c_int,
                                      ctypes.c_double, ctypes.c_double,
                                      ctypes.c_double]
        lib.hd_hsv_jitter.restype = None
        lib.hd_flip_h.argtypes = [u8, ctypes.c_int, ctypes.c_int]
        lib.hd_flip_h.restype = None
        lib.hd_jpeg_dims.argtypes = [u8, ctypes.c_longlong, c_int_p, c_int_p]
        lib.hd_jpeg_dims.restype = ctypes.c_int
        lib.hd_decode_jpeg.argtypes = [u8, ctypes.c_longlong, u8,
                                       ctypes.c_longlong, c_int_p, c_int_p]
        lib.hd_decode_jpeg.restype = ctypes.c_int
        _LDR_LIB = lib
        return _LDR_LIB


def loader_build_error() -> Optional[str]:
    """Why the loader core did not build (the compiler's messages), or None
    when it built or was not tried yet."""
    return _LDR_ERROR
