"""Build the CUDA sources of ``csrc/`` into shared libraries with nvcc.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
into ``_build/<name>-<hash>.so`` (route (b): nvcc by hand, loaded with
ctypes; seconds per source, against minutes for an extension that includes
PyTorch's headers). The hash covers the source, the ``csrc/`` headers it
includes (``#include "..."``, followed through headers too) and the flags,
so an edited source or header builds anew. Nothing builds at import time:
a library is built the first time a wrapper asks for it, or all at once,
in parallel, through :func:`build_all`.
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# --fmad=false: no multiply-add contraction, so kernels round every
# operation as their plain PyTorch versions do
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        path = Path(CUDA_HOME) / "bin" / "nvcc"
        if path.exists():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "heltondetection_tpu_torch need the CUDA toolkit")
    return found


_LOCAL_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def sources(name: str) -> List[Path]:
    """``csrc/<name>.cu`` and every ``csrc/`` header it includes, directly
    or through another header, in the order first reached."""
    found: List[Path] = []
    todo = [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in found:
            continue
        found.append(path)
        todo += [CSRC / inc
                 for inc in _LOCAL_INCLUDE.findall(path.read_text())]
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for path in sources(name):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_all(names: Iterable[str]) -> Dict[str, Tuple[Path, float, str]]:
    """Build every named source that is not built yet, all nvcc processes at
    once. Returns ``{name: (library, seconds, ptxas report)}``; a library
    that was already built reports 0 seconds and an empty report."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    out: Dict[str, Tuple[Path, float, str]] = {}
    procs = []
    for name in names:
        lib = library_path(name)
        if lib.exists():
            out[name] = (lib, 0.0, "")
            continue
        # unique temporary name, renamed into place when done, so
        # concurrent builds never load a half-written library
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, lib, tmp, time.perf_counter(),
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, lib, tmp, t0, proc in procs:
        report, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{report}")
            continue
        os.replace(tmp, lib)
        out[name] = (lib, time.perf_counter() - t0, report)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


def library(name: str) -> Path:
    """Path of the built library for ``csrc/<name>.cu``, building it first if
    needed."""
    return build_all([name])[name][0]
