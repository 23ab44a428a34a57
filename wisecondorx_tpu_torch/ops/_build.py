"""Build and load the port's CUDA kernels (``wisecondorx_tpu_torch/csrc``).

The ``.cu`` sources are compiled on first use with ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface, which is
loaded with ``ctypes`` (no PyTorch headers: a build takes seconds, not
minutes).  The library lands in ``build/wcx_torch_kernels/`` beside the
package, named by a hash of the sources and flags, so an edited source
rebuilds and an unchanged one is reused.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "wcx_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
#: nvcc's output of the build this process made (ptxas register and
#: shared-memory report), or "" when the library was already built.
build_log = ""


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError(
            "nvcc not found: set CUDA_HOME or put nvcc on PATH to build "
            "the CUDA kernels"
        )
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libwcx_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless this exact build exists; returns the
    library's path.  Raises on a compiler error with nvcc's output."""
    global build_log
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = [str(s) for s in _sources() if s.suffix == ".cu"]
    with tempfile.NamedTemporaryFile(
        dir=BUILD_DIR, suffix=".so", delete=False
    ) as tmp:
        tmp_path = tmp.name
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp_path, *cu],
        capture_output=True, text=True,
    )
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp_path)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp_path, out)  # atomic: a concurrent loader never sees half a file
    return out


def load() -> ctypes.CDLL:
    """Build if needed and load the kernel library (once per process)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.wcx_knn_bucket.argtypes = [
                p, p, p, p, p, i, p, p, p, i, i, i, f, i, p, p, p, p,
            ]
            lib.wcx_knn_bucket.restype = i
            lib.wcx_knn_topk.argtypes = [p, p, p, i, i, i, i, p, p, p, p]
            lib.wcx_knn_topk.restype = i
            for name in ("wcx_knn_bucket_depth", "wcx_knn_bucket_col_tile",
                         "wcx_knn_bucket_k_chunk"):
                getattr(lib, name).argtypes = []
                getattr(lib, name).restype = i
            _lib = lib
        return _lib
