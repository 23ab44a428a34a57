"""Build and load the port's CUDA kernels (``wisecondorx_tpu_torch/csrc``).

The ``.cu`` sources are compiled on first use with ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface, which is
loaded with ``ctypes`` (no PyTorch headers: a build takes seconds, not
minutes).  Each source gets its own ``nvcc``, all started together, and
one more links the objects.  The library lands in
``build/wcx_torch_kernels/`` beside the package, named by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one is
reused.  Nothing here runs at import.
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
#: nvcc's output of the build this process made, by source file name (the
#: ptxas register, shared-memory and spill report of its kernels); empty
#: when the library was already built.
build_logs: dict[str, str] = {}


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
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        cu = [s for s in _sources() if s.suffix == ".cu"]
        objs = [os.path.join(tmp, s.stem + ".o") for s in cu]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", o, str(s)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for s, o in zip(cu, objs)
        ]
        failed = []
        for s, p in zip(cu, procs):
            build_logs[s.name] = p.communicate()[0]
            if p.returncode != 0:
                failed.append(f"{s.name} ({p.returncode}):\n{build_logs[s.name]}")
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        lib = os.path.join(tmp, "lib.so")
        link = subprocess.run(
            [nvcc, "-shared", "-o", lib, *objs], capture_output=True, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({link.returncode}):\n{link.stdout}{link.stderr}"
            )
        os.replace(lib, out)  # atomic: a concurrent loader never sees half a file
    return out


def check_tensor(t, name: str, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``: what a kernel's C entry point takes."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def load() -> ctypes.CDLL:
    """Build if needed and load the kernel library (once per process)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            u = ctypes.c_uint32
            lib.wcx_knn_bucket.argtypes = [
                p, p, p, p, p, i, p, p, p, i, i, i, f, i, p, p, p, p,
            ]
            lib.wcx_knn_bucket.restype = i
            lib.wcx_knn_topk.argtypes = [p, p, p, i, i, i, i, p, p, p, p]
            lib.wcx_knn_topk.restype = i
            lib.wcx_cbs_arc_max.argtypes = [p, p, p, i, i, p, i, i, i, i, p, p, p, p]
            lib.wcx_cbs_arc_max.restype = i
            lib.wcx_cbs_arc_argmax.argtypes = [
                p, p, p, i, i, p, i, i, i, p, p, p, p, p, p, p,
            ]
            lib.wcx_cbs_arc_argmax.restype = i
            lib.wcx_cbs_keys.argtypes = [u, u, p, p, p, p, p, i, i, p, p]
            lib.wcx_cbs_keys.restype = i
            for name in ("wcx_knn_bucket_depth", "wcx_knn_bucket_col_tile",
                         "wcx_knn_bucket_k_chunk", "wcx_knn_bucket_resident_s_pad",
                         "wcx_knn_topk_pool_max", "wcx_cbs_arc_stage_bytes"):
                getattr(lib, name).argtypes = []
                getattr(lib, name).restype = i
            _lib = lib
        return _lib
