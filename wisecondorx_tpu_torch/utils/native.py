"""Build the port's host C++ (``native/*.cpp``) with g++.

A library is built on first use into ``build/wcx_torch_native/`` beside the
package, named by a hash of its sources, so a changed source builds anew
and an unchanged one is built once per checkout.  Callers load it with
``ctypes.CDLL`` once per process, behind a lock of their own.
"""

from __future__ import annotations

import hashlib
import logging
import os
import subprocess
import tempfile
from pathlib import Path

NATIVE_DIR = Path(__file__).resolve().parents[1] / "native"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "wcx_torch_native"


def build_library(stem: str, sources, libs=()) -> Path:
    """The shared library ``lib<stem>_<hash>.so`` built from ``sources``
    (paths under ``native/``) and linked with ``libs``; built now with
    ``g++ -O3 -std=c++17`` (``$CXX`` if set) unless it exists.  Raises
    ``subprocess.CalledProcessError`` if g++ fails, ``OSError`` if it is
    missing."""
    srcs = [NATIVE_DIR / s for s in sources]
    digest = hashlib.sha256(b"".join(s.read_bytes() for s in srcs))
    so = BUILD_DIR / f"lib{stem}_{digest.hexdigest()[:16]}.so"
    if so.exists():
        return so
    logging.info("Building native %s ...", so.name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.NamedTemporaryFile(
        dir=BUILD_DIR, suffix=".so", delete=False
    ) as tmp:
        tmp_path = tmp.name
    try:
        subprocess.check_call(
            [
                os.environ.get("CXX", "g++"),
                "-O3", "-std=c++17", "-fPIC", "-shared", "-Wall",
                "-o", tmp_path, *map(str, srcs), *libs,
            ]
        )
    except BaseException:
        os.unlink(tmp_path)
        raise
    # Atomic: a concurrent loader in another process never sees half a file.
    os.replace(tmp_path, so)
    return so
