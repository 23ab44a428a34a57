"""Logging and per-stage timing for the port.

Counterpart of wisecondorx_tpu/utils/log.py with the same log format and
``[timing]`` lines.  Each stage also runs under
``torch.profiler.record_function``, so its ops are attributable inside a
``torch.profiler`` trace; the JAX package's profiler hooks are not used.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time

import torch

from wisecondorx_tpu.utils.log import setup_logging  # noqa: F401  (re-export)

_STAGE_TIMES: dict[str, float] = {}
_TIMES_LOCK = threading.Lock()


@contextlib.contextmanager
def stage_timer(name: str):
    """Log and record a stage's host wall-clock seconds."""
    start = time.perf_counter()
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        elapsed = time.perf_counter() - start
        with _TIMES_LOCK:
            _STAGE_TIMES[name] = _STAGE_TIMES.get(name, 0.0) + elapsed
        logging.info("[timing] %s: %.3fs", name, elapsed)


def stage_times() -> dict[str, float]:
    """Accumulated per-stage wall-clock seconds since the last reset."""
    with _TIMES_LOCK:
        return dict(_STAGE_TIMES)


def reset_stage_times() -> None:
    with _TIMES_LOCK:
        _STAGE_TIMES.clear()
