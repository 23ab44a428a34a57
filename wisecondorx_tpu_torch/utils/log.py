"""Logging and per-stage timing for the port.

Counterpart of wisecondorx_tpu/utils/log.py with the same log format (the
reference tool's, main.py:492-496) and ``[timing]`` lines.  Each stage also
runs under ``torch.profiler.record_function``, so its ops are attributable
inside a ``torch.profiler`` trace.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time

import torch

LOG_FORMAT = "[%(levelname)s - %(asctime)s]: %(message)s"
DATE_FORMAT = "%Y-%m-%d %H:%M:%S"


def setup_logging(loglevel: str = "INFO") -> None:
    logging.basicConfig(
        format=LOG_FORMAT,
        datefmt=DATE_FORMAT,
        level=getattr(logging, loglevel.upper(), logging.INFO),
    )


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
