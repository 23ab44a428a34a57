"""Logging, per-stage timing and per-stage device traces for the port.

Counterpart of wisecondorx_tpu/utils/log.py with the same log format (the
reference tool's, main.py:492-496) and ``[timing]`` lines.  Each stage also
runs under ``torch.profiler.record_function``, so its ops are attributable
inside a ``torch.profiler`` trace.

Set ``WCX_PROFILE_DIR=/path`` to capture a device trace of every timed
stage: one TensorBoard-readable directory per stage name, each run of the
stage adding a ``<host>_<pid>_<n>.<ns>.pt.trace.json`` Chrome trace (read
it with TensorBoard's profiler plugin, ``chrome://tracing`` or Perfetto).
One trace is taken at a time: a stage nested in a traced stage, or
running on another thread while one is traced, keeps its time and its
range but writes no trace of its own.  While a stage is traced on a
machine with CUDA, it synchronises the visible devices before its range
and its profiler close, so the kernels it queued fall inside its trace
(its ``[timing]`` seconds then include that wait).
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import os
import socket
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
#: One profiler runs at a time; a stage that cannot take the lock without
#: waiting skips its trace (its wall-clock is still recorded).
_TRACE_LOCK = threading.Lock()
_TRACE_SEQ = itertools.count()


@contextlib.contextmanager
def _device_trace(out_dir: str):
    """Profile the enclosed block (CPU, and CUDA where available) into a
    new trace file under ``out_dir``; synchronise the devices at its end."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    worker = f"{socket.gethostname()}_{os.getpid()}_{next(_TRACE_SEQ)}"
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(out_dir, worker),
    ):
        yield


def _sync_devices() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


@contextlib.contextmanager
def stage_timer(name: str, trace: bool = True):
    """Log and record a stage's host wall-clock seconds; with
    ``WCX_PROFILE_DIR`` set, trace it when no other stage is traced.
    ``trace=False`` keeps the stage out of the traces in any case (the
    newref pipeline's search threads: their kernels land in whatever
    stage the calling thread traces)."""
    profile_dir = os.environ.get("WCX_PROFILE_DIR") if trace else None
    trace_cm = contextlib.nullcontext()
    got_trace = False
    if profile_dir:
        got_trace = _TRACE_LOCK.acquire(blocking=False)
        if got_trace:
            trace_cm = _device_trace(
                os.path.join(profile_dir, name.replace("/", "_")))
    start = time.perf_counter()
    try:
        with trace_cm, torch.profiler.record_function(name):
            try:
                yield
            finally:
                if got_trace:
                    _sync_devices()
    finally:
        if got_trace:
            _TRACE_LOCK.release()
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
