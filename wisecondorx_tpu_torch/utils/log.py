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

While a ``torch.profiler`` records anywhere in the process, every stage
also keeps a span (:func:`spans`): its id, its parent (the enclosing
stage on the same thread, or the stage that handed the work to another
thread through :func:`carry`), the id of its request (the root span of
the CLI call), its name, native thread id and ``threading.get_ident()``
(a CUDA launch in a ``torch.profiler`` trace names a thread the profiler
did not start on by the low 32 bits of the latter), start and end in
``time.perf_counter_ns()`` (:func:`clock_offset_ns` turns them into Unix
ns, the clock of a Chrome trace's ``ts * 1000 + baseTimeNanoseconds``)
and the attributes set through the handle ``stage_timer`` yields.  The
profiler keeps ``record_function`` ranges of the thread that started it
only; the spans are kept from every thread.  A per-stage trace of
``WCX_PROFILE_DIR`` gets the spans of every thread inside its window as
``X`` events of category ``wcx_span``.
"""

from __future__ import annotations

import contextlib
import itertools
import json
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

#: Spans kept per profiler session at most; later ones are counted in
#: :func:`spans_dropped`.
SPAN_LIMIT = 1_000_000
_SPANS: list = []
_SPANS_LOCK = threading.Lock()
_SPAN_IDS = itertools.count(1)
_SPAN_STATE = {"recording": False, "dropped": 0}
#: Per thread: ``stack``, the open spans, innermost last.
_LOCAL = threading.local()
#: The profiler's process-wide flag; ``torch._C._autograd._profiler_enabled``
#: reads False on every thread but the one that started the profiler.
_PROFILER = torch.autograd.profiler


class Span:
    """One kept span; ``add(key, value)`` sets an attribute."""

    __slots__ = ("id", "parent", "request", "name", "tid", "ident",
                 "start_ns", "end_ns", "attrs")

    def __init__(self, name: str, parent: Span | None):
        self.id = next(_SPAN_IDS)
        self.parent = parent.id if parent is not None else None
        self.request = parent.request if parent is not None else self.id
        self.name = name
        self.tid = threading.get_native_id()
        self.ident = threading.get_ident()
        self.attrs: dict = {}
        self.end_ns = None
        self.start_ns = time.perf_counter_ns()

    def add(self, key: str, value) -> None:
        self.attrs[key] = value

    def record(self) -> dict:
        return {"id": self.id, "parent": self.parent, "request": self.request,
                "name": self.name, "tid": self.tid, "ident": self.ident,
                "start_ns": self.start_ns, "end_ns": self.end_ns,
                "attrs": dict(self.attrs)}


class _NoSpan:
    """The handle of a stage while no profiler records: keeps nothing."""

    __slots__ = ()

    def add(self, key: str, value) -> None:
        pass


NO_SPAN = _NoSpan()


def _measure_clock_offset() -> int:
    """``time.time_ns() - time.perf_counter_ns()``, from the closest of a
    few paired readings."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        unix = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, unix - (a + b) // 2)
    return best[1]


_CLOCK_OFFSET_NS = _measure_clock_offset()


def clock_offset_ns() -> int:
    """The offset that turns a span's ``perf_counter_ns`` times into Unix
    ns: ``unix_ns = start_ns + clock_offset_ns()``."""
    return _CLOCK_OFFSET_NS


def _clear_spans() -> None:
    with _SPANS_LOCK:
        _SPANS.clear()
        _SPAN_STATE["dropped"] = 0


def _recording() -> bool:
    """Whether a profiler records in this process.  The store is cleared
    when a stage finds one recording after a stage or a read of the store
    found none (a new session; sessions with neither between them share
    the store)."""
    on = getattr(_PROFILER, "_is_profiler_enabled", False)
    if on != _SPAN_STATE["recording"]:
        with _SPANS_LOCK:
            if on and not _SPAN_STATE["recording"]:
                _SPANS.clear()
                _SPAN_STATE["dropped"] = 0
            _SPAN_STATE["recording"] = on
    return on


def _open_span(name: str):
    if not _recording():
        return NO_SPAN
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    span = Span(name, stack[-1] if stack else None)
    stack.append(span)
    return span


def _close_span(span) -> None:
    if span is NO_SPAN:
        return
    span.end_ns = time.perf_counter_ns()
    _LOCAL.stack.remove(span)
    with _SPANS_LOCK:
        if len(_SPANS) < SPAN_LIMIT:
            _SPANS.append(span)
        else:
            _SPAN_STATE["dropped"] += 1


@contextlib.contextmanager
def span(name: str):
    """Keep a span of the enclosed block while a profiler records, and
    nothing else (no stage seconds, log line or range: a part of a stage
    that only the spans tell apart).  Yields its handle, as
    :func:`stage_timer` does."""
    handle = _open_span(name)
    try:
        yield handle
    finally:
        _close_span(handle)


def spans() -> list[dict]:
    """The spans kept since the current (or last) profiler session began,
    as they ended: dicts with ``id``, ``parent`` (None for a root),
    ``request``, ``name``, ``tid`` (``threading.get_native_id()``),
    ``ident`` (``threading.get_ident()``), ``start_ns``, ``end_ns``
    (``time.perf_counter_ns()``) and ``attrs``.
    Empty in a process where no profiler has recorded."""
    _recording()
    with _SPANS_LOCK:
        kept = list(_SPANS)
    return [s.record() for s in kept]


def spans_dropped() -> int:
    """Spans of the session not kept, past :data:`SPAN_LIMIT`."""
    with _SPANS_LOCK:
        return _SPAN_STATE["dropped"]


def carry(fn):
    """``fn`` for another thread: its spans become children of the span
    open on this thread now (and share its request).  ``fn`` itself where
    none is open, as whenever no profiler records."""
    stack = getattr(_LOCAL, "stack", None)
    if not stack:
        return fn
    parent = stack[-1]

    def carried(*args, **kwargs):
        outer = getattr(_LOCAL, "stack", None)
        _LOCAL.stack = [parent]
        try:
            return fn(*args, **kwargs)
        finally:
            _LOCAL.stack = outer

    return carried


def _span_events(base_ns: int) -> list:
    """The kept spans as Chrome trace ``X`` events on a trace's clock
    (``ts`` in us from ``base_ns``)."""
    offset, pid = clock_offset_ns(), os.getpid()
    return [{"ph": "X", "cat": "wcx_span", "name": s["name"], "pid": pid,
             "tid": s["tid"],
             "ts": (s["start_ns"] + offset - base_ns) / 1e3,
             "dur": (s["end_ns"] - s["start_ns"]) / 1e3,
             "args": {"id": s["id"], "parent": s["parent"],
                      "request": s["request"], **s["attrs"]}}
            for s in spans()]


def _trace_handler(out_dir: str, worker: str):
    """``tensorboard_trace_handler``'s file, with the kept spans added."""
    def write(prof) -> None:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"{worker}.{time.time_ns()}.pt.trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
        trace["traceEvents"].extend(
            _span_events(int(trace.get("baseTimeNanoseconds", 0))))
        with open(path, "w") as f:
            json.dump(trace, f)

    return write


@contextlib.contextmanager
def _device_trace(out_dir: str):
    """Profile the enclosed block (CPU, and CUDA where available) into a
    new trace file under ``out_dir``; synchronise the devices at its end.
    The spans kept are this trace's from its start."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    worker = f"{socket.gethostname()}_{os.getpid()}_{next(_TRACE_SEQ)}"
    with torch.profiler.profile(activities=activities,
                                on_trace_ready=_trace_handler(out_dir, worker)):
        _clear_spans()
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
    stage the calling thread traces).  Yields the stage's span handle
    (``add(key, value)`` sets an attribute; a no-op while no profiler
    records)."""
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
        with trace_cm, torch.profiler.record_function(name), span(name) as handle:
            try:
                yield handle
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
