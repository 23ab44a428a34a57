"""The program's own spans (``wisecondorx_tpu_torch.utils.log.spans``),
read after a traced window, and their join to its device operations.

The program keeps a span per stage on every thread while a profiler
records: name, native thread id, start and end in
``time.perf_counter_ns()``, attributes.  A device operation's launch (the
``cuda_runtime`` / ``cuda_driver`` event with the operation's correlation
id) gives the launching thread (``tid``) and a time ``ts``, in us from the
trace's base: Unix time floored to libkineto's trace base period of
7,889,238 s.  So ``ts * 1000 + base`` is Unix ns, and less the program's
``clock_offset_ns()`` the spans' clock.  The launch belongs to the kept
span of its thread whose interval holds it.  The trace names the thread
that started the profiler by its native id (the span's ``tid``) and any
other by its pthread id's low 32 bits read as a signed integer, without
the sign (torch 2.11 on the card: a search thread of ident
0x7f5eb71ff6c0 launches as 1222641984); the span keeps that id as
``ident``.

Every reader returns None where the program keeps no spans (a checkout
from before them), and the device readers where the trace holds no
launches (the CPU) or where a launch maps outside the traced jobs,
widened by :data:`SLACK_NS`: a wrong base or clock.
"""

from __future__ import annotations

import time

from wcxbench import trace

#: libkineto's trace base period (s): the Chrome trace's
#: ``baseTimeNanoseconds`` is Unix time floored to a multiple of it.
BASE_PERIOD_S = 7_889_238
#: How far past the traced jobs a launch may map (ns).
SLACK_NS = 10**9


def trace_base_ns(unix_ns: int | None = None) -> int:
    """A Chrome trace's ``baseTimeNanoseconds`` at Unix time ``unix_ns``
    (now by default)."""
    unix_s = (time.time_ns() if unix_ns is None else unix_ns) // 10**9
    return unix_s // BASE_PERIOD_S * BASE_PERIOD_S * 10**9


def program_spans():
    """(spans, clock offset ns) the program kept, or None where it keeps
    none."""
    try:
        from wisecondorx_tpu_torch.utils import log
    except ImportError:
        return None
    if not (hasattr(log, "spans") and hasattr(log, "clock_offset_ns")):
        return None
    return log.spans(), log.clock_offset_ns()


def jobs_window_ns(jobs: list) -> tuple[int, int]:
    """The jobs' [first start, last end] in ``perf_counter_ns``."""
    return (int(min(j["start"] for j in jobs) * 1e9),
            int(max(j["end"] for j in jobs) * 1e9))


def thread_keys(span: dict) -> set:
    """The ``tid`` values a trace may give the launches of ``span``'s
    thread."""
    keys = {span["tid"]}
    if span.get("ident") is not None:
        low = span["ident"] & 0xFFFFFFFF
        keys.add(abs(low - (1 << 32) if low >= 1 << 31 else low))
    return keys


def device_seconds(events: list, spans: list, name: str, window: tuple,
                   offset_ns: int, base_ns: int) -> float | None:
    """Device seconds of the operations in ``events`` launched inside a
    span called ``name``; None without launches or such spans, or when a
    launch maps outside ``window`` (perf ns) widened by SLACK_NS."""
    lo, hi = window[0] - SLACK_NS, window[1] + SLACK_NS
    launches = {}
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if e.get("cat") not in trace.LAUNCH_CATS or corr is None:
            continue
        t = e["ts"] * 1000 + base_ns - offset_ns
        if not lo <= t <= hi:
            return None
        launches[corr] = (e.get("tid"), t)
    inside: dict = {}
    for s in spans:
        if s["name"] == name:
            for key in thread_keys(s):
                inside.setdefault(key, []).append((s["start_ns"], s["end_ns"]))
    if not launches or not inside:
        return None
    total = 0.0
    for e in events:
        if e.get("cat") not in trace.DEVICE_CATS:
            continue
        tid, t = launches.get((e.get("args") or {}).get("correlation"), (None, 0))
        if any(a <= t <= b for a, b in inside.get(tid, ())):
            total += e["dur"]
    return total / 1e6


def device_seconds_per_sample(run, name: str) -> float | None:
    """:func:`device_seconds` of span ``name`` over the traced jobs, per
    sample (build) they completed."""
    traced, kept = run.traced, program_spans()
    if not traced or kept is None:
        return None
    n = sum(j["samples"] for j in traced["jobs"])
    seconds = device_seconds(traced["events"], kept[0], name,
                             jobs_window_ns(traced["jobs"]), kept[1],
                             trace_base_ns())
    return seconds / n if seconds is not None and n else None


def attribute_per_sample(run, pick) -> float | None:
    """The sum of ``pick(span)`` (a number, or None to leave the span out)
    over the spans of the traced jobs, per sample (build) they completed;
    None where no span was picked."""
    traced, kept = run.traced, program_spans()
    if not traced or kept is None:
        return None
    lo, hi = jobs_window_ns(traced["jobs"])
    values = [pick(s) for s in kept[0] if lo <= s["start_ns"] <= hi]
    values = [v for v in values if v is not None]
    n = sum(j["samples"] for j in traced["jobs"])
    return sum(values) / n if values and n else None
