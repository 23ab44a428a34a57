"""Device activity of a traced window, from a ``torch.profiler`` Chrome
trace.

The arithmetic is a copy of the repository's ``chip_smoke.trace_summary``:
device time is the union of the device events' intervals (kernels,
copies, memsets) clipped to the window, so work on two streams at once
counts once; an idle gap is a stretch of the window with no device
event, labelled by the innermost host range (a program stage or a torch
op, on any thread the trace saw) covering its midpoint.
"""

from __future__ import annotations

import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
TOP = 10


def load_events(path: str) -> list:
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"]
                if e.get("ph") == "X" and "dur" in e]


def summarize(events: list, window_name: str) -> dict:
    """Window and device-busy seconds, device seconds by operation, and
    the longest idle gaps with their host labels, over the host range
    ``window_name`` (the longest one of that name)."""
    own = [e for e in events
           if e.get("cat") == "user_annotation" and e.get("name") == window_name]
    if not own:
        raise ValueError(f"no {window_name!r} range in the trace")
    window = max(own, key=lambda e: e["dur"])
    w0, w1 = window["ts"], window["ts"] + window["dur"]
    spans, ops = [], {}
    for e in events:
        a, b = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if e.get("cat") not in DEVICE_CATS or b <= a:
            continue
        spans.append((a, b))
        ops[e["name"]] = ops.get(e["name"], 0.0) + (b - a)
    busy = 0.0
    cursor, gaps = w0, []
    for a, b in sorted(spans):
        if a > cursor:
            gaps.append((cursor, a))
        if b > cursor:
            busy += b - max(a, cursor)
            cursor = b
    if cursor < w1:
        gaps.append((cursor, w1))
    hosts = [e for e in events if e.get("cat") in HOST_CATS and e is not window]
    idle = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]:
        mid = (a + b) / 2
        covering = [e for e in hosts if e["ts"] <= mid <= e["ts"] + e["dur"]]
        label = (min(covering, key=lambda e: e["dur"])["name"] if covering
                 else "no host range")
        idle.append([label, (b - a) / 1e6])
    ranked = sorted(ops.items(), key=lambda kv: -kv[1])
    return {
        "events": [e for e in events
                   if e.get("cat") in DEVICE_CATS + LAUNCH_CATS
                   and w0 <= e["ts"] <= w1],
        "window_s": window["dur"] / 1e6,
        "busy_s": busy / 1e6,
        "ops_s": {name: t / 1e6 for name, t in ops.items()},
        "device_ops": [[name, t / 1e6] for name, t in ranked[:TOP]],
        "idle_gaps": idle,
    }


def _correlation(e: dict):
    return (e.get("args") or {}).get("correlation")


def device_seconds_of_threads(events: list, anchor) -> float:
    """Device seconds of every operation launched by a host thread that
    launched an operation whose name satisfies ``anchor``: a thread's
    whole device work, found by the launches' correlation ids (the
    launching API call on the host thread and the operation on the
    device carry the same one)."""
    launches = {_correlation(e): (e.get("pid"), e.get("tid")) for e in events
                if e.get("cat") in LAUNCH_CATS and _correlation(e) is not None}
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    threads = {launches[_correlation(e)] for e in device
               if anchor(e["name"]) and _correlation(e) in launches}
    return sum(e["dur"] for e in device
               if launches.get(_correlation(e)) in threads) / 1e6
