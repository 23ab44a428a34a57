"""The join of the program's spans to a trace's device operations
(``wcxbench/spans.py``) on a hand-made event list, and the span readers
of a checkout whose program keeps no spans."""

import types

import pytest

from wcxbench import spans

#: A Unix time (ns) and the perf_counter offset of a made-up process.
UNIX_NS = 1_792_290_829_000_000_000
OFFSET_NS = 1_792_000_000_000_000_000
BASE_NS = spans.trace_base_ns(UNIX_NS)
MAIN, SEARCH = 101, 202
#: A thread the profiler did not start on: its launches carry its pthread
#: id's low 32 bits as a signed integer, without the sign.
POOL, POOL_IDENT, POOL_LAUNCH_TID = 303, 0x7F5EB71FF6C0, 1222641984


def _perf(ms: float) -> int:
    """perf_counter ns of ``ms`` after UNIX_NS."""
    return UNIX_NS - OFFSET_NS + int(ms * 1e6)


def _ts(ms: float) -> float:
    """A trace's ``ts`` (us from its base) of ``ms`` after UNIX_NS."""
    return (UNIX_NS + ms * 1e6 - BASE_NS) / 1e3


def _launch(tid, ms, corr):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "tid": tid, "ts": _ts(ms), "dur": 5.0, "args": {"correlation": corr}}


def _kernel(corr, dur_us):
    return {"ph": "X", "cat": "kernel", "name": f"k{corr}", "tid": 7,
            "ts": 0.0, "dur": dur_us, "args": {"correlation": corr}}


def _span(name, tid, a_ms, b_ms, ident=None):
    return {"id": hash((name, a_ms)), "parent": None, "request": 1, "name": name,
            "tid": tid, "ident": ident, "start_ns": _perf(a_ms), "end_ns": _perf(b_ms),
            "attrs": {}}


SPANS = [_span("knn.search", SEARCH, 10, 20), _span("knn.nulls", SEARCH, 20, 30),
         _span("knn.search", MAIN, 40, 50), _span("knn.nulls", POOL, 0, 50, POOL_IDENT)]
EVENTS = [
    _launch(SEARCH, 12, 1), _kernel(1, 1000.0),   # in the search thread's search
    _launch(SEARCH, 25, 2), _kernel(2, 3000.0),   # in its nulls
    _launch(SEARCH, 35, 3), _kernel(3, 7000.0),   # between its spans
    _launch(MAIN, 45, 4), _kernel(4, 20000.0),    # in another thread's search
    _launch(MAIN, 15, 5), _kernel(5, 50000.0),    # main thread, no span of its own
    _launch(POOL_LAUNCH_TID, 5, 6), _kernel(6, 400.0),  # in the pool thread's nulls
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaDeviceSynchronize",
     "tid": MAIN, "ts": _ts(60), "dur": 1.0, "args": {}},
]
WINDOW = (_perf(0), _perf(55))


def test_thread_keys_hold_the_pthread_ids_low_bits():
    assert spans.thread_keys(SPANS[-1]) == {POOL, POOL_LAUNCH_TID}
    positive = dict(SPANS[-1], ident=0x7F5E3EFFF6C0)
    assert spans.thread_keys(positive) == {POOL, 0x3EFFF6C0}
    assert spans.thread_keys(dict(SPANS[0], ident=None)) == {SEARCH}


def test_base_is_unix_time_floored_to_the_period():
    assert BASE_NS % (spans.BASE_PERIOD_S * 10**9) == 0
    assert 0 <= UNIX_NS - BASE_NS < spans.BASE_PERIOD_S * 10**9


@pytest.mark.parametrize("name, seconds", [("knn.search", 0.021),
                                            ("knn.nulls", 0.0034),
                                            ("knn.download", None)])
def test_launches_join_the_span_of_their_thread(name, seconds):
    got = spans.device_seconds(EVENTS, SPANS, name, WINDOW, OFFSET_NS, BASE_NS)
    assert got == pytest.approx(seconds) if seconds is not None else got is None


@pytest.mark.parametrize("shift", [-1, 1])
def test_a_base_off_by_one_period_reads_nothing(shift):
    base = BASE_NS + shift * spans.BASE_PERIOD_S * 10**9
    assert spans.device_seconds(EVENTS, SPANS, "knn.search", WINDOW, OFFSET_NS, base) is None


def test_a_launch_past_the_jobs_reads_nothing():
    late = EVENTS + [_launch(SEARCH, 55 + spans.SLACK_NS / 1e6 + 1, 9)]
    assert spans.device_seconds(late, SPANS, "knn.search", WINDOW, OFFSET_NS, BASE_NS) is None
    assert spans.device_seconds(EVENTS[:0], SPANS, "knn.search", WINDOW, OFFSET_NS,
                                BASE_NS) is None


def test_readers_of_a_program_without_spans_read_nothing(monkeypatch):
    monkeypatch.setattr(spans, "program_spans", lambda: None)
    traced = {"jobs": [{"start": 0.0, "end": 1.0, "samples": 1}], "events": EVENTS}
    run = types.SimpleNamespace(traced=traced, jobs=[])
    assert spans.device_seconds_per_sample(run, "knn.search") is None
    assert spans.attribute_per_sample(run, lambda s: 1) is None


def test_attributes_sum_over_the_traced_jobs(monkeypatch):
    kept = [dict(_span("predict.load.indexes", SEARCH, 1, 2), attrs={"bytes": 3e6}),
            dict(_span("predict.load.indexes", SEARCH, 1, 2), attrs={"bytes": 1e6}),
            dict(_span("predict.load.indexes", SEARCH, 90, 91), attrs={"bytes": 5e6})]
    monkeypatch.setattr(spans, "program_spans", lambda: (kept, OFFSET_NS))
    jobs = [{"start": _perf(0) / 1e9, "end": _perf(50) / 1e9, "samples": 2}]
    run = types.SimpleNamespace(traced={"jobs": jobs, "events": []}, jobs=[])
    assert spans.attribute_per_sample(run, lambda s: s["attrs"].get("bytes")) == 2e6
