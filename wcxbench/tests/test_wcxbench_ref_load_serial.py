"""``ref_load_serial_mb.predict`` on hand-made spans: the ``serial_bytes``
of the traced jobs' ``predict.load.*`` spans in MB per sample, and
nothing where the program's spans lack the attribute (a program that
does not report it)."""

import types

import pytest

from wcxbench import spans, spec

OFFSET_NS = 1_792_000_000_000_000_000
START_NS = 1_792_290_829_000_000_000 - OFFSET_NS


def _span(name, ms, **attrs):
    at = START_NS + int(ms * 1e6)
    return {"id": hash((name, ms)), "parent": None, "request": 1, "name": name,
            "tid": 1, "ident": None, "start_ns": at, "end_ns": at + 1000,
            "attrs": attrs}


def _read(monkeypatch, kept):
    monkeypatch.setattr(spans, "program_spans", lambda: (kept, OFFSET_NS))
    jobs = [{"start": START_NS / 1e9, "end": (START_NS + 50e6) / 1e9, "samples": 2}]
    run = types.SimpleNamespace(traced={"jobs": jobs, "events": []}, jobs=[])
    return spec.metric_reader("ref_load_serial_mb.predict").read(run)


@pytest.mark.parametrize("kept, mb", [
    ([_span("predict.load.indexes", 1, bytes=4e7, serial_bytes=0),
      _span("predict.load.null_ratios", 2, bytes=2e7, serial_bytes=0)], 0.0),
    ([_span("predict.load.indexes", 1, bytes=4e7, serial_bytes=4e7),
      _span("predict.load.null_ratios", 2, bytes=2e7, serial_bytes=0),
      _span("predict.load.indexes", 40, bytes=4e7, serial_bytes=4e7),
      _span("predict.load.indexes", 90, bytes=4e7, serial_bytes=4e7),  # after the jobs
      _span("newref.verify", 3, serial_bytes=1e9)], 40.0),
    ([_span("predict.load.indexes", 1, bytes=4e7),
      _span("predict.load.null_ratios", 2, bytes=2e7)], None),
])
def test_serial_megabytes_per_sample(monkeypatch, kept, mb):
    assert _read(monkeypatch, kept) == mb


def test_a_program_without_spans_reads_nothing(monkeypatch):
    monkeypatch.setattr(spans, "program_spans", lambda: None)
    run = types.SimpleNamespace(traced={"jobs": [], "events": []}, jobs=[])
    assert spec.metric_reader("ref_load_serial_mb.predict").read(run) is None
