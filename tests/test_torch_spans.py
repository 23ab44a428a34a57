"""The port's spans (wisecondorx_tpu_torch/utils/log.py): kept from every
thread while a ``torch.profiler`` records and never otherwise, nested
under the CLI call's root span, on the Chrome trace's clock; the loader's
waits, the search threads' parts of the KNN stage, the npz bytes, the
plate's per-sample writes, and the spans in ``WCX_PROFILE_DIR``'s
traces."""

import glob
import json
import os
import struct
import threading
import zipfile

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from synthetic import CohortSim
from wisecondorx_tpu_torch.cli import main as torch_cli
from wisecondorx_tpu_torch.io import npz as t_npz
from wisecondorx_tpu_torch.utils import log as tlog

REFSIZE = "40"
BINSIZE = 100000


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """A reference built by the port's newref (no profiler), a female and
    a male case, and the controls' files."""
    tmp = tmp_path_factory.mktemp("spans")
    sim = CohortSim(binsize=1e5, genome_scale=0.02, seed=6)
    samples, _ = sim.cohort(16, 14)
    controls = []
    for i, s in enumerate(samples):
        path = str(tmp / f"control_{i}.npz")
        t_npz.save_sample_npz(path, BINSIZE, s, {"mapped": 1})
        controls.append(path)
    cases = []
    for name, sex in (("case_f", "F"), ("case_m", "M")):
        path = str(tmp / f"{name}.npz")
        t_npz.save_sample_npz(path, BINSIZE, sim.sample(sex, cnvs=[(11, 2, 30, 3.0)]),
                              {"mapped": 1})
        cases.append(path)
    ref = str(tmp / "ref.npz")
    torch_cli(["newref", *controls, ref, "--refsize", REFSIZE, "--device", "cpu"])
    return {"tmp": tmp, "controls": controls, "cases": cases, "ref": ref}


def _argv(cohort, command, tag):
    tmp = cohort["tmp"]
    if command == "newref":
        return ["newref", *cohort["controls"], str(tmp / f"{tag}_ref.npz"),
                "--refsize", REFSIZE, "--device", "cpu"]
    if command == "predict":
        return ["predict", cohort["cases"][0], cohort["ref"], str(tmp / f"{tag}_out"),
                "--bed", "--minrefbins", "10", "--device", "cpu"]
    return ["predict-batch", cohort["ref"], str(tmp / f"{tag}_plate"),
            "--infiles", *cohort["cases"], "--bed", "--minrefbins", "10",
            "--device", "cpu"]


def _traced(cohort, command, tag):
    """``command`` under a CPU profiler: (spans, Chrome trace)."""
    path = str(cohort["tmp"] / f"{tag}.pt.trace.json")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch_cli(_argv(cohort, command, tag))
    prof.export_chrome_trace(path)
    with open(path) as f:
        return tlog.spans(), json.load(f)


@pytest.fixture(scope="module")
def traced(cohort):
    return {c: _traced(cohort, c, f"traced_{c}")
            for c in ("newref", "predict", "predict_batch")}


def _root(spans):
    (root,) = [s for s in spans if s["parent"] is None]
    return root


@pytest.mark.parametrize("command", ["newref", "predict", "predict_batch"])
def test_no_profiler_keeps_no_spans(cohort, traced, command):
    tlog._clear_spans()
    tlog.reset_stage_times()
    torch_cli(_argv(cohort, command, f"quiet_{command}"))
    assert tlog.spans() == [] and tlog.spans_dropped() == 0
    # Tracing changes no stage: the traced call timed the same ones, but
    # for the warm-up's own steps, which run once a process; the search
    # threads' parts are spans alone.
    def stages(names):
        return {n for n in names if not n.startswith(("warmup.", "knn."))
                or n.startswith("warmup.wait.")}

    quiet = stages(tlog.stage_times())
    assert f"cli.{command}" in quiet
    assert not [n for n in tlog.stage_times() if n.startswith("knn.")]
    assert quiet == stages(s["name"] for s in traced[command][0])


def test_the_handle_is_shared_while_nothing_records():
    with tlog.stage_timer("quiet") as a, tlog.span("quiet.inner") as b:
        a.add("bytes", 1)
    assert a is tlog.NO_SPAN and b is tlog.NO_SPAN
    assert tlog.carry(len) is len


@pytest.mark.parametrize("command", ["newref", "predict", "predict_batch"])
def test_every_span_descends_from_the_call(traced, command):
    spans, _ = traced[command]
    root = _root(spans)
    assert root["name"] == f"cli.{command}"
    by_id = {s["id"]: s for s in spans}
    for s in spans:
        assert s["request"] == root["id"]
        assert root["start_ns"] <= s["start_ns"] <= s["end_ns"] <= root["end_ns"]
        chain = s
        while chain["parent"] is not None:
            chain = by_id[chain["parent"]]
        assert chain is root, s["name"]
    assert len({s["tid"] for s in spans}) >= 2


def test_predict_spans_name_the_loader_and_its_waits(traced, cohort):
    spans, _ = traced["predict"]
    main = _root(spans)["tid"]
    names = {s["name"]: s for s in spans}
    assert names["ref_loader.open"]["tid"] == main
    waits = [s for s in spans if s["name"] == "ref_loader.wait"]
    assert all(s["tid"] == main for s in waits)
    assert {"tables.A", "tables.F", "null.A", "null.F", "close"} <= {
        s["attrs"]["on"] for s in waits}
    loads = [s for s in spans if s["name"].startswith("predict.load.indexes")]
    assert loads and all(s["tid"] != main for s in loads)
    sample = names["predict.load_sample"]["attrs"]["bytes"]
    assert sample == os.path.getsize(cohort["cases"][0])


def test_predict_load_bytes_are_the_members(traced, cohort):
    spans, _ = traced["predict"]
    members = [s for s in spans if "bytes" in s["attrs"]
               and s["name"].startswith("predict.load.")]
    assert {s["name"] for s in members} == {
        "predict.load.indexes", "predict.load.null_ratios",
        "predict.load.indexes.F", "predict.load.null_ratios.F"}
    with zipfile.ZipFile(cohort["ref"]) as zf:
        for s in members:
            member = s["name"][len("predict.load."):] + ".npy"
            # A small reference deflates every member: each is read whole.
            assert s["attrs"]["bytes"] == zf.getinfo(member).compress_size


def test_main_thread_spans_start_with_their_trace_ranges(traced):
    spans, chrome = traced["predict"]
    main = _root(spans)["tid"]
    base, offset = chrome["baseTimeNanoseconds"], tlog.clock_offset_ns()
    ranges = {}
    for e in chrome["traceEvents"]:
        if e.get("cat") == "user_annotation":
            ranges.setdefault(e["name"], []).append(e["ts"] * 1000 + base)
    kept = {}
    for s in spans:
        if s["tid"] == main:
            kept.setdefault(s["name"], []).append(s["start_ns"] + offset)
    assert {"cli.predict", "ref_loader.wait", "predict.cbs"} <= set(kept)
    for name, starts in kept.items():
        got = sorted(ranges[name])
        assert len(got) == len(starts), name
        gaps = np.abs(np.array(got) - np.array(sorted(starts)))
        assert gaps.max() < 2e6, (name, gaps.max())


def test_pipelined_build_splits_its_search_threads(traced):
    spans, _ = traced["newref"]
    main = _root(spans)["tid"]
    for part in ("knn.search", "knn.nulls", "knn.download"):
        got = [s for s in spans if s["name"] == part]
        assert sorted(s["attrs"]["pass"] for s in got) == ["A", "F", "M"], part
        assert all(s["tid"] != main for s in got), part
        assert len({s["tid"] for s in got}) == 3, part
    knn = {s["attrs"]["pass"]: s for s in spans if s["name"] == "knn.search"}
    for s in spans:
        if s["name"].endswith(".knn") and s["name"].startswith("newref.pass_"):
            inner = knn[s["name"][len("newref.pass_")]]
            assert inner["parent"] == s["id"] and inner["tid"] == s["tid"]


def test_newref_io_bytes(traced, cohort):
    spans, _ = traced["newref"]
    names = {s["name"]: s["attrs"] for s in spans}
    path = str(cohort["tmp"] / "traced_newref_ref.npz")
    with open(path, "rb") as f:
        data = f.read()
    # The end of central directory record: the directory's offset.
    cd_start = struct.unpack("<IHHHHIIH", data[-22:])[6]
    with zipfile.ZipFile(path) as zf:
        raw = sum(i.file_size for i in zf.infolist())
    assert names["npz.write.io"]["stored_bytes"] == cd_start
    for stage in ("npz.write.serialize", "npz.write.compress", "npz.write.io"):
        assert names[stage]["raw_bytes"] == raw
        assert names[stage]["stored_bytes"] == cd_start
    assert names["newref.verify"]["bytes"] == len(data)
    assert names["newref.load_inputs"]["bytes"] == sum(
        os.path.getsize(p) for p in cohort["controls"])


def test_plate_writes_name_their_samples(traced, cohort):
    spans, _ = traced["predict_batch"]
    writes = [s["attrs"]["sample"] for s in spans if s["name"] == "predict_batch.write"]
    want = [str(cohort["tmp"] / "traced_predict_batch_plate" / os.path.basename(p)[:-4])
            for p in cohort["cases"]]
    assert writes == want


@pytest.mark.parametrize("mode", ["never", "always"])
def test_member_bytes_read(tmp_path, monkeypatch, mode):
    monkeypatch.setenv("WCX_NPZ_COMPRESS", mode)
    path = str(tmp_path / "m.npz")
    table = np.arange(40 * 6, dtype=np.int32).reshape(40, 6)
    t_npz._savez_fast(path, {"indexes": table})
    with zipfile.ZipFile(path) as zf:
        info = zf.getinfo("indexes.npy")
    whole, tail = {}, {}
    np.testing.assert_array_equal(t_npz.load_member_rows(path, "indexes", 0, whole), table)
    np.testing.assert_array_equal(t_npz.load_member_rows(path, "indexes", 30, tail),
                                  table[30:])
    assert whole["bytes"] == info.compress_size
    # A stored member is read from its row on; a deflated one whole.
    header = info.file_size - table.nbytes
    assert tail["bytes"] == (header + 10 * 6 * 4 if mode == "never"
                             else info.compress_size)


def test_a_span_names_its_thread():
    seen = {}

    def work():
        seen["ids"] = (threading.get_native_id(), threading.get_ident())
        with tlog.span("work"):
            pass

    with profile(activities=[ProfilerActivity.CPU]):
        with tlog.stage_timer("root", trace=False):
            t = threading.Thread(target=tlog.carry(work))
            t.start()
            t.join(timeout=60)
    assert not t.is_alive()
    got = {s["name"]: s for s in tlog.spans()}
    assert (got["work"]["tid"], got["work"]["ident"]) == seen["ids"]
    assert (got["root"]["tid"], got["root"]["ident"]) == (
        threading.get_native_id(), threading.get_ident())
    assert got["work"]["parent"] == got["root"]["id"]


def test_store_is_bounded_and_cleared_by_a_new_session(monkeypatch):
    monkeypatch.setattr(tlog, "SPAN_LIMIT", 2)
    with profile(activities=[ProfilerActivity.CPU]):
        for name in ("a", "b", "c"):
            with tlog.stage_timer(name, trace=False):
                pass
        assert [s["name"] for s in tlog.spans()] == ["a", "b"]
        assert tlog.spans_dropped() == 1
    with tlog.stage_timer("off"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with tlog.stage_timer("d", trace=False):
            pass
    assert [s["name"] for s in tlog.spans()] == ["d"]
    assert tlog.spans_dropped() == 0


def test_stage_trace_holds_every_threads_spans(tmp_path, monkeypatch):
    monkeypatch.setenv("WCX_PROFILE_DIR", str(tmp_path))

    def loader():
        with tlog.stage_timer("loader") as span:
            span.add("bytes", 7)
            torch.zeros(8).sum()

    with tlog.stage_timer("main"):
        t = threading.Thread(target=tlog.carry(loader))
        t.start()
        t.join(timeout=60)
    assert not t.is_alive()
    (path,) = glob.glob(os.path.join(tmp_path, "main", "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kept = {e["name"]: e for e in events if e.get("cat") == "wcx_span"}
    assert set(kept) == {"main", "loader"}
    assert kept["loader"]["args"]["parent"] == kept["main"]["args"]["id"]
    assert kept["loader"]["args"]["bytes"] == 7
    assert kept["loader"]["tid"] != kept["main"]["tid"]
    (rng,) = [e for e in events
              if e.get("cat") == "user_annotation" and e["name"] == "main"]
    assert abs(rng["ts"] - kept["main"]["ts"]) < 2e3  # us
