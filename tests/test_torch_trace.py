"""Per-stage device traces of the port (``WCX_PROFILE_DIR``,
wisecondorx_tpu_torch/utils/log.py) against the JAX package's rule: one
trace directory per stage name, one trace at a time (a nested stage, or
a stage on another thread while one is traced, is timed but not traced),
nothing profiled with the variable unset; and chip_smoke.py's summary of
a Chrome trace (busy share, overlapping streams, idle-gap labels)."""

import glob
import json
import os
import threading

import pytest
import torch

import chip_smoke
from wisecondorx_tpu.utils import log as jlog
from wisecondorx_tpu_torch.utils import log as tlog


def _traces(root, stage):
    return sorted(glob.glob(os.path.join(root, stage, "*.pt.trace.json")))


def _stage_ranges(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e["name"] for e in events if e.get("cat") == "user_annotation"]


def test_stage_writes_a_chrome_trace(tmp_path, monkeypatch):
    monkeypatch.setenv("WCX_PROFILE_DIR", str(tmp_path))
    tlog.reset_stage_times()
    with tlog.stage_timer("newref/pass_A"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    (path,) = _traces(tmp_path, "newref_pass_A")
    assert "newref/pass_A" in _stage_ranges(path)
    assert tlog.stage_times()["newref/pass_A"] > 0


def test_nested_stage_is_timed_not_traced(tmp_path, monkeypatch):
    monkeypatch.setenv("WCX_PROFILE_DIR", str(tmp_path))
    tlog.reset_stage_times()
    with tlog.stage_timer("outer"):
        with tlog.stage_timer("outer.inner"):
            torch.zeros(8).sum()
    assert os.listdir(tmp_path) == ["outer"]
    assert set(tlog.stage_times()) == {"outer", "outer.inner"}
    (path,) = _traces(tmp_path, "outer")
    assert {"outer", "outer.inner"} <= set(_stage_ranges(path))


def test_stage_on_another_thread_is_timed_not_traced(tmp_path, monkeypatch):
    monkeypatch.setenv("WCX_PROFILE_DIR", str(tmp_path))
    tlog.reset_stage_times()

    def other():
        with tlog.stage_timer("loader"):
            torch.zeros(8).sum()

    with tlog.stage_timer("main"):
        t = threading.Thread(target=other)
        t.start()
        t.join()
    assert os.listdir(tmp_path) == ["main"]
    assert set(tlog.stage_times()) == {"main", "loader"}
    assert not tlog._TRACE_LOCK.locked()


def test_unset_variable_creates_no_profiler(monkeypatch):
    monkeypatch.delenv("WCX_PROFILE_DIR", raising=False)

    def refuse(*args, **kwargs):
        raise AssertionError("torch.profiler.profile called")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    tlog.reset_stage_times()
    with tlog.stage_timer("quiet"):
        torch.zeros(8).sum()
    assert "quiet" in tlog.stage_times()


def test_repeated_stage_writes_a_file_per_run(tmp_path, monkeypatch):
    monkeypatch.setenv("WCX_PROFILE_DIR", str(tmp_path))
    for _ in range(2):
        with tlog.stage_timer("predict_batch.write"):
            torch.zeros(8).sum()
    assert len(_traces(tmp_path, "predict_batch.write")) == 2


def test_failing_stage_still_writes_and_releases(tmp_path, monkeypatch):
    monkeypatch.setenv("WCX_PROFILE_DIR", str(tmp_path))
    with pytest.raises(ValueError):
        with tlog.stage_timer("broken"):
            raise ValueError("stage failed")
    assert len(_traces(tmp_path, "broken")) == 1
    assert not tlog._TRACE_LOCK.locked()


def _stage_sequence(log):
    """Nested and threaded stages: a thread's stage while the lock is
    held, a nested stage, then a thread's stage once it is free."""
    started, done = threading.Event(), threading.Event()

    def held_out():
        started.wait()
        with log.stage_timer("load.while_held"):
            pass
        done.set()

    t = threading.Thread(target=held_out)
    t.start()
    with log.stage_timer("outer/stage"):
        started.set()
        done.wait()
        with log.stage_timer("outer.nested"):
            pass
    t.join()
    with log.stage_timer("after"):
        pass
    free = threading.Thread(target=_run_stage, args=(log, "load.free"))
    free.start()
    free.join()


def _run_stage(log, name):
    with log.stage_timer(name):
        pass


def test_same_stage_directories_as_the_jax_package(tmp_path, monkeypatch):
    dirs = {}
    for name, log in (("jax", jlog), ("torch", tlog)):
        root = tmp_path / name
        monkeypatch.setenv("WCX_PROFILE_DIR", str(root))
        _stage_sequence(log)
        dirs[name] = sorted(os.listdir(root))
    assert dirs["torch"] == dirs["jax"] == ["after", "load.free", "outer_stage"]


def _x(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": tid}


def test_trace_summary_of_a_handmade_trace(tmp_path):
    """Window 0-100 us; kernels on two streams overlap over 10-30 and
    20-40 (30 us once), a memcpy over 60-70, a kernel past the window's
    end clipped at 100; idle 0-10, 40-60, 70-90, labelled by the innermost
    host range covering each midpoint."""
    events = [
        _x("user_annotation", "predict.cbs", 0, 100),
        _x("user_annotation", "predict.cbs.inner", 30, 40),
        _x("cpu_op", "aten::sort", 45, 10, tid=2),
        _x("cpu_op", "aten::copy_", 70, 30),
        _x("kernel", "k_a", 10, 20, tid=7),
        _x("kernel", "k_b", 20, 20, tid=8),
        _x("gpu_memcpy", "Memcpy HtoD", 60, 10, tid=7),
        _x("kernel", "k_a", 90, 30, tid=7),
        _x("kernel", "k_outside", 200, 5, tid=7),
        _x("gpu_user_annotation", "predict.cbs", 0, 100, tid=7),
    ]
    path = tmp_path / "t.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    summary, ops = chip_smoke.trace_summary([str(path)], "predict.cbs")
    assert summary["window_ms"] == pytest.approx(0.1)
    assert summary["device_ms"] == pytest.approx(0.05)
    assert summary["busy_share"] == pytest.approx(0.5)
    assert summary["kernel_events"] == 3
    assert ops == pytest.approx({"k_a": 0.03, "k_b": 0.02, "Memcpy HtoD": 0.01})
    assert summary["top_ops"][0] == ["k_a", pytest.approx(0.03), 2]
    assert summary["idle_gaps"] == [[pytest.approx(0.02), "aten::sort"],
                                    [pytest.approx(0.02), "aten::copy_"],
                                    [pytest.approx(0.01), "no host range"]]


def test_trace_summary_needs_the_stage_range(tmp_path):
    path = tmp_path / "t.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": [_x("kernel", "k", 0, 5)]}))
    with pytest.raises(AssertionError, match="no predict.cbs range"):
        chip_smoke.trace_summary([str(path)], "predict.cbs")


@pytest.mark.parametrize("found_by", ["thread_id", "warmup_range"])
def test_trace_summary_leaves_the_warmups_device_work_apart(tmp_path, found_by):
    """A kernel launched from a warm-up thread (tid 5: named by its native
    id, or holding a ``warmup`` range) inside the window is summed as the
    warm-up's device time, not the stage's; the main thread's (tid 1)
    counts as before."""
    def launch(tid, correlation, ts):
        event = _x("cuda_runtime", "cudaLaunchKernel", ts, 1, tid=tid)
        event["args"] = {"correlation": correlation}
        return event

    def kernel(name, correlation, ts, dur):
        event = _x("kernel", name, ts, dur, tid=7)
        event["args"] = {"correlation": correlation}
        return event

    events = [
        _x("user_annotation", "newref.load_inputs", 0, 100),
        launch(1, 11, 5), kernel("k_main", 11, 10, 20),
        launch(5, 12, 40), kernel("knn_bucket_kernel", 12, 50, 30),
    ]
    warm_tids = {5}
    if found_by == "warmup_range":
        events.append(_x("user_annotation", "warmup", 30, 60, tid=5))
        warm_tids = set()
    path = tmp_path / "t.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    summary, ops = chip_smoke.trace_summary([str(path)], "newref.load_inputs",
                                            warm_tids=warm_tids)
    assert summary["device_ms"] == pytest.approx(0.02)
    assert summary["warmup_device_ms"] == pytest.approx(0.03)
    assert summary["kernel_events"] == 1
    assert ops == pytest.approx({"k_main": 0.02})
