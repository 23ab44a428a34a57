"""Discovery of the benchmark's pieces by name, and refusal of malformed
entries."""

import copy
import json

import pytest

from wcxbench import spec

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_finds_its_files(cell):
    w = spec.workload(cell)
    entry = next(e for e in BENCH["workloads"] if e["name"] == cell)
    assert w["config"]["name"] == entry["config"]
    assert spec.stage(w["stage"]).job
    for m in spec.metrics_of(BENCH, cell, trace=False) + spec.metrics_of(BENCH, cell, trace=True):
        assert spec.metric_reader(m["name"]).read


@pytest.mark.parametrize("cell", CELLS)
def test_workload_file_agrees_with_benchmark(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    with open(spec.HERE / "workloads" / f"{cell}.json") as f:
        data = json.load(f)
    assert data["why"] == entry["why"]
    assert len(entry["why"]) <= 200


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_file_agrees_with_benchmark(metric):
    reader = spec.metric_reader(metric["name"])
    assert reader.UNIT == metric["unit"]
    assert reader.SOURCE == metric["source"]
    if "layer" in metric:
        assert reader.LAYER == metric["layer"]
        assert reader.MOVES == metric["moves"]
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for cell in CELLS:
        e2e = {m["name"] for m in spec.metrics_of(BENCH, cell, trace=False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.metrics_of(BENCH, cell, trace=True)


def test_configuration_files_hold_their_sources():
    for c in BENCH["configs"]:
        cfg = spec.config(BENCH, c["name"])
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]


def test_unknown_names_are_refused():
    with pytest.raises(spec.SpecError):
        spec.workload("no_such_cell")
    with pytest.raises(spec.SpecError):
        spec.workload("../etc/passwd")
    with pytest.raises(spec.SpecError):
        spec.metric_reader("no_such_metric")


def test_malformed_workload_entry_is_refused(tmp_path, monkeypatch):
    bench = copy.deepcopy(BENCH)
    cell = CELLS[0]
    bench["workloads"].append(dict(bench["workloads"][0]))  # a duplicate
    with pytest.raises(spec.SpecError):
        spec.workload(cell, bench)
    bench = copy.deepcopy(BENCH)
    bench["configs"][0]["file"] = "wcxbench/configs/missing.json"
    with pytest.raises(spec.SpecError):
        spec.config(bench, bench["configs"][0]["name"])
    # A workload file that lacks its limits.
    here = tmp_path / "wcxbench"
    (here / "workloads").mkdir(parents=True)
    (here / "stages").mkdir()
    (here / "stages" / "predict.py").write_text("")
    with open(spec.HERE / "workloads" / f"{cell}.json") as f:
        data = json.load(f)
    data.pop("limits")
    (here / "workloads" / f"{cell}.json").write_text(json.dumps(data))
    monkeypatch.setattr(spec, "HERE", here)
    with pytest.raises(spec.SpecError, match="limits"):
        spec.workload(cell, BENCH)


def test_malformed_metric_reader_is_refused(tmp_path, monkeypatch):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "bad_metric.py").write_text("UNIT = 's'\n")
    monkeypatch.setattr(spec, "HERE", tmp_path)
    with pytest.raises(spec.SpecError, match="SOURCE"):
        spec.metric_reader("bad_metric")
