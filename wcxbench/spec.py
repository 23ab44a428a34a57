"""Find a cell's pieces by name: its workload, configuration, stage module
and metric readers.

Everything that belongs to one configuration, one traffic mix or one
metric sits in a file of its own, found by the name ``BENCHMARK.json``
gives it:

* ``wcxbench/workloads/<cell>.json``: the traffic (stage, flags, cases or
  plate, which samples the check reads, the limits of the comparison);
* the configuration's ``file`` from ``BENCHMARK.json``: the deployment;
* ``wcxbench/stages/<stage>.py``: the runner of one CLI stage;
* ``wcxbench/metrics/<metric>.py``: one reader per metric.

A later cell, configuration or metric adds files and entries; no file
here changes.  A malformed entry raises :class:`SpecError`.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")

CONFIG_KEYS = {"name", "source", "binsize", "female_controls", "male_controls",
               "refsize", "nipt", "genome_scale", "reads_per_bin", "alpha",
               "zscore", "minrefbins", "maskrepeats", "assumed", "reduced"}
WORKLOAD_KEYS = {"stage", "flags", "why", "limits"}
METRIC_ATTRS = ("UNIT", "SOURCE", "read")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


class SpecError(ValueError):
    pass


def _json(path: Path) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise SpecError(f"{path}: {e}") from None


def benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def _entry(items: list, name: str, what: str) -> dict:
    found = [e for e in items if e.get("name") == name]
    if len(found) != 1:
        raise SpecError(f"{what} {name!r}: {len(found)} entries in BENCHMARK.json")
    return found[0]


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    entry = _entry(bench["configs"], name, "configuration")
    cfg = _json(root / entry["file"])
    missing = CONFIG_KEYS - set(cfg)
    if missing:
        raise SpecError(f"{entry['file']}: missing {sorted(missing)}")
    if cfg["name"] != name:
        raise SpecError(f"{entry['file']}: names {cfg['name']!r}, not {name!r}")
    return cfg


def workload(name: str, bench: dict | None = None, root: Path = ROOT) -> dict:
    """The cell's BENCHMARK.json entry merged with its workload file."""
    if not NAME.match(name):
        raise SpecError(f"bad workload name {name!r}")
    bench = benchmark(root) if bench is None else bench
    entry = _entry(bench["workloads"], name, "workload")
    spec = _json(HERE / "workloads" / f"{name}.json")
    missing = WORKLOAD_KEYS - set(spec)
    if missing:
        raise SpecError(f"workloads/{name}.json: missing {sorted(missing)}")
    if not (HERE / "stages" / f"{spec['stage']}.py").exists():
        raise SpecError(f"workloads/{name}.json: no stage {spec['stage']!r}")
    return {**spec, **entry, "config": config(bench, entry["config"], root)}


def metric_reader(name: str):
    """The reader module of metric ``name`` (a file named after it)."""
    if not NAME.match(name):
        raise SpecError(f"bad metric name {name!r}")
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists():
        raise SpecError(f"no reader metrics/{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"wcxbench.metrics.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    for attr in METRIC_ATTRS:
        if not hasattr(module, attr):
            raise SpecError(f"metrics/{name}.py lacks {attr}")
    if module.SOURCE not in SOURCES:
        raise SpecError(f"metrics/{name}.py: source {module.SOURCE!r}")
    return module


def metrics_of(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metric entries a run of ``cell`` reports: its end-to-end
    metrics untraced, its per-layer metrics traced."""
    items = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in items if "workloads" not in m or cell in m["workloads"]]


def stage(name: str):
    return importlib.import_module(f"wcxbench.stages.{name}")
