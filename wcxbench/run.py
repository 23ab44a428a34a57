"""One run of one benchmark cell of ``wisecondorx_tpu_torch`` on one card.

    python3 -m wcxbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the repository's root.  The run is one process:

* set-up (``setup_s``): import torch and the port, make the CUDA context,
  draw the cell's controls and cases from ``--seed`` and write them as
  convert-stage ``.npz`` under ``TMPDIR``, then the stage module's own
  set-up (for the predict stages, the reference built by the port's
  ``newref``) and one warm call of the cell's stage per sex;
* the window: a closed loop, one lab pipeline calling
  ``wisecondorx_tpu_torch.cli.main`` in process, job after job, for
  ``--seconds``; a job that has started runs to its end, and the window
  covers every job completed in it;
* with ``--trace 1``, a few more jobs under ``torch.profiler`` (CPU and
  CUDA) for the device's busy time and the kernels' shares;
* the check: after the window, with the program's state freed, every
  output of the window held to the plain reference (``wcxbench/reference``);
* the last line of standard output: one JSON object with ``correct``,
  ``attempted``, ``failed``, ``metrics``, ``device`` (and ``breakdown``
  traced), the compared numbers beside their limits last.

It exits non-zero, printing no result, without a CUDA card, when the
port is missing, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

from wcxbench import spec  # noqa: E402

#: Top-level modules a run may never hold (compared whole).
FORBIDDEN = {"jax", "jaxlib", "flax", "wisecondorx_tpu"}
#: Jobs traced with --trace 1, at least, and seconds traced, at least.
TRACE_JOBS, TRACE_SECONDS = 2, 3.0


class Abort(RuntimeError):
    """A run that must print no result."""


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


class Run:
    """What a stage module and a metric reader see of one run."""

    def __init__(self, cell: dict, seed: int, seconds: float, trace: bool,
                 device: str, work: str):
        self.cell, self.config = cell, cell["config"]
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.work = device, work
        self.setup: dict = {}
        self.inputs: dict = {}
        self.jobs: list = []
        self.window_s = 0.0
        self.traced: dict | None = None
        self.state: dict = {}

    def cli(self, argv: list) -> int:
        """One CLI call in this process; its exit code."""
        from wisecondorx_tpu_torch import cli

        try:
            cli.main([str(a) for a in argv] + ["--device", self.device])
        except SystemExit as e:
            return e.code if isinstance(e.code, int) else (0 if e.code is None else 1)
        return 0


def _counters() -> dict:
    from wisecondorx_tpu_torch.ops import cbs

    out = {f"cbs.rounds.{k}": v for k, v in getattr(cbs, "ROUNDS", {}).items()}
    out.update({f"cbs.launches.{k}": v for k, v in getattr(cbs, "LAUNCHES", {}).items()})
    return out


def _job(run: Run, stage, i: int, after: bool = True) -> dict:
    from wisecondorx_tpu_torch.utils.log import reset_stage_times, stage_times

    reset_stage_times()
    before = _counters()
    t0 = time.perf_counter()
    try:
        out = stage.job(run, i)
    except Exception as e:  # a program error fails the job, not the run
        print(f"job {i} raised {type(e).__name__}: {e}", file=sys.stderr)
        out = {"samples": 0, "failed": stage.samples_per_job(run), "outputs": []}
    t1 = time.perf_counter()
    counters = _counters()
    stages = stage_times()
    # The stage's own work between jobs (deleting a build it keeps no
    # more), timed so that the window can leave it out.
    after_s = 0.0
    if after and hasattr(stage, "after"):
        stage.after(run, out)
        after_s = time.perf_counter() - t1
    return {**out, "start": t0, "end": t1, "wall": t1 - t0, "after_s": after_s,
            "stages": stages,
            "counters": {k: counters[k] - before.get(k, 0) for k in counters}}


def _synchronize(run: Run) -> None:
    import torch

    if run.device == "cuda":
        torch.cuda.synchronize()


def _traced_jobs(run: Run, stage) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from wcxbench import trace

    activities = [ProfilerActivity.CPU]
    if run.device == "cuda":
        activities.append(ProfilerActivity.CUDA)
    jobs = []
    with profile(activities=activities) as prof:
        with record_function("wcxbench.traced"):
            t0 = time.perf_counter()
            while (len(jobs) < TRACE_JOBS
                   or time.perf_counter() - t0 < TRACE_SECONDS):
                jobs.append(_job(run, stage, len(run.jobs) + len(jobs), after=False))
            _synchronize(run)
    for job in jobs:  # outside the traced window
        if hasattr(stage, "after"):
            stage.after(run, job)
    path = os.path.join(run.work, "trace.json")
    prof.export_chrome_trace(path)
    summary = trace.summarize(trace.load_events(path), "wcxbench.traced")
    os.remove(path)
    summary["jobs"] = jobs
    del prof
    if run.device == "cuda":
        torch.cuda.empty_cache()
    return summary


def _device(run: Run, peak: int) -> dict:
    import torch

    if run.device == "cuda":
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": 1, "memory_peak_bytes": int(peak)}
    else:  # the CPU tests' runs
        out = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    if run.traced is not None:
        out["busy_s"] = run.traced["busy_s"]
        out["window_s"] = run.traced["window_s"]
    return out


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", overrides: dict | None = None,
             bench: dict | None = None) -> dict:
    """Set-up, window, trace and check of one cell; the result object.
    ``device`` "cpu" and ``overrides`` (configuration keys) serve the CPU
    tests, which run the harness at a tiny size."""
    bench = spec.benchmark() if bench is None else bench
    cell = spec.workload(workload, bench)
    cell["config"] = {**cell["config"], **(overrides or {})}
    readers = [(m, spec.metric_reader(m["name"]))
               for m in spec.metrics_of(bench, workload, trace)]
    stage = spec.stage(cell["stage"])

    import torch

    if device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            raise Abort(f"needs {cell['chips']} CUDA device(s); "
                        f"available: {torch.cuda.is_available()}, "
                        f"count: {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    try:
        import wisecondorx_tpu_torch.cli  # noqa: F401
    except ImportError as e:
        raise Abort(f"the port wisecondorx_tpu_torch is missing: {e}") from None
    if device == "cuda":
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
    work = tempfile.mkdtemp(prefix="wcxbench-")
    run = Run(cell, seed, seconds, trace, device, work)
    try:
        run.setup["import_s"] = time.perf_counter() - T_START
        t = time.perf_counter()
        from wcxbench import cohort

        run.inputs = cohort.make_inputs(run.config, stage.cases(run), seed, work)
        run.setup["inputs_s"] = time.perf_counter() - t
        stage.prepare(run)
        _synchronize(run)
        run.setup["setup_s"] = time.perf_counter() - T_START

        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds or not run.jobs:
            run.jobs.append(_job(run, stage, len(run.jobs)))
        _synchronize(run)
        run.window_s = (run.jobs[-1]["end"] - run.jobs[0]["start"]
                        - sum(j["after_s"] for j in run.jobs[:-1]))
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        if trace:
            run.traced = _traced_jobs(run, stage)

        metrics = {}
        for entry, reader in readers:
            value = reader.read(run)
            if value is None:
                if not trace:
                    raise Abort(f"end-to-end metric {entry['name']} has no value")
                continue
            metrics[entry["name"]] = {"value": value, "unit": reader.UNIT}
        if run.traced is not None:
            run.traced.pop("events", None)

        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        limits = cell["limits"]
        t = time.perf_counter()
        numbers = stage.check(run)
        check_s = time.perf_counter() - t
        if set(numbers) != set(limits):
            raise Abort(f"compared {sorted(numbers)} but limits name {sorted(limits)}")
        checks = {k: {"value": numbers[k], "limit": limits[k]} for k in numbers}
        jobs = run.jobs + (run.traced["jobs"] if run.traced else [])
        result = {
            "correct": all(c["value"] <= c["limit"] for c in checks.values()),
            "attempted": sum(j["samples"] + j["failed"] for j in jobs),
            "failed": sum(j["failed"] for j in jobs),
            "metrics": metrics,
            "device": _device(run, peak),
        }
        if run.traced is not None:
            result["breakdown"] = {"device_ops": run.traced["device_ops"],
                                   "idle_gaps": run.traced["idle_gaps"]}
        result["setup"] = run.setup  # its parts, for the records
        if "bytes" in run.state:
            result["setup"]["build_bytes"] = run.state["bytes"]
        result["check_s"] = check_s  # the comparison's own time, after the window
        result["checks"] = checks
        if forbidden_modules():
            raise Abort(f"modules loaded that a run may not hold: {forbidden_modules()}")
        return result
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _finite(value):
    """JSON has no infinity or NaN: a number past every limit stands in."""
    if isinstance(value, float) and not math.isfinite(value):
        return 1e300
    return value


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    except (Abort, spec.SpecError) as e:
        print(f"wcxbench: {e}", file=sys.stderr)
        return 2
    for c in result["checks"].values():
        c["value"] = _finite(c["value"])
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
