"""The readings the comparison's limits are set from, at a cell's size.

    python3 -m wcxbench.control --workload <cell> --seeds <n> [<n> ...]

For each seed, in one process on the card: the cell's set-up (controls,
cases and, for the predict stages, the reference built by the port's
``newref``), then

* the program: the cell's own jobs through the timed path (one
  ``predict`` of each case, one plate, or one build), held to the plain
  reference by the run's own check;
* the control: the plain reference itself computed in the precision
  below the configuration's (float32 with TF32 products; the card runs
  float32 with TF32 off), from the reference rebuild on, put in the
  program's place and held to the float64 reference the same way.

Prints one JSON line per seed and side: the compared numbers.  The
benchmark's runs never run this; it is how the limits in
``workloads/<cell>.json`` were read.
"""

from __future__ import annotations

import argparse
import json
import math
import shutil
import sys
import tempfile
import time

import torch

from wcxbench import cohort, run as run_mod, spec
from wcxbench.reference.compare import PredictCheck
from wcxbench.reference.newref import check_reference, control_arrays, rebuild
from wcxbench.reference.predict import excused_rows, reference_bins


def readings(workload: str, seed: int, device: str = "cuda",
             overrides: dict | None = None, control: bool = True) -> dict:
    cell = spec.workload(workload)
    cell["config"] = {**cell["config"], **(overrides or {})}
    stage = spec.stage(cell["stage"])
    work = tempfile.mkdtemp(prefix="wcxbench-control-")
    try:
        run = run_mod.Run(cell, seed, 0, False, device, work)
        run.inputs = cohort.make_inputs(run.config, stage.cases(run), seed, work)
        stage.prepare(run)
        jobs = max(1, math.ceil(len(run.inputs["cases"]) / stage.samples_per_job(run)))
        for i in range(jobs):
            run.jobs.append(run_mod._job(run, stage, i))
        t = time.perf_counter()
        program = stage.check(run)
        program_s = time.perf_counter() - t
        excused = run.state.get("excused_rows", {})
        out = {"program": {**program, "excused_rows": excused, "check_s": program_s}}
        if control:
            t = time.perf_counter()
            out["control"] = {**_control(run), "control_s": time.perf_counter() - t}
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _control(run) -> dict:
    """The control's numbers: its reference arrays held to the float64
    rebuild, and for the predict stages its bins of the checked cases."""
    cfg, device = run.config, run.device
    counts = [run.inputs["samples"][p] for p in run.inputs["controls"]]
    low = control_arrays(counts, cfg, device=device)
    built = rebuild(counts, cfg, torch.float64, device=device, follow=low)
    ref_numbers = check_reference(low, built, counts)
    if run.cell["stage"] == "newref":
        return {"builds_missing": 0, **ref_numbers}
    excused = excused_rows(low, built["arrays"], cfg["maskrepeats"], device)
    own = {**built["arrays"], **excused, "_cache": {}}
    del built
    check = PredictCheck(cfg["alpha"], cfg["zscore"], device)
    for _, path, _, _ in run.state.get("checked", run.inputs["cases"]):
        c = run.inputs["samples"][path]
        want = reference_bins(c, own, cfg["maskrepeats"], cfg["minrefbins"],
                              dtype=torch.float64, device=device)
        got = reference_bins(c, low, cfg["maskrepeats"], cfg["minrefbins"],
                             dtype=torch.float32, tf32=True, device=device)
        check.judged.append(check.judge_bins(got, want))
    keys = ("ratio_gap_median", "ratio_gap_max", "z_gap_median", "z_gap_max")
    numbers = check.numbers()
    return {**{k: numbers[k] for k in keys},
            **{f"ref_{k}": v for k, v in ref_numbers.items()},
            "excused_rows": {k: int(v.sum()) for k, v in excused.items()}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, default=None,
                   help="run the control on the first N seeds only")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("wcxbench.control: no CUDA device", file=sys.stderr)
        return 2
    for i, seed in enumerate(args.seeds):
        out = readings(args.workload, seed, control=args.control_seeds is None
                       or i < args.control_seeds)
        for side in out:
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "side": side, **out[side]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
