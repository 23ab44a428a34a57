"""The readings the figure limits of ``cnv50_predict_plot`` are set from.

    python3 -m wcxbench.plot_control --seeds <n> [<n> ...]

For each seed, in one process on the card: the cell's set-up and one job
of each case through the timed path, then

* the program: the run's own check (tables and figures);
* the control ``next``: each job's figures judged against the case next
  in the cycle of drawn cases (its printed tables and weights);
* the control ``z``: the expected dots coloured at ``zscore - 0.5``.

Prints one JSON line per seed and side.  The benchmark's runs never run
this; it is how the figure limits in ``workloads/cnv50_predict_plot.json``
were read.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time

from wcxbench import cohort, run as run_mod, spec

CELL = "cnv50_predict_plot"


def readings(seed: int, device: str = "cuda", overrides: dict | None = None) -> dict:
    cell = spec.workload(CELL)
    cell["config"] = {**cell["config"], **(overrides or {})}
    stage = spec.stage(cell["stage"])
    work = tempfile.mkdtemp(prefix="wcxbench-plot-control-")
    try:
        run = run_mod.Run(cell, seed, 0, False, device, work)
        run.inputs = cohort.make_inputs(run.config, stage.cases(run), seed, work)
        stage.prepare(run)
        for i in range(len(run.inputs["cases"])):
            run.jobs.append(run_mod._job(run, stage, i))
        outputs = [o for j in run.jobs for o in j["outputs"]]
        out = {}
        t = time.perf_counter()
        out["program"] = {**stage.check(run), "check_s": time.perf_counter() - t}
        t = time.perf_counter()
        out["next"] = {**stage.figure_numbers(run, outputs, shift=1),
                       "control_s": time.perf_counter() - t}
        out["z"] = stage.figure_numbers(run, outputs,
                                        zscore=run.config["zscore"] - 0.5)
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("wcxbench.plot_control: no CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        for side, numbers in readings(seed).items():
            print(json.dumps({"workload": CELL, "seed": seed, "side": side,
                              **numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
