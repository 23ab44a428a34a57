#!/usr/bin/env python3
"""Cold ``newref``, ``predict`` or ``predict-batch`` walls of two checkouts
of the PyTorch port, in turns, on one card.

    python3 torch_newref_ab.py PARENT_DIR CHANGE_DIR [--shape main|bench]
        [--stage newref|predict|predict-batch] [--pairs 3] [--work DIR]
        [--logs DIR]

Writes a ``tests/synthetic.py:CohortSim`` cohort as convert-stage npz
files (chip_smoke.py's shapes: ``main`` = 50 kb bins over the whole
genome, 100 F + 100 M controls, seed 0; ``bench`` = 15 kb bins, 250 F +
250 M, seed 2) and builds each checkout's kernels once.  ``--stage
newref`` then runs ``wisecondorx_tpu_torch.cli newref --device cuda``
from each checkout in a fresh process, in the order parent, change,
change, parent, ... (``--pairs`` pairs), so every run pays the cold start
a user's newref pays: interpreter, imports, CUDA context, the kernel
library's load and the kernels' first launches.  ``--stage predict`` runs
``predict --bed`` of chip_smoke.py's trisomy-21 sample, and ``--stage
predict-batch`` ``predict-batch --bed`` of its 24-sample plate (without
the corrupt file), the same way, against one reference that the parent
checkout builds first (main shape only: both packages refuse a predict
against the bench-shape reference).  Prints one JSON line per run (side,
wall of the process, the stages its ``[timing]`` lines report, the
members of its reference, or the output files, that differ from the
first run's) and one summary line (each side's walls and median);
``--logs`` keeps each run's log.  Needs a CUDA device; the JAX package is
not imported.

    python3 torch_newref_ab.py --summarize OUT [OUT ...]

reads the run lines of earlier outputs and prints, per side, the walls,
their median, the pairs each side won and, for newref, each run's seconds
outside the main thread's stages (the wall less its top-level
``newref.*`` stages and its wait for the warm-up): what the stages cannot
see, such as imports, start-up and exit.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SHAPES = {"main": (50000, 100, 0), "bench": (15000, 250, 2)}
TIMING = re.compile(r"\[timing\] (\S+): ([0-9.]+)s")
#: chip_smoke.py's plate: its deletion (chr5 bins) and euploid females.
DELETION = (1000, 1200)
PLATE_EUPLOID = 19


def _save(path, sample, binsize):
    import numpy as np

    np.savez_compressed(path, binsize=binsize, sample=sample,
                        quality={"mapped": 1})


def write_cohort(work, binsize, per_sex, seed):
    """The controls' npz files, then chip_smoke.py's cases drawn after them
    from the same simulator: [trisomy 21 (F), euploid (M), trisomies 18
    and 13, the chr5 deletion, 19 euploid F].  Returns (controls, cases)."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from synthetic import CohortSim

    os.makedirs(work, exist_ok=True)
    sim = CohortSim(binsize=binsize, genome_scale=1.0, seed=seed)
    samples, _ = sim.cohort(per_sex, per_sex)
    files = []
    for i, sample in enumerate(samples):
        files.append(os.path.join(work, f"control_{i:03d}.npz"))
        _save(files[-1], sample, binsize)

    def trisomy(chrom):
        return (chrom, 0, len(sim.bias[chrom - 1]), 3.0)

    draws = [("case_t21", "F", [trisomy(21)]), ("case_euploid", "M", []),
             ("plate_t18", "F", [trisomy(18)]), ("plate_t13", "F", [trisomy(13)]),
             ("plate_del5", "F", [(5,) + DELETION + (1.0,)])]
    draws += [(f"plate_euploid_{i:02d}", "F", []) for i in range(PLATE_EUPLOID)]
    cases = []
    for name, sex, cnvs in draws:
        cases.append(os.path.join(work, name + ".npz"))
        _save(cases[-1], sim.sample(sex, cnvs=cnvs), binsize)
    return files, cases


def differing(path_a, path_b):
    """Members of two reference npz files, or files of two output
    directories, that differ (in name or in any byte)."""
    import numpy as np

    if os.path.isdir(path_a):
        a, b = (sorted(os.listdir(p)) for p in (path_a, path_b))
        diff = sorted(set(a) ^ set(b))
        for name in sorted(set(a) & set(b)):
            with open(os.path.join(path_a, name), "rb") as fa, \
                    open(os.path.join(path_b, name), "rb") as fb:
                if fa.read() != fb.read():
                    diff.append(name)
        return diff
    a, b = (np.load(p, allow_pickle=True) for p in (path_a, path_b))
    diff = sorted(set(a.files) ^ set(b.files))
    for key in sorted(set(a.files) & set(b.files)):
        if a[key].dtype != b[key].dtype or a[key].tobytes() != b[key].tobytes():
            diff.append(key)
    return diff


def run_cli(checkout, argv, log=None):
    """The CLI of ``checkout`` in a fresh process; its stderr is written to
    ``log`` where given.  Returns (wall seconds, {stage: summed
    seconds}); raises on a non-zero exit."""
    env = dict(os.environ, PYTHONPATH=checkout)
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "wisecondorx_tpu_torch.cli", *argv],
        cwd=checkout, env=env, capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    if log is not None:
        with open(log, "w") as f:
            f.write(run.stderr)
    if run.returncode:
        raise SystemExit(f"{checkout}: {argv[0]} exited {run.returncode}:\n"
                         + run.stderr[-3000:])
    stages = {}
    for name, secs in TIMING.findall(run.stderr):
        stages[name] = round(stages.get(name, 0.0) + float(secs), 3)
    return wall, stages


#: newref stages timed inside another main-thread stage or on the search
#: threads, left out of the main thread's sum.
_NESTED = (".pca", ".knn", ".nulls")


def _outside(run):
    """Seconds of a newref run's wall outside its main thread's stages."""
    staged = sum(v for k, v in run["stages"].items()
                 if (k.startswith("newref.") and not k.endswith(_NESTED))
                 or k == "warmup.wait.newref")
    return run["wall_s"] - staged


def summarize(paths):
    """Print one summary line per output file of this script (see the
    module's docstring)."""
    for path in paths:
        with open(path) as f:
            lines = [json.loads(ln) for ln in f if ln.startswith("{")]
        runs = [r for r in lines if "side" in r]
        stage = next(r["stage"] for r in lines if "stage" in r)
        walls = {side: [r["wall_s"] for r in runs if r["side"] == side]
                 for side in ("parent", "change")}
        won = {"parent": 0, "change": 0}
        for a, b in zip(runs[::2], runs[1::2]):
            faster = a if a["wall_s"] < b["wall_s"] else b
            won[faster["side"]] += 1
        out = {"file": path, "walls_s": walls, "won": won,
               "median_s": {k: statistics.median(v) for k, v in walls.items()}}
        if stage == "newref":
            outside = {side: [_outside(r) for r in runs if r["side"] == side]
                       for side in walls}
            out["outside_s"] = outside
            out["outside_median_s"] = {k: statistics.median(v)
                                       for k, v in outside.items()}
        print(json.dumps(out), flush=True)


def main():
    if sys.argv[1:2] == ["--summarize"]:
        return summarize(sys.argv[2:])
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--shape", choices=sorted(SHAPES), default="main")
    ap.add_argument("--stage", choices=("newref", "predict", "predict-batch"),
                    default="newref")
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--work", default=os.path.join(REPO, "build", "newref_ab"))
    ap.add_argument("--logs", default=None)
    args = ap.parse_args()
    if args.stage != "newref" and args.shape != "main":
        raise SystemExit("torch_newref_ab: predict stages run at the main "
                         "shape only (the bench reference is refused)")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_newref_ab: needs a CUDA device")
    binsize, per_sex, seed = SHAPES[args.shape]
    work = os.path.join(args.work, args.shape)
    t0 = time.perf_counter()
    files, cases = write_cohort(work, binsize, per_sex, seed)
    print(json.dumps({"cohort_s": time.perf_counter() - t0,
                      "shape": args.shape, "stage": args.stage,
                      "controls": len(files)}), flush=True)
    sides = {"parent": os.path.abspath(args.parent),
             "change": os.path.abspath(args.change)}
    for side, path in sides.items():  # each checkout's kernels, built once
        subprocess.run(
            [sys.executable, "-c", "from wisecondorx_tpu_torch.ops import _build; "
             "_build.build()"], cwd=path, env=dict(os.environ, PYTHONPATH=path),
            check=True, timeout=600)

    def newref(out):
        return ["newref", *files, out, "--binsize", str(binsize), "--refsize",
                "300", "--device", "cuda"]

    ref = os.path.join(work, "reference.npz")
    if args.stage != "newref":
        wall, _ = run_cli(sides["parent"], newref(ref))
        print(json.dumps({"reference_s": wall, "built_by": "parent"}), flush=True)

    def command(n, side):
        out = os.path.join(work, f"{args.stage}_{n}_{side}")
        if args.stage == "newref":
            return out + ".npz", newref(out + ".npz")
        shutil.rmtree(out, ignore_errors=True)  # a run of an earlier call
        if args.stage == "predict":
            os.makedirs(out)
            return out, ["predict", cases[0], ref, os.path.join(out, "case_t21"),
                         "--bed", "--device", "cuda"]
        return out, ["predict-batch", ref, out, "--bed", "--device", "cuda",
                     "--infiles", *cases]

    order = [("parent", "change") if i % 2 == 0 else ("change", "parent")
             for i in range(args.pairs)]
    walls = {side: [] for side in sides}
    first = None
    for n, side in enumerate(s for pair in order for s in pair):
        out, argv = command(n, side)
        log = None
        if args.logs:
            os.makedirs(args.logs, exist_ok=True)
            log = os.path.join(args.logs, f"{args.stage}_{args.shape}_{n}_{side}.log")
        wall, stages = run_cli(sides[side], argv, log)
        first = first or out
        walls[side].append(wall)
        print(json.dumps({"run": n, "side": side, "wall_s": wall,
                          "differs_from_run_0": differing(out, first),
                          "stages": stages}), flush=True)
        if out != first:
            shutil.rmtree(out) if os.path.isdir(out) else os.remove(out)
    print(json.dumps({"shape": args.shape, "stage": args.stage,
                      "walls_s": walls,
                      "median_s": {k: statistics.median(v)
                                   for k, v in walls.items()}}), flush=True)


if __name__ == "__main__":
    main()
