#!/usr/bin/env python3
"""Cold ``newref`` walls of two checkouts of the PyTorch port, in turns, on
one card.

    python3 torch_newref_ab.py PARENT_DIR CHANGE_DIR [--shape main|bench]
        [--pairs 3] [--work DIR]

Writes a ``tests/synthetic.py:CohortSim`` cohort as convert-stage npz
files (chip_smoke.py's shapes: ``main`` = 50 kb bins over the whole
genome, 100 F + 100 M controls, seed 0; ``bench`` = 15 kb bins, 250 F +
250 M, seed 2), then runs ``wisecondorx_tpu_torch.cli newref --device
cuda`` from each checkout in a fresh process, in the order parent,
change, change, parent, ... (``--pairs`` pairs), so every run pays the
cold start a user's newref pays: CUDA context, lazily loaded kernels,
the kernel build of the checkout.  Prints one JSON line per run (side,
wall of the process, the stages its ``[timing]`` lines report, the
members of its reference that differ from the first run's) and one
summary line (each side's walls and median).  Needs a CUDA device; the
JAX package is not imported.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SHAPES = {"main": (50000, 100, 0), "bench": (15000, 250, 2)}
TIMING = re.compile(r"\[timing\] (\S+): ([0-9.]+)s")


def write_cohort(work, binsize, per_sex, seed):
    import numpy as np

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from synthetic import CohortSim

    os.makedirs(work, exist_ok=True)
    samples, _ = CohortSim(binsize=binsize, genome_scale=1.0,
                           seed=seed).cohort(per_sex, per_sex)
    files = []
    for i, sample in enumerate(samples):
        files.append(os.path.join(work, f"control_{i:03d}.npz"))
        np.savez_compressed(files[-1], binsize=binsize, sample=sample,
                            quality={"mapped": 1})
    return files


def differing(path_a, path_b):
    import numpy as np

    a, b = (np.load(p, allow_pickle=True) for p in (path_a, path_b))
    diff = sorted(set(a.files) ^ set(b.files))
    for key in sorted(set(a.files) & set(b.files)):
        if a[key].dtype != b[key].dtype or a[key].tobytes() != b[key].tobytes():
            diff.append(key)
    return diff


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--shape", choices=sorted(SHAPES), default="main")
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--work", default=os.path.join(REPO, "build", "newref_ab"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_newref_ab: needs a CUDA device")
    binsize, per_sex, seed = SHAPES[args.shape]
    work = os.path.join(args.work, args.shape)
    t0 = time.perf_counter()
    files = write_cohort(work, binsize, per_sex, seed)
    print(json.dumps({"cohort_s": time.perf_counter() - t0,
                      "shape": args.shape, "controls": len(files)}), flush=True)
    sides = {"parent": os.path.abspath(args.parent),
             "change": os.path.abspath(args.change)}
    for side, path in sides.items():  # each checkout's kernels, built once
        subprocess.run(
            [sys.executable, "-c", "from wisecondorx_tpu_torch.ops import _build; "
             "_build.build()"], cwd=path, env=dict(os.environ, PYTHONPATH=path),
            check=True, timeout=600)
    order = [("parent", "change") if i % 2 == 0 else ("change", "parent")
             for i in range(args.pairs)]
    walls = {side: [] for side in sides}
    first = None
    for n, side in enumerate(s for pair in order for s in pair):
        out = os.path.join(work, f"reference_{n}_{side}.npz")
        env = dict(os.environ, PYTHONPATH=sides[side])
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-m", "wisecondorx_tpu_torch.cli", "newref", *files,
             out, "--binsize", str(binsize), "--refsize", "300",
             "--device", "cuda"],
            cwd=sides[side], env=env, capture_output=True, text=True,
            timeout=900)
        wall = time.perf_counter() - t0
        if run.returncode:
            raise SystemExit(f"{side} newref exited {run.returncode}:\n"
                             + run.stderr[-3000:])
        stages = {}
        for name, secs in TIMING.findall(run.stderr):
            stages[name] = round(stages.get(name, 0.0) + float(secs), 3)
        first = first or out
        walls[side].append(wall)
        print(json.dumps({"run": n, "side": side, "wall_s": wall,
                          "differs_from_run_0": differing(out, first),
                          "stages": stages}), flush=True)
        if out != first:
            os.remove(out)
    print(json.dumps({"shape": args.shape, "walls_s": walls,
                      "median_s": {k: statistics.median(v)
                                   for k, v in walls.items()}}), flush=True)


if __name__ == "__main__":
    main()
