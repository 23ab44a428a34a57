"""``newref`` over the configuration's controls: the reference build.

Set-up makes one warm build.  Each job builds the reference from all the
controls into its own file.  The check reads one build of the window,
drawn from the seed as the builds come (a reservoir of one, so that the
others are deleted between jobs, outside the time of both); every build
that exited badly or wrote nothing counts as missing.
"""

from __future__ import annotations

import os

import numpy as np

from wcxbench.stages import common


def cases(run) -> list:
    return []


def samples_per_job(run) -> int:
    return 1


def prepare(run) -> None:
    warm = os.path.join(run.work, "warm.npz")
    if run.cli(common.newref_argv(run, warm)) != 0:
        raise RuntimeError("warm newref failed")
    os.remove(warm)
    run.state["rng"] = np.random.default_rng([int(run.seed) % (1 << 63), 4])
    run.state["kept"] = None
    run.state["built"] = 0


def job(run, i: int) -> dict:
    path = os.path.join(run.work, f"build{i:05d}.npz")
    code = run.cli(common.newref_argv(run, path))
    ok = code == 0 and os.path.exists(path)
    return {"samples": int(ok), "failed": int(not ok), "outputs": [path] if ok else []}


def after(run, out: dict) -> None:
    """Between jobs, outside the timed ones: keep the new build or the
    kept one, by the reservoir's draw, and delete the other."""
    for path in out["outputs"]:
        run.state["bytes"] = os.path.getsize(path)
        run.state["built"] += 1
        if run.state["rng"].integers(run.state["built"]) == 0:
            old, run.state["kept"] = run.state["kept"], path
        else:
            old = path
        if old is not None:
            os.remove(old)


def check(run) -> dict:
    from wcxbench.reference.newref import check_reference, rebuild
    from wcxbench.reference.predict import load_reference

    jobs = run.jobs + (run.traced["jobs"] if run.traced else [])
    missing = sum(j["failed"] for j in jobs)
    kept = run.state["kept"]
    if kept is None:
        return {"builds_missing": max(missing, 1), "sex_calls_differ": 0,
                "mask_bins_differ": 0, "knn_missing_share": 1.0,
                "knn_dist_gap": float("inf"), "null_gap": float("inf"),
                "cutoff_gap": float("inf")}
    counts = [run.inputs["samples"][p] for p in run.inputs["controls"]]
    ref = load_reference(kept)
    built = rebuild(counts, run.config, device=run.device, follow=ref)
    return {"builds_missing": missing, **check_reference(ref, built, counts)}
