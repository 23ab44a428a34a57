"""``predict`` one sample at a time: the lab's everyday job.

Set-up builds the reference with the port's ``newref`` and makes one
warm ``predict`` of a case of each sex (each sex loads its own gonosomal
pass).  Job ``i`` predicts the next case of a seeded cycle over the
workload's cases into its own output prefix; every job of the window is
checked.
"""

from __future__ import annotations

import os

from wcxbench.stages import common


def cases(run) -> list:
    return run.cell["cases"]


def samples_per_job(run) -> int:
    return 1


def _predict(run, case: str, outid: str) -> int:
    os.makedirs(os.path.dirname(outid), exist_ok=True)
    return run.cli(["predict", case, run.state["reference"], outid,
                    *common.predict_flags(run)])


def prepare(run) -> None:
    run.state["reference"] = common.build_reference(run)
    drawn = run.inputs["cases"]
    run.state["order"] = [drawn[i] for i in
                          common.seeded_order(len(drawn), run.seed, 1)]
    warmed = set()
    for name, path, gender, _ in drawn:
        if gender not in warmed:
            warmed.add(gender)
            code = _predict(run, path, os.path.join(run.work, "warm", name))
            if code != 0:
                raise RuntimeError(f"warm predict of {name} exited {code}")


def job(run, i: int) -> dict:
    name, path, _, _ = run.state["order"][i % len(run.state["order"])]
    outid = os.path.join(run.work, "out", f"job{i:05d}", name)
    code = _predict(run, path, outid)
    return {"samples": int(code == 0), "failed": int(code != 0),
            "outputs": [(outid, path)]}


def check(run) -> dict:
    jobs = run.jobs + (run.traced["jobs"] if run.traced else [])
    return common.check_outputs(run, [o for j in jobs for o in j["outputs"]])
