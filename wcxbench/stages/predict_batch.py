"""``predict-batch`` of a plate: how a screening lab scores a sequencing
run.

Set-up builds the reference with the port's ``newref`` and scores the
plate's first 8 samples (one normalization chunk: the warm call).  Each job scores the whole plate, in a seeded
order of its files, into its own output directory.  The check reads a
seeded sample of the plate's samples, every sample with a planted event
among them, in every job of the window.
"""

from __future__ import annotations

import os

from wcxbench.stages import common

#: Samples of the warm call: one chunk of predict-batch's default --chunk.
WARM = 8


def cases(run) -> list:
    return run.cell["plate"]


def samples_per_job(run) -> int:
    return len(run.inputs["cases"])


def _outid(outdir: str, path: str) -> str:
    return os.path.join(outdir, os.path.basename(path)[: -len(".npz")])


def _score(run, outdir: str, drawn: list) -> int:
    files = [path for _, path, _, _ in drawn]
    return run.cli(["predict-batch", run.state["reference"], outdir,
                    "--infiles", *files, *common.predict_flags(run)])


def prepare(run) -> None:
    run.state["reference"] = common.build_reference(run)
    drawn = run.inputs["cases"]
    run.state["order"] = [drawn[i] for i in
                          common.seeded_order(len(drawn), run.seed, 2)]
    planted = [d for d in drawn if d[3]]
    rest = [d for d in drawn if not d[3]]
    k = max(0, int(run.cell["check_samples"]) - len(planted))
    pick = common.seeded_order(len(rest), run.seed, 3)[:k]
    run.state["checked"] = planted + [rest[i] for i in sorted(pick)]
    # One normalization chunk of the plate (8 samples) warms every shape
    # the plate's passes take.
    code = _score(run, os.path.join(run.work, "warm"), run.state["order"][:WARM])
    if code != 0:
        raise RuntimeError(f"warm predict-batch exited {code}")


def job(run, i: int) -> dict:
    outdir = os.path.join(run.work, "out", f"job{i:05d}")
    code = _score(run, outdir, run.state["order"])
    n = len(run.state["order"])
    written = sum(os.path.exists(_outid(outdir, p) + "_bins.bed")
                  for _, p, _, _ in run.state["order"]) if code in (0, 3) else 0
    return {"samples": written, "failed": n - written,
            "outputs": [(_outid(outdir, p), p) for _, p, _, _ in run.state["checked"]]}


def check(run) -> dict:
    jobs = run.jobs + (run.traced["jobs"] if run.traced else [])
    return common.check_outputs(run, [o for j in jobs for o in j["outputs"]])
