"""``predict --bed --plot`` one sample at a time: a lab that signs out from
the figures.

The jobs are :mod:`wcxbench.stages.predict`'s (set-up, warm calls, the
seeded cycle of cases); the workload's flags add ``--plot``.  The check
holds each job's tables to the plain reference at the predict cell's
limits (:func:`table_numbers`), and its figures to the plain figure reference
(``wcxbench/reference/plots.py``), judged from the job's printed tables
and the weights of the set-up's reference, once per distinct set of
figures of a case.
"""

from __future__ import annotations

import sys

from wcxbench.stages import common
from wcxbench.stages.predict import cases, job, prepare, samples_per_job

__all__ = ["cases", "samples_per_job", "prepare", "job", "check",
           "table_numbers", "figure_numbers"]


def _outputs(run) -> list:
    jobs = run.jobs + (run.traced["jobs"] if run.traced else [])
    return [o for j in jobs for o in j["outputs"]]


def figure_numbers(run, outputs, shift: int = 0, zscore: float | None = None,
                   report: bool = False) -> dict:
    """The figure numbers of ``outputs`` ``[(outid, case path)]``.  The
    controls: ``shift`` judges each job's figures against the case
    ``shift`` places further in the cycle of drawn cases (the tables of
    its first job and its weights); ``zscore`` colours the expected dots
    at another call threshold.  ``report`` prints the dots and segment
    lines judged, against those drawn, to standard error."""
    import torch

    from wcxbench.reference.plots import FigureCheck, sample_of
    from wcxbench.reference.predict import load_reference, reference_bins

    cfg = run.config
    zscore = cfg["zscore"] if zscore is None else zscore
    ref = load_reference(run.state["reference"])
    paths = [p for _, p, _, _ in run.inputs["cases"]]
    first = {}
    for outid, case in outputs:
        first.setdefault(case, outid)

    def expect(tables_of, case):
        if tables_of is None:
            return None
        b = reference_bins(run.inputs["samples"][case], ref, cfg["maskrepeats"],
                           cfg["minrefbins"], dtype=torch.float64, device=run.device)
        return sample_of(tables_of, b["w"], b["ref_gender"], b["binsize"], zscore)

    check = FigureCheck()
    for outid, case in outputs:
        want = paths[(paths.index(case) + shift) % len(paths)]
        tables_of = outid if want == case else first.get(want)
        check.add(outid, case, lambda t=tables_of, c=want: expect(t, c))
    if report:
        t = check.totals()
        print(f"figures judged: {t['dots']} of {t['dots_drawn']} dots, "
              f"{t['segments']} of {t['segments_drawn']} segment lines, "
              f"{len(check.first)} cases", file=sys.stderr)
    return check.numbers()


def table_numbers(run, outputs) -> dict:
    """:func:`common.check_outputs`'s numbers, with the program's stored
    distances read as float64.  The program keeps a neighbour whose float32
    distance lies below the float64 cutoff (``models/ref_loader.py:
    keep_below``); under NumPy 2's promotion rules a float32 array compared
    with a Python float compares in float32, so ``excused_rows`` would take
    a distance that rounds onto the cutoff as unusable and leave that near
    tie unexcused.  Every other use reads the distances in float64.  Once
    ``excused_rows`` compares in float64 itself, this is
    ``common.check_outputs`` and goes."""
    from wcxbench.reference import predict

    load = predict.load_reference

    def float64_distances(path):
        ref = load(path)
        return {k: v.astype("float64") if k.startswith("distances") else v
                for k, v in ref.items()}

    predict.load_reference = float64_distances
    try:
        return common.check_outputs(run, outputs)
    finally:
        predict.load_reference = load


def check(run) -> dict:
    outputs = _outputs(run)
    return {**table_numbers(run, outputs),
            **figure_numbers(run, outputs, report=True)}
