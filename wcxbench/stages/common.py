"""What the stage modules share: the reference build of the predict
stages' set-up, the predict flags of a configuration, and the check of
predict tables, and of the reference they read, against the plain
reference's own rebuild."""

from __future__ import annotations

import os
import time

import numpy as np


def newref_argv(run, outfile: str) -> list:
    cfg = run.config
    argv = ["newref", *run.inputs["controls"], outfile,
            "--binsize", cfg["binsize"], "--refsize", cfg["refsize"]]
    return argv + (["--nipt"] if cfg["nipt"] else [])


def build_reference(run) -> str:
    """The reference ``.npz`` the predict traffic needs, built by the
    port's ``newref`` from the cell's controls."""
    path = os.path.join(run.work, "reference.npz")
    t = time.perf_counter()
    code = run.cli(newref_argv(run, path))
    if code != 0 or not os.path.exists(path):
        raise RuntimeError(f"newref of the set-up exited {code}")
    run.setup["reference_s"] = time.perf_counter() - t
    return path


def predict_flags(run) -> list:
    cfg = run.config
    return ["--alpha", cfg["alpha"], "--zscore", cfg["zscore"],
            "--minrefbins", cfg["minrefbins"], "--maskrepeats", cfg["maskrepeats"],
            *run.cell["flags"]]


def check_outputs(run, outputs) -> dict:
    """The comparison numbers of predict outputs ``[(outid, case path)]``
    against the plain reference, computed once per distinct case, and of
    the reference the set-up built (``ref_``)."""
    import torch

    from wcxbench.reference.compare import PredictCheck
    from wcxbench.reference.newref import check_reference, rebuild
    from wcxbench.reference.predict import excused_rows, load_reference, reference_bins

    cfg = run.config
    program_ref = load_reference(run.state["reference"])
    counts = [run.inputs["samples"][p] for p in run.inputs["controls"]]
    # The float64 rebuild from the controls; the program's reference gives
    # only the PCA filter's decisions that float32 leaves open.
    built = rebuild(counts, cfg, torch.float64, device=run.device, follow=program_ref)
    numbers = {f"ref_{k}": v for k, v in
               check_reference(program_ref, built, counts).items()}
    excused = excused_rows(program_ref, built["arrays"], cfg["maskrepeats"],
                           run.device)
    run.state["excused_rows"] = {k: int(v.sum()) for k, v in excused.items()}
    own = {**built["arrays"], **excused, "_cache": {}}
    del built
    # The reference runs on the run's device: on the card its CBS draws the
    # program's permutation stream.
    device = run.device
    check = PredictCheck(cfg["alpha"], cfg["zscore"], device)
    expected = {}
    for outid, case in outputs:
        if case not in expected:
            bins = lambda ref: reference_bins(
                run.inputs["samples"][case], ref, cfg["maskrepeats"],
                cfg["minrefbins"], dtype=torch.float64, device=device)
            expected[case] = (bins(own), bins(program_ref))
        check.add(outid, *expected[case])
    return {**check.numbers(), **numbers}


def seeded_order(n: int, seed: int, salt: int) -> np.ndarray:
    """A permutation of ``range(n)`` drawn from the run's seed."""
    return np.random.default_rng([int(seed) % (1 << 63), salt]).permutation(n)
