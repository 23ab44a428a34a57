"""Tiny-size runs of every stage module on the CPU through the plain
paths, the faults the check must catch, and the control."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from wcxbench import run, spec

from conftest import ROOT, tiny

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
SEED = 2**31 + 12345


def _run(cell, trace=False):
    return run.run_cell(cell, SEED, 1.0, trace, device="cpu", overrides=tiny(cell))


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_run_is_correct(cell):
    result = _run(cell, trace=True)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "checks"
    # A CPU run reports no number that only a card can give.
    bench = spec.benchmark()
    device_metrics = {m["name"] for m in bench["per_layer"]
                      if m["source"] == "device_trace"}
    assert not set(result["metrics"]) & device_metrics
    assert result["device"]["busy_s"] == 0.0


def test_untraced_run_reports_the_end_to_end_metrics():
    result = _run("cnv50_predict_bed")
    assert set(result["metrics"]) == {"predict_s", "predict_p95_s", "setup_s"}
    assert all(m["value"] > 0 for m in result["metrics"].values())


def test_the_measuring_path_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(run.Abort, match="CUDA"):
        run.run_cell(CELLS[0], SEED, 1.0, False)
    out = subprocess.run([sys.executable, "-m", "wcxbench.run", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""


def test_a_checkout_of_the_benchmark_alone_refuses(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "wcxbench"), tmp_path / "wcxbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "wcxbench.run", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""


# -- the faults the check must catch, planted in the program -----------------


def _after_setup(monkeypatch, cell, target, name, fault):
    """Plant ``fault`` as ``target.name`` once the cell's set-up is done:
    under the timed path only."""
    stage = spec.stage(spec.workload(cell)["stage"])
    prepare = stage.prepare

    def prepare_then_break(r):
        prepare(r)
        monkeypatch.setattr(target, name, fault)

    monkeypatch.setattr(stage, "prepare", prepare_then_break)


def test_an_altered_ratio_fails_the_predict_check(monkeypatch):
    from wisecondorx_tpu_torch.models import predictor

    real = predictor._log_trans

    def altered(*args):
        r, z, w, nr = real(*args)
        r[0] = np.where(r[0] != 0, r[0] + 0.1, 0.0)
        return r, z, w, nr

    _after_setup(monkeypatch, "cnv50_predict_bed", predictor, "_log_trans", altered)
    result = _run("cnv50_predict_bed")
    assert not result["correct"]
    assert result["checks"]["ratio_gap_max"]["value"] >= 0.1 - 1e-6


def test_an_altered_call_fails_the_predict_check(monkeypatch):
    from wisecondorx_tpu_torch.output import tables

    real = tables._generate_segments_and_aberrations_bed

    def altered(outid, bins, segments, cfg):
        real(outid, bins, segments, cfg)
        with open(f"{outid}_aberrations.bed", "a") as f:
            f.write("1\t1\t50000\t0.5\t9.0\tgain\n")

    _after_setup(monkeypatch, "cnv50_predict_bed", tables,
                 "_generate_segments_and_aberrations_bed", altered)
    result = _run("cnv50_predict_bed")
    assert not result["correct"]
    assert result["checks"]["calls_differ"]["value"] > 0


def test_half_the_plate_left_out_fails_the_batch_check(monkeypatch):
    from wisecondorx_tpu_torch.parallel import batch

    real = batch.predict_batch

    def half(samples, *args, **kwargs):
        out = real(samples, *args, **kwargs)
        return out[: len(out) // 2] + [None] * (len(out) - len(out) // 2)

    _after_setup(monkeypatch, "nipt100_batch48", batch, "predict_batch", half)
    result = _run("nipt100_batch48")
    assert not result["correct"]
    assert result["checks"]["samples_missing"]["value"] > 0
    assert result["failed"] > 0


def test_a_search_that_returns_its_state_unchanged_fails_the_newref_check(monkeypatch):
    from wisecondorx_tpu_torch.models import reference

    real = reference.knn_search_multidevice

    def unchanged(*args, **kwargs):
        idx, dist = real(*args, **kwargs)
        return torch.zeros_like(idx), torch.ones_like(dist)

    _after_setup(monkeypatch, "cnv50_newref", reference, "knn_search_multidevice",
                 unchanged)
    result = _run("cnv50_newref")
    assert not result["correct"]
    assert result["checks"]["knn_missing_share"]["value"] > 0.5


# -- faults in the reference the set-up built: the predict check rebuilds its
# own, so tables the program made wrong fail it --------------------------------


def test_altered_null_ratios_of_the_set_up_reference_fail_the_predict_check(monkeypatch):
    from wisecondorx_tpu_torch.models import reference

    real = reference.knn_ops.compute_null_ratios
    monkeypatch.setattr(reference.knn_ops, "compute_null_ratios",
                        lambda *a, **k: real(*a, **k) + 0.05)
    result = _run("cnv50_predict_bed")
    assert not result["correct"]
    assert result["checks"]["ref_null_gap"]["value"] >= 0.05 - 1e-9


def test_altered_pca_components_of_the_set_up_reference_fail_the_predict_check(monkeypatch):
    from wisecondorx_tpu_torch.models import reference

    real = reference.pca_ops.train_pca

    def tilted(*args, **kwargs):
        corrected, components, mean = real(*args, **kwargs)
        return corrected, components * 1.01, mean

    monkeypatch.setattr(reference.pca_ops, "train_pca", tilted)
    result = _run("cnv50_predict_bed")
    assert not result["correct"]
    assert result["checks"]["ratio_gap_max"]["value"] > result["checks"]["ratio_gap_max"]["limit"]


# -- the control: the reference one precision down must fail -----------------


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_where_the_program_passes(cell):
    from wcxbench import control

    limits = spec.workload(cell)["limits"]
    out = control.readings(cell, 3, "cpu", tiny(cell))
    assert all(v <= limits[k] for k, v in out["program"].items() if k in limits), out
    assert any(v > limits[k] for k, v in out["control"].items()), out["control"]
