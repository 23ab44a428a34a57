"""``cnv50_predict_plot`` at a tiny size on the CPU: figure faults planted
in the program fail its check, the figure controls fail where the program
passes, and its pieces load neither JAX nor (the reference) the port."""

import subprocess
import sys

import pytest

from wcxbench import run, spec

from conftest import ROOT, tiny

CELL = "cnv50_predict_plot"
SEED = 2**31 + 12345
FIGURE_NUMBERS = ("figures_missing", "figure_size_differ", "png_invalid",
                  "figures_nondeterministic", "dot_class_miss_share",
                  "segment_rows_differ")


def _run(trace=False):
    return run.run_cell(CELL, SEED, 1.0, trace, device="cpu", overrides=tiny(CELL))


def _after_setup(monkeypatch, target, name, fault):
    """Plant ``fault`` as ``target.name`` once the set-up is done."""
    stage = spec.stage(spec.workload(CELL)["stage"])
    prepare = stage.prepare

    def prepare_then_break(r):
        prepare(r)
        monkeypatch.setattr(target, name, fault)

    monkeypatch.setattr(stage, "prepare", prepare_then_break)


def test_the_cell_checks_the_tables_and_the_figures():
    limits = spec.workload(CELL)["limits"]
    bed = spec.workload("cnv50_predict_bed")["limits"]
    assert {k: v for k, v in limits.items() if k in bed} == bed
    assert set(limits) == set(bed) | set(FIGURE_NUMBERS)


def test_float64_distances_excuse_a_neighbour_that_rounds_onto_the_cutoff(monkeypatch):
    """The program keeps a neighbour whose float32 distance lies below the
    float64 cutoff; compared as float32 (NumPy 2 with a Python float) the
    distance rounds onto the cutoff and the near tie goes unexcused."""
    import numpy as np

    from wcxbench.reference import predict

    cut = 3.796052486865633
    assert float(np.float32(cut)) < cut
    monkeypatch.setattr(predict, "optimal_cutoff", lambda d, r: cut)
    want = {"indexes": np.array([[5, 7]]), "distances": np.array([[1.0, cut + 1e-9]]),
            "ties": np.array([False])}
    got = {"indexes": np.array([[5, 7]], np.int32),
           "distances": np.array([[1.0, cut]], np.float32)}
    as32 = predict.excused_rows(got, dict(want), 5)["undetermined_rows"]
    got64 = {**got, "distances": got["distances"].astype("float64")}
    as64 = predict.excused_rows(got64, dict(want), 5)["undetermined_rows"]
    assert not as32[0] and as64[0]


def test_swapped_colour_classes_fail_the_plot_check(monkeypatch):
    from wisecondorx_tpu_torch.output import plots

    _after_setup(monkeypatch, plots, "COLOR_C", plots.COLOR_B)
    result = _run()
    assert not result["correct"]
    c = result["checks"]["dot_class_miss_share"]
    assert c["value"] > c["limit"]
    assert result["checks"]["calls_differ"]["value"] == 0


def test_segment_lines_drawn_too_high_fail_the_plot_check(monkeypatch):
    from wisecondorx_tpu_torch.output import layout, plots

    real = plots._draw_segments

    def raised(*args):
        out = real(*args)
        for a in out:
            if isinstance(a, layout.Line):
                a.y = a.y + 0.05
        return out

    _after_setup(monkeypatch, plots, "_draw_segments", raised)
    result = _run()
    assert not result["correct"]
    assert result["checks"]["segment_rows_differ"]["value"] > 0


def test_a_traced_run_reads_the_figure_counters():
    result = _run(trace=True)
    assert result["correct"], result["checks"]
    assert result["metrics"]["plot_s.predict"]["value"] > 0
    # Every figure draws at least its scatter, axis, spines and title.
    assert result["metrics"]["plot.draws.predict"]["value"] >= 4 * 24


def test_the_figure_controls_fail_where_the_program_passes():
    from wcxbench import plot_control

    limits = spec.workload(CELL)["limits"]
    out = plot_control.readings(SEED, "cpu", tiny(CELL))
    assert all(v <= limits[k] for k, v in out["program"].items() if k in limits), out
    for k in ("dot_class_miss_share", "segment_rows_differ"):
        assert out["next"][k] > limits[k], out["next"]


@pytest.mark.parametrize("module,barred", [
    ("wcxbench.reference.plots", {"wisecondorx_tpu_torch", "jax", "wisecondorx_tpu"}),
    ("wcxbench.stages.predict_plot, wcxbench.plot_control", {"jax", "wisecondorx_tpu"}),
])
def test_the_plot_pieces_load_no_jax(module, barred):
    out = subprocess.run(
        [sys.executable, "-c", f"import {module}\nimport sys\n"
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert not set(out.stdout.split()) & barred
