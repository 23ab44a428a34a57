"""The port's ``predict --plot`` figures against the benchmark's plain figure
reference (``wcxbench/reference/plots.py``), on the CPU at a tiny size.

Each seed draws a tiny cohort and one case (a female trisomy 21, a male
with a gain, a female deletion), builds the reference with the port's
``newref`` and runs ``predict --bed --plot``; the reference reads the
printed tables and the weights of the reference the port built, and says
where every dot and segment line must be.  Faults planted in the figure
path must fail it, and the figure stages' spans carry their counters.
"""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from wcxbench.cohort import make_inputs  # noqa: E402
from wcxbench.reference import plots as ref_plots  # noqa: E402
from wcxbench.reference.predict import load_reference, reference_bins  # noqa: E402
from wisecondorx_tpu_torch.cli import main as torch_cli  # noqa: E402
from wisecondorx_tpu_torch.output import layout as L  # noqa: E402
from wisecondorx_tpu_torch.output import plots  # noqa: E402

CONFIG = {"binsize": 50000, "genome_scale": 0.03, "reads_per_bin": 100,
          "female_controls": 12, "male_controls": 12}
FLAGS = ["--minrefbins", "10", "--zscore", "5", "--alpha", "1e-4", "--device", "cpu"]
#: (seed, case): a female trisomy 21, a male with a chr7 gain, a female
#: deletion on chr5.
CASES = {
    "female_trisomy": (2**31 + 101, {"name": "t21", "gender": "F",
                                     "cnvs": [[21, 0, "end", 3.0]]}),
    "male": (2**31 + 202, {"name": "m_gain7", "gender": "M",
                           "cnvs": [[7, 10, 60, 3.0]]}),
    "deletion": (2**31 + 303, {"name": "del5", "gender": "F",
                               "cnvs": [[5, 20, 60, 1.0]]}),
}
_BUILT = {}


def _cli(argv):
    try:
        torch_cli([str(a) for a in argv])
    except SystemExit as e:
        assert e.code in (0, None), argv


def _built(kind, tmp_path_factory):
    """(case path, counts, reference path, reference dict) of one seed,
    built once a session."""
    if kind not in _BUILT:
        seed, case = CASES[kind]
        work = str(tmp_path_factory.mktemp(kind))
        inputs = make_inputs(CONFIG, [case], seed, work)
        ref = os.path.join(work, "reference.npz")
        _cli(["newref", *inputs["controls"], ref, "--binsize", CONFIG["binsize"],
              "--refsize", 30, "--device", "cpu"])
        _, path, _, _ = inputs["cases"][0]
        _BUILT[kind] = (path, inputs["samples"][path], ref, load_reference(ref))
    return _BUILT[kind]


def _judge(kind, tmp_path_factory, outid):
    """Predict ``kind``'s case into ``outid`` and judge its figures."""
    path, counts, ref, ref_arrays = _built(kind, tmp_path_factory)
    _cli(["predict", path, ref, outid, "--bed", "--plot", *FLAGS])
    want = reference_bins(counts, ref_arrays, 5, 10, dtype=torch.float64)
    sample = ref_plots.sample_of(outid, want["w"], want["ref_gender"],
                                 want["binsize"], 5.0)
    assert sample is not None
    return sample, ref_plots.judge_figures(outid, sample)


@pytest.mark.parametrize("kind", sorted(CASES))
def test_port_figures_match_the_plain_reference(kind, tmp_path_factory):
    outid = str(tmp_path_factory.mktemp(f"{kind}_out") / "s")
    sample, out = _judge(kind, tmp_path_factory, outid)
    n_chr = 24 if kind == "male" else 23
    assert [f.name for f in sample.figures] == (
        ["genome_wide.png"] + [f"chr{c}.png" for c in
                               [str(i) for i in range(1, 23)] + ["X", "Y"][: n_chr - 22]])
    assert sorted(os.listdir(f"{outid}.plots")) == sorted(f.name for f in sample.figures)
    assert out["figures_missing"] == out["figure_size_differ"] == out["png_invalid"] == 0
    assert out["dots"] > 0.9 * np.isfinite(sample.ratio).sum()
    assert out["dots_missed"] == 0, out
    assert out["segments"] >= len(sample.segments)
    assert out["segments_differ"] == 0, out
    # The case's CNV is called, so its dots carry a call's colour.
    assert (sample.cls != ref_plots.NEUTRAL).any()


def _swap_colours(monkeypatch):
    monkeypatch.setattr(plots, "COLOR_B", plots.COLOR_C)
    monkeypatch.setattr(plots, "COLOR_C", (227 / 255, 200 / 255, 138 / 255))


def _raise_segments(monkeypatch):
    real = plots._draw_segments

    def raised(segments, chr_starts, colors, dot_size):
        out = real(segments, chr_starts, colors, dot_size)
        for a in out:
            if isinstance(a, L.Line):
                a.y = a.y + 0.05
        return out

    monkeypatch.setattr(plots, "_draw_segments", raised)


def _drop_a_chromosome(monkeypatch):
    real = plots.build_scenes
    monkeypatch.setattr(plots, "build_scenes", lambda *a, **k: [
        s for s in real(*a, **k) if s.name != "chr7.png"])


def _shift_dots(monkeypatch):
    real = plots.build_scenes

    def shifted(*a, **k):
        scenes = real(*a, **k)
        for s in scenes:
            for art in s.axes[0].artists:
                if isinstance(art, L.Scatter):
                    art.x = art.x + 1
        return scenes

    monkeypatch.setattr(plots, "build_scenes", shifted)


FAULTS = {
    "swapped_colour_class": (_swap_colours, "dots_missed"),
    "segment_drawn_too_high": (_raise_segments, "segments_differ"),
    "chromosome_figure_missing": (_drop_a_chromosome, "figures_missing"),
    "dots_shifted_by_one_bin": (_shift_dots, "dots_missed"),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_figure_fault_fails_the_reference(fault, tmp_path_factory,
                                                    monkeypatch):
    plant, number = FAULTS[fault]
    plant(monkeypatch)
    outid = str(tmp_path_factory.mktemp(f"fault_{fault}") / "s")
    _, out = _judge("female_trisomy", tmp_path_factory, outid)
    assert out[number] > 0, out


def test_the_figure_spans_carry_their_counters(tmp_path_factory):
    from torch.profiler import ProfilerActivity, profile

    from wisecondorx_tpu_torch.utils import log

    path, _, ref, _ = _built("male", tmp_path_factory)
    outid = str(tmp_path_factory.mktemp("spans") / "s")
    with profile(activities=[ProfilerActivity.CPU]):
        _cli(["predict", path, ref, outid, "--plot", *FLAGS])
        kept = log.spans()
    raster = [s for s in kept if s["name"] == "predict.plots.raster"]
    encode = [s for s in kept if s["name"] == "predict.plots.encode"]
    assert len(raster) == len(encode) == 1
    files = os.listdir(f"{outid}.plots")
    assert raster[0]["attrs"]["figures"] == len(files) == 25
    # Each figure draws at least its scatter, axis, spines and title.
    assert raster[0]["attrs"]["draws"] >= 4 * len(files)
    assert encode[0]["attrs"]["bytes"] == sum(
        os.path.getsize(os.path.join(f"{outid}.plots", f)) for f in files)
