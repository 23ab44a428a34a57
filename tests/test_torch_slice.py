"""The newref -> predict slice of the PyTorch port against wisecondorx_tpu,
both driven through their CLIs on the CPU (float64) from one synthetic
cohort, with the reference .npz exchanged in both directions:

* the two references: same members; masks and layouts equal; PCA,
  distances, null ratios and wcx_* caches to rtol 1e-9; indexes equal
  (a difference is allowed only where the k boundary is tied);
* predict --bed on one sample, with a JAX-built reference driving both
  predicts and a port-built reference driving both: segments and
  aberrations byte-equal, bins and statistics to rtol 1e-9;
* --plot (predict and predict-batch) and newref --plotyfrac: the JAX CLI's
  files at its pixel sizes, and no file at all when the card is missing.

One known difference breaks the byte equality on some cohorts: predict
recentres log2 ratios by their median m_lr and blanks bins whose recentred
ratio is exactly 0.  The port (like the reference tool) takes both log2s
with bit-equal functions, so the median bin of an odd count recentres to
exactly 0; the JAX package takes m_lr with XLA's log2, which differs from
numpy's by an ulp for about a third of inputs, and then keeps that bin.
Cohort seed 6 avoids it; seed 5 hits it on the port-built reference, and
that case allows exactly that difference: the one blanked bin, and the
rows of the segments that contain it (with the statistics drawn from
them: its chromosome's row, the median segment variance and the CPA
score).  test_torch_pca_normalize.py pins both halves of this down on its
own.
"""

import os

import numpy as np
import pytest

from synthetic import CohortSim
from torch_parity import CPU
from wisecondorx_tpu.cli import main as jax_cli
from wisecondorx_tpu.io import npz as io_npz
from wisecondorx_tpu_torch.cli import main as torch_cli

REFSIZE = "40"


def _slice_run(tmp, seed):
    sim = CohortSim(binsize=1e5, genome_scale=0.02, seed=seed)
    samples, _ = sim.cohort(16, 14)
    infiles = []
    for i, s in enumerate(samples):
        path = tmp / f"control_{i}.npz"
        io_npz.save_sample_npz(path, 100000, s, {"mapped": 1})
        infiles.append(str(path))
    case = str(tmp / "case.npz")
    io_npz.save_sample_npz(
        case, 100000, sim.sample("F", cnvs=[(11, 2, 30, 3.0)]), {"mapped": 1}
    )
    refs = {"jax": str(tmp / "jax_ref.npz"), "torch": str(tmp / "torch_ref.npz")}
    jax_cli(["newref", *infiles, refs["jax"], "--refsize", REFSIZE])
    torch_cli(["newref", *infiles, refs["torch"], "--refsize", REFSIZE,
               "--device", "cpu"])
    out = {}
    for ref_name, ref in refs.items():
        for cli_name, cli, extra in (("jax", jax_cli, []),
                                     ("torch", torch_cli, ["--device", "cpu"])):
            outid = str(tmp / f"{cli_name}_on_{ref_name}")
            cli(["predict", case, ref, outid, "--bed", "--minrefbins", "10",
                 *extra])
            out[cli_name, ref_name] = outid
    return tmp, refs, out, case


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return _slice_run(tmp_path_factory.mktemp("slice"), 6)


@pytest.fixture(scope="module")
def run_seed5(tmp_path_factory):
    return _slice_run(tmp_path_factory.mktemp("slice5"), 5)


def test_references_match(run):
    _, refs, _, _ = run
    j = np.load(refs["jax"], allow_pickle=True)
    t = np.load(refs["torch"], allow_pickle=True)
    assert set(j.keys()) == set(t.keys())
    for key in j.keys():
        a, b = np.asarray(j[key]), np.asarray(t[key])
        if key.startswith("indexes"):
            dist = np.asarray(j[key.replace("indexes", "distances")])
            for r in np.nonzero((a != b).any(axis=1))[0]:
                kth = np.sort(dist[r])[-1]
                assert np.isclose(dist[r], kth, rtol=1e-9).sum() > 1, (key, r)
        elif a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=1e-9, atol=1e-300,
                                       err_msg=key)
        else:
            np.testing.assert_array_equal(b, a, err_msg=key)


def _rows(path):
    return [line.rstrip("\n").split("\t") for line in open(path)]


def _assert_close_tables(got_path, want_path, keep=None):
    """Tables equal row by row, numbers to rtol 1e-9; rows where ``keep``
    is False only need the same label (first column, up to any colon)."""
    got, want = _rows(got_path), _rows(want_path)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w)
        if keep is not None and not keep[i]:
            assert g[0].split(":")[0] == w[0].split(":")[0]
            continue
        for x, y in zip(g, w):
            try:
                fx, fy = float(x), float(y)
            except ValueError:
                assert x == y
                continue
            assert fx == pytest.approx(fy, rel=1e-9, abs=1e-12, nan_ok=True), (g, w)


def _blanked_bins(got, want):
    """(chr, start, end) of the bins the port blanks (nan) where the JAX
    package prints a ratio within 1e-12 of 0."""
    return [
        (g[0], int(g[1]), int(g[2]))
        for g, w in zip(_rows(got + "_bins.bed")[1:], _rows(want + "_bins.bed")[1:])
        if g[4] == "nan" and w[4] != "nan" and abs(float(w[4])) < 1e-12
    ]


def _holds_bin(row, blanked):
    return any(row[0] == c and int(row[1]) <= s and e <= int(row[2])
               for c, s, e in blanked)


@pytest.mark.parametrize("ref_name,seed,n_blanked", [
    pytest.param("jax", 6, 0, id="jax"),
    pytest.param("torch", 6, 0, id="torch"),
    pytest.param("jax", 5, 0, id="jax-seed5"),
    pytest.param("torch", 5, 1, id="torch-seed5"),
])
def test_predict_outputs_match(request, ref_name, seed, n_blanked):
    """A JAX-built reference drives the port's predict and a port-built
    reference drives the JAX predict; each is held to the other package's
    predict on the same reference.  Only the m_lr median bin may differ,
    and only on the one cohort and reference where the ulp falls."""
    _, _, out, _ = request.getfixturevalue("run" if seed == 6 else "run_seed5")
    want, got = out["jax", ref_name], out["torch", ref_name]
    blanked = _blanked_bins(got, want)
    assert len(blanked) == n_blanked, blanked
    for suffix in ("_segments.bed", "_aberrations.bed"):
        g_rows, w_rows = _rows(got + suffix), _rows(want + suffix)
        assert [r[:3] for r in g_rows] == [r[:3] for r in w_rows], suffix
        for g, w in zip(g_rows, w_rows):
            if not _holds_bin(w, blanked):
                assert g == w, (suffix, g, w)
    keep = [not _holds_bin(r, blanked) for r in _rows(want + "_bins.bed")]
    _assert_close_tables(got + "_bins.bed", want + "_bins.bed", keep)
    # The blanked bin's chromosome row and the two scores taken over all
    # segments depend on the segment that holds it.
    from_segments = ("Median segment variance", "Copy number profile")
    blanked_chr = {c for c, _, _ in blanked}
    keep = [r[0] not in blanked_chr
            and not (blanked and r[0].startswith(from_segments))
            for r in _rows(want + "_statistics.txt")]
    _assert_close_tables(got + "_statistics.txt", want + "_statistics.txt",
                         keep)
    gains = [r for r in _rows(got + "_aberrations.bed")[1:] if r[-1] == "gain"]
    assert any(r[0] == "11" for r in gains)


def test_load_reference_takes_in_memory_passes(run):
    """``load_reference`` takes the (passes, meta) pair build_reference
    returns as well as a path; both give the same predict."""
    from wisecondorx_tpu_torch.models.predictor import PredictConfig, predict_bins
    from wisecondorx_tpu_torch.models.ref_loader import load_reference

    _, refs, _, case = run
    sample, binsize, _ = io_npz.load_sample_npz(case)
    cfg = PredictConfig(minrefbins=10)
    by_path = predict_bins(dict(sample), binsize,
                           load_reference(refs["jax"], CPU), cfg)
    in_memory = predict_bins(
        dict(sample), binsize,
        load_reference(io_npz.load_reference_npz(refs["jax"]), CPU), cfg,
    )
    for a, b in zip(by_path.results_r + by_path.results_z,
                    in_memory.results_r + in_memory.results_z):
        np.testing.assert_array_equal(a, b)


def test_gender_subcommand(run, capsys):
    tmp, refs, _, case = run
    jax_cli(["gender", case, refs["torch"]])
    want = capsys.readouterr().out
    torch_cli(["gender", case, refs["jax"]])
    assert capsys.readouterr().out == want == "female\n"


def _png_size(path):
    """(width, height) from a PNG's IHDR chunk."""
    import struct

    with open(path, "rb") as f:
        head = f.read(24)
    assert head[:8] == b"\x89PNG\r\n\x1a\n" and head[12:16] == b"IHDR"
    return struct.unpack(">II", head[16:24])


def _plot_sizes(outid):
    d = outid + ".plots"
    return {name: _png_size(os.path.join(d, name)) for name in os.listdir(d)}


@pytest.mark.parametrize("kind", ["predict", "predict-batch", "plotyfrac",
                                  "cuda-missing"])
def test_cli_writes_the_plots(run, kind, tmp_path, monkeypatch):
    """The port's --plot (predict and predict-batch) writes the JAX CLI's
    files at the JAX CLI's pixel sizes; newref --plotyfrac writes its
    figure and no reference; --plot on a missing card raises before any
    file is written."""
    import torch

    from wisecondorx_tpu_torch.output.png import read_png

    cohort, refs, _, case = run
    if kind == "plotyfrac":
        infiles = sorted(str(p) for p in cohort.glob("control_*.npz"))
        sizes = {}
        for name, cli, extra in (("jax", jax_cli, []),
                                 ("torch", torch_cli, ["--device", "cpu"])):
            png = str(tmp_path / f"{name}_yfrac.png")
            ref = str(tmp_path / f"{name}_ref.npz")
            with pytest.raises(SystemExit) as exc:
                cli(["newref", *infiles, ref, "--plotyfrac", png, *extra])
            assert exc.value.code == 0
            assert not os.path.exists(ref)
            sizes[name] = _png_size(png)
        assert sizes["torch"] == sizes["jax"] == (1600, 600)
        assert read_png(str(tmp_path / "torch_yfrac.png")).shape == (600, 1600, 3)
        return
    if kind == "cuda-missing":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        outid = str(tmp_path / "x")
        with pytest.raises(RuntimeError, match="--device cpu"):
            torch_cli(["predict", case, refs["torch"], outid, "--plot"])
        assert not os.listdir(tmp_path)
        return
    want = str(tmp_path / "jax")
    jax_cli(["predict", case, refs["jax"], want, "--bed", "--plot",
             "--minrefbins", "10"])
    if kind == "predict":
        got = str(tmp_path / "torch")
        torch_cli(["predict", case, refs["jax"], got, "--bed", "--plot",
                   "--minrefbins", "10", "--device", "cpu"])
        assert os.path.exists(got + "_bins.bed")
    else:
        outdir = tmp_path / "plate"
        torch_cli(["predict-batch", refs["jax"], str(outdir), "--plot",
                   "--minrefbins", "10", "--device", "cpu", "--infiles", case])
        got = str(outdir / "case")
        assert not os.path.exists(got + "_bins.bed")  # --plot alone
    assert _plot_sizes(got) == _plot_sizes(want)
    assert "genome_wide.png" in _plot_sizes(got)
    for name in _plot_sizes(got):
        w, h = _png_size(os.path.join(got + ".plots", name))
        assert read_png(os.path.join(got + ".plots", name)).shape == (h, w, 3)


def test_cuda_device_is_never_replaced_by_the_cpu(run, monkeypatch):
    import torch

    tmp, refs, _, case = run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        torch_cli(["predict", case, refs["jax"], str(tmp / "x"), "--bed"])
    assert not os.path.exists(str(tmp / "x_bins.bed"))
