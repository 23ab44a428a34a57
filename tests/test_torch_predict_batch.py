"""The port's ``predict-batch`` and ``convert`` against the JAX CLI's, on
the CPU:

* ``predict-batch`` on a plate with a corrupt and a partial sample: both
  CLIs exit 3 and log the same failures; each good sample's tables match
  the JAX CLI's at the tolerances of tests/test_cli_end_to_end.py (bins
  rtol 1e-8, segments rtol 5e-2, calls equal), and the port's own
  single-sample ``predict``'s exactly (segments and aberrations
  byte-equal, bins to rtol 1e-12);
* the batched normalization over a sample axis, from the streamed loader,
  equals the one-sample path on the in-memory reference;
* ``convert`` writes the JAX CLI's ``.npz`` from a BAM written by
  tests/bamtools.py."""

import logging
import os

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per xdist worker)
from bamtools import bam_record, write_bam
from statutil import assert_bed_rows_close, bed_rows
from synthetic import CohortSim
from torch_parity import CPU
from wisecondorx_tpu.cli import main as jax_cli
from wisecondorx_tpu.io import npz as io_npz
from wisecondorx_tpu_torch.cli import main as torch_cli

GOOD = ("case", "case2")


class _ErrorLog(logging.Handler):
    """The messages of ERROR records logged while it is attached."""

    def __init__(self):
        super().__init__(logging.ERROR)
        self.messages = []
        logging.getLogger().addHandler(self)

    def emit(self, record):
        self.messages.append(record.getMessage())


@pytest.fixture(scope="module")
def plate(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_batch")
    sim = CohortSim(binsize=1e5, genome_scale=0.006, seed=99)
    samples, _ = sim.cohort(8, 7)
    infiles = []
    for i, s in enumerate(samples):
        path = tmp / f"control_{i}.npz"
        io_npz.save_sample_npz(path, 100000, s, {"mapped": 1})
        infiles.append(str(path))
    ref = str(tmp / "reference.npz")
    jax_cli(["newref", *infiles, ref, "--refsize", "25"])
    cases = {"case": sim.sample("M", cnvs=[(18, 1, 5, 3.0)]),
             "case2": sim.sample("F", cnvs=[(9, 2, 6, 3.0)])}
    paths = {}
    for name, s in cases.items():
        paths[name] = str(tmp / f"{name}.npz")
        io_npz.save_sample_npz(paths[name], 100000, s, {"mapped": 1})
    corrupt = tmp / "corrupt.npz"
    corrupt.write_bytes(b"not a zip at all")
    # A valid npz missing chromosomes: it fails at preparation.
    partial = str(tmp / "partial.npz")
    io_npz.save_sample_npz(partial, 100000, {"1": np.ones(5, dtype=np.int32)},
                           {"mapped": 1})
    plate_files = [str(corrupt), paths["case"], partial, paths["case2"]]
    flags = ["--minrefbins", "10", "--bed", "--seed", "7"]
    out, errors = {}, {}
    for name, cli, extra in (("jax", jax_cli, []),
                             ("torch", torch_cli, ["--device", "cpu"])):
        out[name] = str(tmp / f"{name}_batch")
        records = _ErrorLog()
        try:
            with pytest.raises(SystemExit) as exc:
                cli(["predict-batch", ref, out[name], "--infiles", *plate_files,
                     *flags, *extra])
        finally:
            logging.getLogger().removeHandler(records)
        assert exc.value.code == 3, name
        errors[name] = [m for m in records.messages if m.startswith("Skipping")]
    singles = {}
    for name, path in paths.items():
        singles[name] = str(tmp / f"single_{name}")
        torch_cli(["predict", path, ref, singles[name], *flags, "--device", "cpu"])
    return tmp, ref, paths, out, errors, singles


def test_batch_logs_the_same_failures(plate):
    _, _, _, _, errors, _ = plate
    assert errors["torch"] == errors["jax"]
    assert len(errors["torch"]) == 2
    assert "corrupt.npz" in errors["torch"][0]
    assert "missing chromosome" in errors["torch"][1]


def _assert_same_outputs(got, want):
    for suffix, rtol, atol in (("_bins.bed", 1e-8, 1e-9),
                               ("_segments.bed", 5e-2, 5e-3)):
        assert_bed_rows_close(got + suffix, want + suffix, rtol=rtol, atol=atol)
    got_calls = [(r[0], r[-1]) for r in bed_rows(got + "_aberrations.bed")]
    want_calls = [(r[0], r[-1]) for r in bed_rows(want + "_aberrations.bed")]
    assert got_calls == want_calls


@pytest.mark.parametrize("name", GOOD)
def test_batch_matches_jax_batch(plate, name):
    _, _, _, out, _, _ = plate
    got = os.path.join(out["torch"], name)
    _assert_same_outputs(got, os.path.join(out["jax"], name))
    gains = [r[0] for r in bed_rows(got + "_aberrations.bed") if r[-1] == "gain"]
    assert {"case": "18", "case2": "9"}[name] in gains


@pytest.mark.parametrize("name", GOOD)
def test_batch_matches_single_predict(plate, name):
    """Batching changes no number: the draws are keyed per segment and the
    batched normalization is the one-sample one on a sample axis."""
    _, _, _, out, _, singles = plate
    got = os.path.join(out["torch"], name)
    for suffix in ("_segments.bed", "_aberrations.bed"):
        with open(got + suffix, "rb") as g, open(singles[name] + suffix, "rb") as w:
            assert g.read() == w.read(), suffix
    assert_bed_rows_close(got + "_bins.bed", singles[name] + "_bins.bed",
                          rtol=1e-12, atol=1e-15)


def test_no_output_for_failed_samples(plate):
    _, _, _, out, _, _ = plate
    written = sorted(os.listdir(out["torch"]))
    assert {f.split("_")[0] for f in written} == set(GOOD)


@pytest.mark.parametrize("chunk", [1, 8])
def test_batched_normalize_equals_single(plate, chunk):
    """predict_batch normalizes ``chunk`` samples on one sample axis; each
    sample's bins equal predict_bins on the same reference tables."""
    from wisecondorx_tpu_torch.models.predictor import PredictConfig, predict_bins
    from wisecondorx_tpu_torch.models.ref_loader import load_reference
    from wisecondorx_tpu_torch.parallel.batch import predict_batch

    _, ref, paths, _, _, _ = plate
    cfg = PredictConfig(minrefbins=10)
    loaded = [io_npz.load_sample_npz(paths[n])[:2] for n in GOOD]
    batch = predict_batch([(dict(s), b) for s, b in loaded * 2], ref, cfg,
                          [CPU], chunk=chunk)
    dref = load_reference(ref, CPU)
    for i, (s, b) in enumerate(loaded * 2):
        want = predict_bins(dict(s), b, dref, cfg)
        got = batch[i]
        assert (got.ref_gender, got.gender) == (want.ref_gender, want.gender)
        for field in ("results_r", "results_z", "results_w", "results_nr"):
            for g, w in zip(getattr(got, field), getattr(want, field)):
                np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-15)


def test_predict_batch_on_cuda_without_a_card_raises(plate, monkeypatch):
    tmp, ref, paths, _, _, _ = plate
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    outdir = str(tmp / "no_card")
    with pytest.raises(RuntimeError, match="--device cpu"):
        torch_cli(["predict-batch", ref, outdir, "--infiles", paths["case"],
                   "--bed"])
    assert not os.path.exists(os.path.join(outdir, "case_bins.bed"))


REFS = [("chr1", 60000), ("chr2", 30000), ("chrX", 20000), ("chrY", 9000),
        ("chrM", 1000)]


@pytest.mark.parametrize("normdup", [False, True])
def test_convert_matches_jax(tmp_path, normdup):
    rng = np.random.default_rng(17)
    records = []
    for _ in range(600):
        ref = int(rng.integers(0, len(REFS)))
        pos = int(rng.integers(0, REFS[ref][1]))
        flag = int(rng.choice([0, 0x1 | 0x2, 0x1, 0x4]))
        mate = pos + int(rng.integers(-400, 400)) if flag & 0x1 else -1
        records.append(bam_record(ref, pos, int(rng.choice([0, 10, 60])), flag,
                                  ref if flag & 0x1 else -1, mate))
        if rng.random() < 0.1:  # a duplicate of the record just written
            records.append(records[-1])
    bam = str(tmp_path / "reads.bam")
    write_bam(bam, REFS, records)
    extra = ["--normdup"] if normdup else []
    outs = {}
    for name, cli in (("jax", jax_cli), ("torch", torch_cli)):
        outs[name] = str(tmp_path / f"{name}.npz")
        cli(["convert", bam, outs[name], "--binsize", "5000", *extra])
    want, got = (io_npz.load_sample_npz(outs[n]) for n in ("jax", "torch"))
    assert got[1:] == want[1:]  # binsize, quality counters
    assert got[0].keys() == want[0].keys()
    for key, w in want[0].items():
        if w is None:
            assert got[0][key] is None
        else:
            np.testing.assert_array_equal(got[0][key], w)
    assert sum(int(v.sum()) for v in got[0].values() if v is not None) > 100
