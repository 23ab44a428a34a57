"""The port's streamed ReferenceLoader (models/ref_loader.py) against the
in-memory ``load_reference`` and against the JAX package's pass tables, on
references written by both packages and on one without the ``wcx_*``
caches (as the reference tool writes them):

* for A+F and A+M and ``maskrepeats`` 0, 3, 5 and 7, the loader's tables
  (sentinel indexes, PCA, weights, first target row), null ratios and
  cutoff equal ``load_reference``'s, and the sentinel indexes equal the JAX
  package's ``build_pass_tables``;
* the loader reads only the autosomal pass and the requested gonosomal one;
* with the caches present, depth 5 and depth 0 read no ``distances``
  member."""

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per xdist worker)
from synthetic import CohortSim
from torch_parity import CPU
from wisecondorx_tpu.io import npz as io_npz
from wisecondorx_tpu.models import ref_loader as jloader
from wisecondorx_tpu.models.reference import NewrefConfig as JaxNewrefConfig
from wisecondorx_tpu.models.reference import build_reference as jax_build
from wisecondorx_tpu_torch.models import ref_loader as tloader
from wisecondorx_tpu_torch.models.reference import NewrefConfig, build_reference


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_loader")
    sim = CohortSim(binsize=1e5, genome_scale=0.006, seed=41)
    samples, _ = sim.cohort(8, 7)
    cohort = [(s, 100000) for s in samples]
    built = {
        "jax": jax_build(cohort, JaxNewrefConfig(binsize=100000, refsize=25)),
        "torch": build_reference(cohort, NewrefConfig(binsize=100000, refsize=25),
                                 CPU),
    }
    passes, meta = built["jax"]
    built["bare"] = (
        {g: {k: v for k, v in p.items() if not k.startswith("wcx_")}
         for g, p in passes.items()},
        meta,
    )
    paths = {}
    for name, (passes, meta) in built.items():
        paths[name] = str(tmp / f"{name}.npz")
        io_npz.save_reference_npz(paths[name], passes, is_nipt=meta["is_nipt"],
                                  trained_cutoff=meta["trained_cutoff"])
    return paths


def _read_keys(monkeypatch):
    """Record every (gender, member) the loader reads."""
    seen = []
    orig = tloader.ReferenceLoader._member

    def spy(self, gender, key, row_start=0):
        seen.append((gender, key))
        return orig(self, gender, key, row_start)

    monkeypatch.setattr(tloader.ReferenceLoader, "_member", spy)
    return seen


@pytest.mark.parametrize("maskrepeats", [0, 3, 5, 7])
@pytest.mark.parametrize("gender", ["F", "M"])
@pytest.mark.parametrize("ref_name", ["jax", "torch", "bare"])
def test_loader_tables_equal_load_reference(refs, ref_name, gender, maskrepeats,
                                            monkeypatch):
    path = refs[ref_name]
    want = tloader.load_reference(path, CPU, maskrepeats)
    seen = _read_keys(monkeypatch)
    with tloader.ReferenceLoader(path, CPU) as loader:
        loader.start([gender], maskrepeats)
        got = {g: loader.tables(g) for g in ("A", gender)}
        nulls = {g: loader.null_ratios(g) for g in ("A", gender)}
        assert loader.cutoff() == want.cutoff
    assert {g for g, _ in seen} == {"A", gender}
    jpasses, _ = io_npz.load_reference_npz(path)
    for g, tables in got.items():
        ref_t = want.tables[g]
        assert tables.ct == ref_t.ct
        assert torch.equal(tables.sentinel_idx, ref_t.sentinel_idx), g
        assert torch.equal(tables.components, ref_t.components)
        assert torch.equal(tables.mean, ref_t.mean)
        np.testing.assert_array_equal(tables.weights, ref_t.weights)
        np.testing.assert_array_equal(nulls[g], want.passes[g]["null_ratios"])
        jax_t = jloader.build_pass_tables(jpasses[g], g, want.cutoff,
                                          upload=False, a_pass=jpasses["A"])
        np.testing.assert_array_equal(tables.sentinel_idx.numpy(),
                                      np.asarray(jax_t.sentinel_idx))
        np.testing.assert_array_equal(tables.weights, jax_t.weights)
    # Not vacuous: a finite cutoff masks some neighbour of the A pass.
    masked = bool((got["A"].sentinel_idx < 0).any())
    assert masked == (maskrepeats > 0)


@pytest.mark.parametrize("maskrepeats", [0, 5])
@pytest.mark.parametrize("ref_name", ["jax", "torch"])
def test_cached_reference_reads_no_distances(refs, ref_name, maskrepeats,
                                             monkeypatch):
    seen = _read_keys(monkeypatch)
    with tloader.ReferenceLoader(refs[ref_name], CPU) as loader:
        loader.start(["M"], maskrepeats)
        loader.tables("A"), loader.tables("M")
    assert seen and all(key != "distances" for _, key in seen), seen


def test_uncached_reference_reads_distances(refs, monkeypatch):
    """Without the caches the loader reads each needed pass's distances
    (the guard above is not vacuous)."""
    seen = _read_keys(monkeypatch)
    with tloader.ReferenceLoader(refs["bare"], CPU) as loader:
        loader.start(["F"], 5)
        loader.tables("A"), loader.tables("F")
    assert {("A", "distances"), ("F", "distances")} <= set(seen)
