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
  member;
* the device translation (``translate_on_device``, run on the CPU) of the
  A, F and M passes at ``maskrepeats`` 0, 3, 5 and 10 (infinite cutoff,
  cached bits, cached or computed cutoffs), with row chunks that split
  the rows unevenly, equals the JAX package's int32 sentinel tables bit
  for bit through both of its routes: the native ``tablekit`` library
  (built here with g++) and its numpy fallback;
* a float32 distance one ulp around a float64 cutoff keeps the float64
  decision (a float32 compare flips it)."""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per xdist worker)
from synthetic import CohortSim
from torch_parity import CPU
from wisecondorx_tpu.genome import GenomeLayout as JaxGenomeLayout
from wisecondorx_tpu.genome import MaskedLayout as JaxMaskedLayout
from wisecondorx_tpu.io import bam as jax_bam
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


TABLEKIT = Path(__file__).resolve().parents[1] / "native" / "tablekit.cpp"


@pytest.fixture(scope="module")
def tablekit(tmp_path_factory):
    """The JAX package's native translation library, built from
    native/tablekit.cpp the way native/Makefile builds it."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build native/tablekit.cpp")
    so = tmp_path_factory.mktemp("tablekit") / "libtablekit.so"
    subprocess.run(["g++", "-O3", "-std=c++17", "-fPIC", "-shared", "-pthread",
                    "-o", str(so), str(TABLEKIT)], check=True)
    return ctypes.CDLL(str(so))


class _Recording:
    """A loaded library that records the names of the functions taken
    from it."""

    def __init__(self, lib):
        self._lib = lib
        self.taken = []

    def __getattr__(self, name):
        self.taken.append(name)
        return getattr(self._lib, name)


def _jax_route(route, tablekit, monkeypatch):
    """Send the JAX package's translation down ``route``: "native" (the
    tablekit library; the numpy fallback, which starts with
    ``neighbour_to_global``, raises) or "numpy" (the fallback, with the
    library off).  Returns the recording library of the native route,
    else None."""
    if route == "native":
        lib = _Recording(tablekit)
        monkeypatch.setattr(jax_bam, "_load_library", lambda: lib)

        def no_fallback(*args, **kwargs):
            raise AssertionError("the JAX package took its numpy fallback")

        monkeypatch.setattr(JaxMaskedLayout, "neighbour_to_global", no_fallback)
        return lib

    def unavailable():
        raise OSError("native library switched off")

    monkeypatch.setattr(jax_bam, "_load_library", unavailable)
    return None


@pytest.mark.parametrize("route", ["native", "numpy"])
@pytest.mark.parametrize("maskrepeats", [0, 3, 5, 10])
@pytest.mark.parametrize("gender", ["A", "F", "M"])
@pytest.mark.parametrize("ref_name", ["jax", "torch", "bare"])
def test_device_translation_equals_jax_tables(refs, ref_name, gender, maskrepeats,
                                              route, tablekit, monkeypatch):
    passes, _ = io_npz.load_reference_npz(refs[ref_name])
    a_pass, ref_pass = passes["A"], passes[gender]
    cutoff = tloader.reference_cutoff(a_pass, maskrepeats)
    ct = tloader.pass_ct(ref_pass, gender)
    rows = len(ref_pass["indexes"]) - ct
    k = ref_pass["indexes"].shape[1]
    # Chunks of 13 rows: no pass here has a multiple of 13 target rows.
    monkeypatch.setattr(tloader, "TRANSLATE_CHUNK_BYTES", 13 * k * 8)
    assert tloader.translate_chunk_rows(k) == 13 and rows % 13
    lib = _jax_route(route, tablekit, monkeypatch)
    got = tloader.build_pass_tables(ref_pass, gender, cutoff, CPU, a_pass=a_pass)
    want = jloader.build_pass_tables(ref_pass, gender, cutoff, upload=False,
                                     a_pass=a_pass)
    assert got.sentinel_idx.dtype == torch.int64
    assert np.asarray(want.sentinel_idx).dtype == np.int32
    np.testing.assert_array_equal(got.sentinel_idx.numpy(),
                                  np.asarray(want.sentinel_idx))
    np.testing.assert_array_equal(got.weights, want.weights)
    assert got.ct == want.ct == ct
    plain = tloader.plain_sentinel(ref_pass, gender, cutoff, a_pass)
    np.testing.assert_array_equal(got.sentinel_idx.numpy(), plain)
    if lib is not None:  # the native route served the JAX table
        assert {"wcx_sentinel_translate",
                "wcx_sentinel_translate_ok"} & set(lib.taken)
    uses_bits = tloader._okbits_serve(ref_pass, a_pass, cutoff)
    assert uses_bits == (maskrepeats == 5 and ref_name != "bare")
    # Not vacuous: a finite cutoff masks some neighbour of the A pass.
    if gender == "A":
        assert bool((got.sentinel_idx < 0).any()) == (maskrepeats > 0)


@pytest.mark.parametrize("chunk_rows", [1, 7, 50, None, 10**6])
@pytest.mark.parametrize("source", ["all", "bits", "dist"])
def test_translate_on_device_over_uneven_chunks(refs, source, chunk_rows):
    """translate_on_device on the A pass's rows from a row inside the
    autosomes on (a row offset, as a gonosomal pass has) equals the plain
    numpy translation for any chunk size, chunk sizes that do not divide
    the rows included."""
    passes, _ = io_npz.load_reference_npz(refs["jax"])
    ref_pass = passes["A"]
    ct = tloader.pass_ct(passes["F"], "F") // 2
    ml = tloader._masked_layout(ref_pass)
    idx = np.asarray(ref_pass["indexes"])[ct:]
    dist = np.asarray(ref_pass["distances"])[ct:]
    rows, k = idx.shape
    cutoff = float(np.atleast_1d(passes["A"]["wcx_cutoffs"])[4])
    chr_rows = ml.chr_of_masked_bin[ct:]
    starts = torch.as_tensor(ml.masked_chr_starts[chr_rows].astype(np.int64))
    sizes = torch.as_tensor(ml.masked_bins_per_chr[chr_rows].astype(np.int64))
    keep, want = None, ml.neighbour_to_global(idx, row_start=ct)
    if source == "bits":
        keep = tloader.keep_from_bits(torch.as_tensor(ref_pass["wcx_distok"][ct:]), k)
        want = tloader.translate_with_okbits(idx, ref_pass["wcx_distok"][ct:], ml, ct)
    elif source == "dist":
        keep = tloader.keep_below(torch.as_tensor(dist), cutoff)
        want = tloader.translate_and_mask(idx, dist, ml, ct, cutoff)
    got = tloader.translate_on_device(torch.as_tensor(idx), starts, sizes, keep,
                                      chunk_rows=chunk_rows)
    np.testing.assert_array_equal(got.numpy(), want)
    if source != "all":
        assert (want < 0).any() and (want >= 0).any()


@pytest.mark.parametrize("route", ["native", "numpy"])
def test_float32_distance_one_ulp_around_a_float64_cutoff(route, tablekit,
                                                         monkeypatch):
    """The cutoff sits one float64 ulp above a float32 distance ``d``, so
    float32(cutoff) == d: a float32 compare drops the neighbour at ``d``,
    the float64 compare (the JAX package's, both routes) keeps it; its
    float32 neighbours one ulp below and above are kept and dropped by
    both."""
    bins = np.full(24, 4)
    mask = np.ones(bins.sum(), dtype=bool)
    jml = JaxMaskedLayout(JaxGenomeLayout(bins), mask)
    ml = tloader._masked_layout({"bins_per_chr": bins, "mask": mask})
    rng = np.random.default_rng(8)
    rows, k = 96, 8
    idx = rng.integers(0, 92, (rows, k)).astype(np.int32)
    d = np.float32(2.5)
    cutoff = float(np.nextafter(np.float64(d), np.inf))
    assert np.float32(cutoff) == d
    below = np.nextafter(d, np.float32(-np.inf))
    above = np.nextafter(d, np.float32(np.inf))
    dist = rng.choice(np.array([below, d, above], dtype=np.float32), (rows, k))
    dist[0, :3] = [below, d, above]
    dist_t = torch.as_tensor(dist)
    # A float32 compare would flip the neighbours at exactly d.
    assert not bool((dist_t < torch.tensor(cutoff, dtype=torch.float32))[0, 1])
    keep = tloader.keep_below(dist_t, cutoff)
    assert keep(0, 1)[0].tolist()[:3] == [True, True, False]
    lib = _jax_route(route, tablekit, monkeypatch)
    want = jloader.translate_and_mask(idx, dist, jml, 0, cutoff)
    if lib is not None:
        assert "wcx_sentinel_translate" in lib.taken
    chr_rows = ml.chr_of_masked_bin
    got = tloader.translate_on_device(
        torch.as_tensor(idx),
        torch.as_tensor(ml.masked_chr_starts[chr_rows].astype(np.int64)),
        torch.as_tensor(ml.masked_bins_per_chr[chr_rows].astype(np.int64)),
        keep, chunk_rows=10)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[dist == d] >= 0).all() and (want[dist == above] == -1).all()
