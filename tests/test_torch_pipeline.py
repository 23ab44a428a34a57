"""newref's one pipelined build in the PyTorch port, on the CPU in
float64 (``CohortSim`` as in tests/test_torch_checkpoint.py):

* a one-process build runs the pipeline (prep on the calling thread,
  search on ``wcx-search-<pass>`` threads, predict caches on a pool),
  with or without a checkpoint directory; the checkpointed build equals
  the plain one in every member, bit for bit, and the plain one equals
  the JAX package's build at test_torch_slice.py's tolerances;
* a search whose rows come to the host (from saved chunks, or an
  all-gather) and are uploaded again gives the indexes, distances and
  null ratios of the search fed directly, placeholder rows of a
  gonosomal pass included;
* the set of ``newref.*`` stage names equals the JAX package's pipelined
  build's on the same cohort, with and without a checkpoint;
* a search that fails makes ``build_reference`` and the ``newref`` CLI
  fail with its error and leaves no search thread alive;
* a multi-process build runs its searches on the calling thread, in plan
  order, under the same stage names, and builds the same reference.
"""

import copy
import os
import threading

import numpy as np
import pytest
import torch

from synthetic import CohortSim
from torch_parity import CPU
from wisecondorx_tpu.io import npz as io_npz
from wisecondorx_tpu.models.reference import NewrefConfig as JaxConfig
from wisecondorx_tpu.models.reference import build_reference as jax_build
from wisecondorx_tpu.utils import log as jlog
from wisecondorx_tpu_torch.cli import main as torch_cli
from wisecondorx_tpu_torch.models import reference
from wisecondorx_tpu_torch.models.reference import NewrefConfig, build_reference
from wisecondorx_tpu_torch.ops import mask as mask_ops
from wisecondorx_tpu_torch.utils import log as tlog


@pytest.fixture(scope="module")
def cohort():
    sim = CohortSim(binsize=1e5, genome_scale=0.006, seed=77)
    samples, _ = sim.cohort(8, 7)
    return [(s, 100000) for s in samples]


def _copy(cohort):
    return [(copy.deepcopy(s), bs) for s, bs in cohort]


def _cfg(ckpt_dir=None):
    return NewrefConfig(binsize=100000, refsize=20, checkpoint_dir=ckpt_dir,
                        knn_checkpoint_rows=1024)


def _build(cohort, cfg):
    """(passes, stage names) of one port build."""
    tlog.reset_stage_times()
    passes, _ = build_reference(_copy(cohort), cfg, CPU)
    return passes, set(tlog.stage_times())


def _search_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("wcx-search-") and t.is_alive()]


@pytest.fixture(scope="module")
def builds(cohort, tmp_path_factory):
    """{"pipelined" | "checkpointed": (passes, stage names)}."""
    return {
        "pipelined": _build(cohort, _cfg()),
        "checkpointed": _build(
            cohort, _cfg(str(tmp_path_factory.mktemp("ck") / "run"))),
    }


def _assert_passes_equal(a, b):
    assert a.keys() == b.keys()
    for g in a:
        assert a[g].keys() == b[g].keys(), g
        for k in a[g]:
            x, y = np.asarray(a[g][k]), np.asarray(b[g][k])
            assert x.dtype == y.dtype, f"{g}/{k}"
            np.testing.assert_array_equal(x, y, err_msg=f"{g}/{k}")


def test_pipelined_build_equals_the_serial_build(builds):
    """The checkpointed build, which saves its artifacts as it goes,
    equals the plain build in every member, bit for bit."""
    _assert_passes_equal(builds["pipelined"][0], builds["checkpointed"][0])


def test_checkpointed_build_searches_on_search_threads(cohort, tmp_path,
                                                       monkeypatch):
    """With a checkpoint the searches still run on their own threads,
    while the calling thread preps the next pass."""
    seen = []
    search = reference._search

    def spy(p, *args, **kwargs):
        seen.append((p.gender, threading.current_thread().name))
        return search(p, *args, **kwargs)

    monkeypatch.setattr(reference, "_search", spy)
    build_reference(_copy(cohort), _cfg(str(tmp_path / "ck")), CPU)
    assert sorted(seen) == [(g, f"wcx-search-{g}") for g in "AFM"]
    assert not _search_threads()


def test_pipelined_build_matches_jax(cohort, builds):
    """Held to the JAX package's build as test_torch_checkpoint.py holds
    the resumed build: masks and layouts equal, floats to rtol 1e-9,
    indexes equal except where the k boundary is tied."""
    passes = builds["pipelined"][0]
    want, _ = jax_build(_copy(cohort), JaxConfig(binsize=100000, refsize=20,
                                                 col_tile=128))
    assert want.keys() == passes.keys()
    for g in want:
        assert want[g].keys() == passes[g].keys(), g
        for key, w in want[g].items():
            w, got = np.asarray(w), np.asarray(passes[g][key])
            if key == "indexes":
                dist = np.asarray(want[g]["distances"])
                for r in np.nonzero((w != got).any(axis=1))[0]:
                    kth = np.sort(dist[r])[-1]
                    assert np.isclose(dist[r], kth, rtol=1e-9).sum() > 1, (g, r)
            elif w.dtype.kind == "f":
                np.testing.assert_allclose(got, w, rtol=1e-9, atol=1e-300,
                                           err_msg=f"{g}/{key}")
            else:
                np.testing.assert_array_equal(got, w, err_msg=f"{g}/{key}")


@pytest.mark.parametrize("gender", ["A", "F"])
def test_null_ratios_from_the_index_tensor_equal_the_host_table(
        cohort, gender, tmp_path, monkeypatch):
    """One prepped pass searched three ways: directly (the device tables
    of one search), from a row chunk saved as a checkpoint artifact and
    then restored, and through the multi-process route
    (``process_index_count`` patched; the all-gather of one process is
    the search itself).  The last two place host rows on the device
    before the null ratios."""
    cfg = _cfg()
    matrix, layout, genders, _, _ = reference.cohort_matrix(_copy(cohort), cfg)
    cols = (np.ones(len(genders), bool) if gender == "A"
            else np.array(genders) == gender)
    total_mask = np.array(mask_ops.get_masks(matrix, [None])[0])
    prepped = reference._prep_pass(
        gender, torch.as_tensor(matrix), cols, layout, total_mask, cfg,
        lambda g, n: np.random.default_rng([5, ord(g)]).choice(n, 6, replace=False),
        reference.NewrefCheckpoint(None),
    )
    r0 = prepped.first_row
    assert (r0 > 0) == (gender != "A")

    def search(ckpt):
        return reference._search(prepped, cfg, [CPU], ckpt, None,
                                 threading.Event())

    direct = search(reference.NewrefCheckpoint(None))
    ck = reference.NewrefCheckpoint(str(tmp_path / "ck"), "fp")
    saved = search(ck)
    chunks = [f for f in os.listdir(ck.dir) if f.startswith("knn_")]
    assert chunks == [f"knn_{gender}_{r0}_{prepped.ml.n_masked}.npz"]
    with monkeypatch.context() as mp:  # the chunk from its artifact now
        mp.setattr(reference, "knn_search_multihost", None)
        restored = search(ck)
    with monkeypatch.context() as mp:
        mp.setattr(reference, "process_index_count", lambda: (0, 2))
        gathered = search(reference.NewrefCheckpoint(None))
    for got in (saved, restored, gathered):
        assert got.keys() == direct.keys()
        for key in direct:
            np.testing.assert_array_equal(got[key], direct[key], err_msg=key)
            assert np.asarray(got[key]).dtype == np.asarray(direct[key]).dtype
        assert (got["indexes"][:r0] == 0).all()
        assert (got["distances"][:r0] == 1.0).all()


def test_stage_names_equal_the_jax_package(cohort, builds):
    """Both port builds, plain and checkpointed, keep the JAX package's
    pipelined stage names."""
    jlog.reset_stage_times()
    jax_build(_copy(cohort), JaxConfig(binsize=100000, refsize=20,
                                       col_tile=128))
    want = {s for s in jlog.stage_times() if s.startswith("newref.")}
    assert "newref.pass_F.prep" in want
    for mode in ("pipelined", "checkpointed"):
        got = {s for s in builds[mode][1] if s.startswith("newref.")}
        assert got == want, mode


def _failing_search_in_pass_f(monkeypatch):
    search = reference._search

    def failing(p, *args, **kwargs):
        if p.gender == "F":
            raise RuntimeError("search failed in pass F")
        return search(p, *args, **kwargs)

    monkeypatch.setattr(reference, "_search", failing)


def test_failing_search_fails_the_build(cohort, monkeypatch):
    _failing_search_in_pass_f(monkeypatch)
    with pytest.raises(RuntimeError, match="search failed in pass F"):
        build_reference(_copy(cohort), _cfg(), CPU)
    assert not _search_threads()


def test_failing_search_fails_the_cli(cohort, tmp_path, monkeypatch):
    infiles = []
    for i, (s, bs) in enumerate(cohort):
        path = tmp_path / f"control_{i}.npz"
        io_npz.save_sample_npz(path, bs, s, {"mapped": 1})
        infiles.append(str(path))
    _failing_search_in_pass_f(monkeypatch)
    out = tmp_path / "ref.npz"
    with pytest.raises(RuntimeError, match="search failed in pass F"):
        torch_cli(["newref", *infiles, str(out), "--refsize", "20",
                   "--device", "cpu"])
    assert not out.exists()
    assert not _search_threads()


def test_multi_process_build_stays_serial(cohort, builds, monkeypatch):
    """With two processes (``process_index_count`` patched; the all-gather
    itself sees one) no search thread starts: the searches run on this
    thread in plan order, under the one-process stage names, and the
    reference is the same."""
    monkeypatch.setattr(reference, "process_index_count", lambda: (0, 2))
    started, seen = [], []
    monkeypatch.setattr(reference, "_DaemonFuture",
                        lambda *a, **k: started.append(a))
    search = reference._search

    def spy(p, *args, **kwargs):
        seen.append((p.gender, threading.current_thread()))
        return search(p, *args, **kwargs)

    monkeypatch.setattr(reference, "_search", spy)
    passes, names = _build(cohort, _cfg())
    assert not started
    assert seen == [(g, threading.current_thread()) for g in "AFM"]
    assert names == builds["pipelined"][1]
    _assert_passes_equal(passes, builds["pipelined"][0])
