"""newref's pipelined passes in the PyTorch port, on the CPU in float64
(``CohortSim`` as in tests/test_torch_checkpoint.py):

* a one-process build without a checkpoint directory runs the pipeline
  (prep on the calling thread, search on ``wcx-search-<pass>`` threads,
  predict caches on a pool) and equals the serial, checkpointed build in
  every member, bit for bit, and the JAX package's build at
  test_torch_slice.py's tolerances;
* the null ratios computed from the search's index tensor equal those of
  the serial build's host table, placeholder rows of a gonosomal pass
  included;
* the set of ``newref.*`` stage names equals the JAX package's on the
  same cohort, pipelined and checkpointed;
* a search that fails makes ``build_reference`` and the ``newref`` CLI
  fail with its error and leaves no search thread alive;
* a multi-process build stays serial.
"""

import copy
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
    _assert_passes_equal(builds["pipelined"][0], builds["checkpointed"][0])


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
def test_null_ratios_from_the_index_tensor_equal_the_host_table(cohort, gender):
    """One prepped pass searched both ways: the pipeline's device search
    (null ratios from the index tensor, ``placeholder_rows`` prepended on
    the device) and the serial build's host-table search."""
    cfg = _cfg()
    matrix, layout, genders, _, _ = reference.cohort_matrix(_copy(cohort), cfg)
    cols = (np.ones(len(genders), bool) if gender == "A"
            else np.array(genders) == gender)
    total_mask = np.array(mask_ops.get_masks(matrix, [None])[0])
    prepped = reference._prep_pass(
        gender, torch.as_tensor(matrix), cols, layout, total_mask, cfg,
        lambda g, n: np.random.default_rng([5, ord(g)]).choice(n, 6, replace=False),
    )
    r0 = prepped.first_row
    assert (r0 > 0) == (gender != "A")
    host = reference._search_host(prepped, cfg, [CPU],
                                  reference.NewrefCheckpoint(None))
    device = reference._search_device(prepped, cfg, [CPU], None,
                                      threading.Event())
    assert host.keys() == device.keys()
    for key in host:
        np.testing.assert_array_equal(device[key], host[key], err_msg=key)
        assert np.asarray(device[key]).dtype == np.asarray(host[key]).dtype
    assert (device["indexes"][:r0] == 0).all()
    assert (device["distances"][:r0] == 1.0).all()


def test_stage_names_equal_the_jax_package(cohort, builds, tmp_path):
    for mode, ckpt_dir in (("pipelined", None),
                           ("checkpointed", str(tmp_path / "jax_ck"))):
        jlog.reset_stage_times()
        jax_build(_copy(cohort), JaxConfig(binsize=100000, refsize=20,
                                           col_tile=128,
                                           checkpoint_dir=ckpt_dir))
        want = {s for s in jlog.stage_times() if s.startswith("newref.")}
        got = {s for s in builds[mode][1] if s.startswith("newref.")}
        assert got == want, mode
    assert "newref.pass_F.prep" in builds["pipelined"][1]
    assert "newref.pass_F" in builds["checkpointed"][1]


def _failing_search_in_pass_f(monkeypatch):
    search = reference._search_device

    def failing(p, *args, **kwargs):
        if p.gender == "F":
            raise RuntimeError("search failed in pass F")
        return search(p, *args, **kwargs)

    monkeypatch.setattr(reference, "_search_device", failing)


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
    """With two processes (``process_index_count`` patched; the search
    itself sees one) the passes run one after another on this thread,
    under the serial stage names, and the reference is the same."""
    monkeypatch.setattr(reference, "process_index_count", lambda: (0, 2))
    started = []
    monkeypatch.setattr(reference, "_DaemonFuture",
                        lambda *a, **k: started.append(a))
    passes, names = _build(cohort, _cfg())
    assert not started
    assert {"newref.pass_A", "newref.pass_A.knn", "newref.pass_M.nulls"} <= names
    assert not any(s.endswith((".prep", ".search")) for s in names)
    _assert_passes_equal(passes, builds["pipelined"][0])
