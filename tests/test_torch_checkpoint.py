"""newref's checkpoint/resume in the PyTorch port, against itself and
against wisecondorx_tpu on the CPU (float64):

* a build killed after its first F-pass KNN artifact and re-run with the
  same directory resumes and equals the uninterrupted build in every
  member, and the directory is gone afterwards (as the JAX package's
  tests/test_checkpoint.py holds its own);
* a directory left by another cohort is refused;
* the resumed build equals the JAX package's build of the same cohort at
  test_torch_slice.py's tolerances;
* the port's fingerprint equals the JAX package's, on the cohort and in
  the directory each package leaves behind;
* ``newref --checkpoint-dir`` through the CLI writes the same reference
  as without it.
"""

import copy
import os

import numpy as np
import pytest

from synthetic import CohortSim
from torch_parity import CPU
from wisecondorx_tpu.io import npz as io_npz
from wisecondorx_tpu.models.reference import NewrefConfig as JaxConfig
from wisecondorx_tpu.models.reference import build_reference as jax_build
from wisecondorx_tpu.utils import checkpoint as jax_ckpt
from wisecondorx_tpu_torch.cli import main as torch_cli
from wisecondorx_tpu_torch.models.reference import (
    NewrefConfig,
    build_reference,
    cohort_matrix,
)
from wisecondorx_tpu_torch.utils import checkpoint as ckpt_mod


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


def _crash(monkeypatch, module, prefix):
    """Make ``module.NewrefCheckpoint.save`` raise right after it saves
    the first artifact whose name starts with ``prefix``."""
    orig = module.NewrefCheckpoint.save

    def crashing_save(self, name, **arrays):
        orig(self, name, **arrays)
        if name.startswith(prefix):
            raise KeyboardInterrupt("simulated crash")

    monkeypatch.setattr(module.NewrefCheckpoint, "save", crashing_save)


def _assert_passes_equal(a, b):
    assert a.keys() == b.keys()
    for g in a:
        assert a[g].keys() == b[g].keys(), g
        for k in a[g]:
            np.testing.assert_array_equal(np.asarray(a[g][k]),
                                          np.asarray(b[g][k]),
                                          err_msg=f"{g}/{k}")


@pytest.fixture(scope="module")
def resumed(cohort, tmp_path_factory):
    """(baseline passes, resumed passes, files left by the crash, the
    fingerprint the crash left)."""
    baseline, _ = build_reference(_copy(cohort), _cfg(), CPU)
    ckpt_dir = str(tmp_path_factory.mktemp("ckpt") / "run")
    with pytest.MonkeyPatch.context() as mp:
        _crash(mp, ckpt_mod, "knn_F_")
        with pytest.raises(KeyboardInterrupt):
            build_reference(_copy(cohort), _cfg(ckpt_dir), CPU)
    files = sorted(os.listdir(ckpt_dir))
    fp = open(os.path.join(ckpt_dir, "fingerprint")).read()
    passes, _ = build_reference(_copy(cohort), _cfg(ckpt_dir), CPU)
    assert not os.path.exists(ckpt_dir)
    return baseline, passes, files, fp


def test_kill_and_resume_bit_identical(resumed):
    baseline, passes, files, _ = resumed
    # The whole A pass, the F pass's PCA and its first KNN chunk.
    assert "pass_A.npz" in files and "prep_F.npz" in files
    assert any(f.startswith("knn_F_") for f in files)
    assert not any(f.startswith("pass_F") for f in files)
    _assert_passes_equal(baseline, passes)


def test_checkpoint_refuses_a_different_cohort(cohort, tmp_path, monkeypatch):
    ckpt_dir = str(tmp_path / "ckpt")
    with monkeypatch.context() as mp:
        _crash(mp, ckpt_mod, "")
        with pytest.raises(KeyboardInterrupt):
            build_reference(_copy(cohort), _cfg(ckpt_dir), CPU)
    with pytest.raises(RuntimeError, match="different cohort"):
        build_reference(_copy(cohort[:12]), _cfg(ckpt_dir), CPU)
    # The refusal leaves the other cohort's artifacts where they were.
    assert sorted(os.listdir(ckpt_dir)) == ["fingerprint", "prep_A.npz"]


def test_resumed_reference_matches_jax(cohort, resumed):
    """The JAX package's build of the same cohort (float64, its CPU path),
    held to the resumed port build as test_torch_slice.py holds the two
    CLIs' references: masks and layouts equal, floats to rtol 1e-9,
    indexes equal except where the k boundary is tied."""
    _, passes, _, _ = resumed
    want, _ = jax_build(_copy(cohort), JaxConfig(binsize=100000, refsize=20,
                                                 col_tile=128))
    assert want.keys() == passes.keys()
    for g in want:
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


def test_fingerprint_equals_jax(cohort, resumed, tmp_path, monkeypatch):
    matrix = cohort_matrix(_copy(cohort), _cfg())[0]
    jcfg = JaxConfig(binsize=100000, refsize=20)
    assert ckpt_mod.fingerprint(matrix, _cfg()) == jax_ckpt.fingerprint(matrix, jcfg)
    assert resumed[3] == jax_ckpt.fingerprint(matrix, jcfg)
    # The JAX package's own crashed build leaves the same fingerprint.
    jdir = str(tmp_path / "jax_ckpt")
    with monkeypatch.context() as mp:
        _crash(mp, jax_ckpt, "")
        with pytest.raises(KeyboardInterrupt):
            jax_build(_copy(cohort), JaxConfig(binsize=100000, refsize=20,
                                               col_tile=128,
                                               checkpoint_dir=jdir))
    assert open(os.path.join(jdir, "fingerprint")).read() == resumed[3]
    for field in (dict(refsize=21), dict(seed=1), dict(pca_components=4),
                  dict(nipt=True), dict(yfrac=0.1)):
        got = ckpt_mod.fingerprint(matrix, NewrefConfig(binsize=100000, **field))
        assert got == jax_ckpt.fingerprint(matrix, JaxConfig(binsize=100000, **field))
        assert got != resumed[3]


def test_newref_cli_with_checkpoint_dir(cohort, tmp_path):
    infiles = []
    for i, (s, bs) in enumerate(cohort):
        path = tmp_path / f"control_{i}.npz"
        io_npz.save_sample_npz(path, bs, s, {"mapped": 1})
        infiles.append(str(path))
    ckpt_dir = str(tmp_path / "ck")
    outs = [str(tmp_path / "plain.npz"), str(tmp_path / "ckpt.npz")]
    torch_cli(["newref", *infiles, outs[0], "--refsize", "20", "--device", "cpu"])
    torch_cli(["newref", *infiles, outs[1], "--refsize", "20", "--device", "cpu",
               "--checkpoint-dir", ckpt_dir])
    assert not os.path.exists(ckpt_dir)
    a, b = (np.load(p, allow_pickle=True) for p in outs)
    assert set(a.keys()) == set(b.keys())
    for key in a.keys():
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
