"""The plain versions of the CBS kernels (ops/cbs.py) against the JAX
package's arc statistic, and the wrappers' dispatch, on the CPU.

* ``max_t_rows_reference`` equals ``_max_t_rows_impl`` (x64) to rtol 1e-12
  with the same NaN and -inf positions, on ``chip_smoke.cbs_arc_rows``
  (rows without a valid arc, zero-weight slots that make NaN, rows that
  tie) at n_pad 8 to 2,048, for the exact, thin and short length families
  and kmax 0 and 25;
* ``locate_rows_reference`` equals ``_tstat_scan(want_argmax=True)``,
  a length with a NaN arc and ties included;
* on a CUDA tensor a wrapper launches its kernel or raises: with the
  device check patched to the card's and a library that does not build,
  each wrapper raises the build's error (no plain result), and so do the
  predict and predict-batch commands, which write no BED file; on a CPU
  tensor a wrapper takes the plain version and never loads the library.

The kernels themselves run only on the card (tests/test_torch_cuda.py,
chip_smoke.py's ``cbs_stream`` phase)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import torch_parity  # noqa: F401  (one torch thread per xdist worker)
from synthetic import CohortSim
from wisecondorx_tpu.ops import cbs as jcbs
from wisecondorx_tpu_torch.cli import main as torch_cli
from wisecondorx_tpu_torch.io.npz import save_sample_npz
from wisecondorx_tpu_torch.ops import _build
from wisecondorx_tpu_torch.ops import cbs as tcbs

MIN_WIDTH = 2
PLANTED = "planted build failure"


def _rows(n_pad):
    w, wx, n = chip_smoke.cbs_arc_rows(n_pad, min_width=MIN_WIDTH)
    return w, wx, n, tuple(torch.as_tensor(a) for a in (w, wx, n))


@pytest.mark.parametrize("kmax", [0, 25])
@pytest.mark.parametrize("mode", ["exact", "thin", "short"])
@pytest.mark.parametrize("n_pad", [8, 32, 128, 2048])
def test_max_t_rows_reference_matches_jax(n_pad, mode, kmax):
    w, wx, n, rows = _rows(n_pad)
    lengths = tcbs._group_lengths(n_pad, tcbs.CBSConfig(kmax=kmax), mode)
    got = tcbs.max_t_rows_reference(
        *rows, torch.as_tensor(lengths.astype(np.int32)), MIN_WIDTH, kmax
    ).numpy()
    want = np.asarray(jcbs._max_t_rows(
        jnp.asarray(w), jnp.asarray(wx), jnp.asarray(n, jnp.int32),
        jnp.asarray(lengths, jnp.int32), min_width=MIN_WIDTH, kmax=kmax,
    ))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    np.testing.assert_allclose(got, want, rtol=1e-12)
    # Rows below 2 * min_width have no valid arc.
    assert np.isneginf(got[n < 2 * MIN_WIDTH]).all()
    if n_pad >= 32 and len(lengths):
        assert np.isnan(got).any() and np.isfinite(got).any()


@pytest.mark.parametrize("n_pad", [8, 32, 128])
def test_locate_rows_reference_matches_jax(n_pad):
    w, wx, n, rows = _rows(n_pad)
    got = tcbs.locate_rows_reference(*rows, MIN_WIDTH)
    cw, cwx = jcbs._row_cumsums(jnp.asarray(w), jnp.asarray(wx))
    _, want_i, want_l = jcbs._tstat_scan(
        cw, cwx, jnp.asarray(n, jnp.int32),
        jnp.arange(n_pad, dtype=jnp.int32), MIN_WIDTH, want_argmax=True,
    )
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want_l))


def test_locate_drops_a_length_with_a_nan_arc():
    """The nan_length row: its spike is the arc (0, 2], but the zero-weight
    slots make another arc of length 2 NaN, so length 2 drops out whole;
    with those weights at 1 the scan finds the spike."""
    n_pad = 32
    w, wx, n, _ = _rows(n_pad)
    r = 9  # nan_length
    assert (w[r, 5:7] == 0).all()
    got = tcbs.locate_rows_reference(*(torch.as_tensor(a[r:r + 1])
                                       for a in (w, wx, n)), MIN_WIDTH)
    assert int(got[1][0]) != 2
    w2, wx2 = w[r:r + 1].copy(), wx[r:r + 1].copy()
    w2[0, 5:7] = 1.0
    got2 = tcbs.locate_rows_reference(torch.as_tensor(w2), torch.as_tensor(wx2),
                                      torch.as_tensor(n[r:r + 1]), MIN_WIDTH)
    assert (int(got2[0][0]), int(got2[1][0])) == (0, 2)


@pytest.mark.parametrize("rows,n_lengths", [
    (0, 0), (1, 0), (2, 32768), (32, 2048), (1026, 110), (1056, 2048),
    (1, 7), (5000, 100000),
])
def test_arc_chunks_fit_the_kernel(rows, n_lengths):
    """Every chunk stages at most the kernel's share of lengths, the grid's
    second axis stays in range, and few rows get more chunks."""
    stage = 8192
    chunks = tcbs.arc_chunks(rows, n_lengths, stage)
    assert 1 <= chunks <= 65535
    assert -(-n_lengths // chunks) <= stage
    if n_lengths >= 8 * 2 and rows <= 2:
        assert chunks > 1


def _failing_build(monkeypatch):
    def no_nvcc():
        raise RuntimeError(PLANTED)

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "build", no_nvcc)


def _calls():
    w, wx, n, (wt, wxt, nt) = _rows(32)
    lengths = torch.as_tensor(tcbs._group_lengths(32, tcbs.CBSConfig(), "exact")
                              .astype(np.int32))
    words = [torch.arange(len(n), dtype=torch.int64) + k for k in range(4)]
    return {
        "max_t_rows": lambda: tcbs.max_t_rows(wt, wxt, nt, lengths, MIN_WIDTH, 25),
        "locate_rows": lambda: tcbs.locate_rows(wt, wxt, nt, MIN_WIDTH),
        "perm_keys": lambda: tcbs.perm_keys(tcbs.prng_key(5), *words, nt, 32),
    }, {
        "max_t_rows": lambda: tcbs.max_t_rows_reference(wt, wxt, nt, lengths,
                                                        MIN_WIDTH, 25),
        "locate_rows": lambda: tcbs.locate_rows_reference(wt, wxt, nt, MIN_WIDTH),
        "perm_keys": lambda: tcbs.perm_keys_reference(tcbs.prng_key(5), *words,
                                                      nt, 32),
    }


@pytest.mark.parametrize("name", ["max_t_rows", "locate_rows", "perm_keys"])
def test_card_wrapper_raises_the_build_error(name, monkeypatch):
    """No fallback: on the card, a kernel library that does not build fails
    the call with the build's error instead of returning the plain
    result."""
    _failing_build(monkeypatch)
    monkeypatch.setattr(tcbs, "_on_card", lambda t: True)
    tcbs.reset_launch_counts()
    with pytest.raises(RuntimeError, match=PLANTED):
        _calls()[0][name]()
    assert set(tcbs.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("name", ["max_t_rows", "locate_rows", "perm_keys"])
def test_cpu_wrapper_takes_the_plain_version(name, monkeypatch):
    """A CPU tensor takes the plain version: the library is never loaded
    and no launch is counted."""
    _failing_build(monkeypatch)
    tcbs.reset_launch_counts()
    wrapper, plain = _calls()
    got, want = wrapper[name](), plain[name]()
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(torch.nan_to_num(g), torch.nan_to_num(w))
    assert set(tcbs.LAUNCHES.values()) == {0}


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """A tiny reference and a case with a planted gain (CPU)."""
    tmp = tmp_path_factory.mktemp("cbs_kernels")
    sim = CohortSim(binsize=1e5, genome_scale=0.02, seed=6)
    samples, _ = sim.cohort(16, 14)
    infiles = []
    for i, sample in enumerate(samples):
        infiles.append(str(tmp / f"control_{i}.npz"))
        save_sample_npz(infiles[-1], 100000, sample, {"mapped": 1})
    case = str(tmp / "case.npz")
    save_sample_npz(case, 100000, sim.sample("F", cnvs=[(11, 2, 30, 3.0)]),
                    {"mapped": 1})
    ref = str(tmp / "ref.npz")
    torch_cli(["newref", *infiles, ref, "--refsize", "30", "--device", "cpu"])
    return case, ref


@pytest.mark.parametrize("command", ["predict", "predict-batch"])
def test_card_build_failure_fails_the_command(cohort, tmp_path, monkeypatch,
                                              command):
    """predict and predict-batch with the CBS wrappers' device check
    patched to the card's and a library that does not build: the command
    fails with the build's error at its first CBS round and writes no BED
    file."""
    case, ref = cohort
    _failing_build(monkeypatch)
    monkeypatch.setattr(tcbs, "_on_card", lambda t: True)
    argv = (["predict", case, ref, str(tmp_path / "case")] if command == "predict"
            else ["predict-batch", ref, str(tmp_path / "plate"), "--infiles", case])
    with pytest.raises(RuntimeError, match=PLANTED):
        torch_cli([*argv, "--bed", "--minrefbins", "10", "--device", "cpu"])
    assert not list(tmp_path.rglob("*.bed"))
