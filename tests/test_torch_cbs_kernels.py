"""The plain versions of the CBS kernels (ops/cbs.py) against the JAX
package's arc statistic, and the wrappers' dispatch, on the CPU.

* ``max_t_rows_reference`` equals ``_max_t_rows_impl`` (x64) to rtol 1e-12
  with the same NaN and -inf positions, on ``chip_smoke.cbs_arc_rows``
  (rows without a valid arc, zero-weight slots that make NaN, rows that
  tie) at n_pad 8 to 2,048, for the exact, thin and short length families
  and kmax 0 and 25;
* ``locate_rows_reference`` equals ``_tstat_scan(want_argmax=True)``,
  a length with a NaN arc and ties included;
* the kernels' screen (``arc_screen_reference``, the same float64
  operations as csrc/cbs_arcs.cu) never skips an arc whose exact |T|
  reaches the threshold: at every arc's own |T|, at thresholds taken from
  its row's |T| values (every value on small rows), with NaN arcs never
  skipped, on ``chip_smoke.cbs_arc_rows``, ``chip_smoke.cbs_adversarial_rows``
  and hypothesis-drawn rows, and it is monotone in the threshold; it skips
  most arcs of ordinary rows;
* the launch arithmetic: which widths are staged in shared memory, and
  the chunks of lengths a row's blocks take, which hold every (length,
  start) exactly once at about equal arc counts;
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
from hypothesis import given, settings
from hypothesis import strategies as st

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
    """At every width: the one-dimensional grid stays in range, no row has
    more chunks than lengths nor chunks of fewer than ARC_MIN_ARCS arc
    slots, few rows with that many arcs get more chunks, and rows read
    through L2 get at least ARC_L2_CHUNKS where they have the lengths."""
    for width in (8, 2036, 4686, 8192, 16597, 32768):
        chunks = tcbs.arc_chunks(rows, n_lengths, width)
        slots = n_lengths * (width + 1)
        assert 1 <= chunks and rows * chunks <= 2**31 - 1
        assert chunks <= max(1, n_lengths, slots // tcbs.ARC_MIN_ARCS)
        assert chunks == 1 or slots // chunks >= tcbs.ARC_MIN_ARCS
        if rows <= 2 and n_lengths >= 16 and slots >= 2 * tcbs.ARC_MIN_ARCS:
            assert chunks > 1
        if not tcbs.arc_staged(width) and rows > 0:
            assert chunks >= min(tcbs.ARC_L2_CHUNKS, n_lengths,
                                 n_lengths * (width + 1) // tcbs.ARC_MIN_ARCS)


def test_arc_window_stages_rows_that_fit():
    """The sums are cut to the widest row the caller knows, and staged in
    shared memory when both fit in ARC_STAGE_BYTES: every 50 kb round and
    exact bucket, not a 15 kb chromosome 1."""
    assert tcbs.arc_width(8192, None) == 8192
    assert tcbs.arc_width(8192, 4686) == 4686
    assert tcbs.arc_width(8192, 9000) == 8192
    assert tcbs.arc_width(32, -1) == 0
    for width in (0, 2036, 4686, 8192, 13823):
        assert tcbs.arc_staged(width)
    for width in (13824, 16597, 32768):
        assert not tcbs.arc_staged(width)
    assert 2 * (13823 + 1) * 8 == tcbs.ARC_STAGE_BYTES


@pytest.mark.parametrize("n,mode,n_pad,chunks", [
    (4686, "thin", 8192, 2), (2036, "exact", 2048, 2), (2036, "exact", 2048, 64),
    (16597, "thin", 32768, 8), (16597, "locate", 16597, 1024), (4686, "locate", 4686, 292),
    (3, "exact", 8, 4), (5, "thin", 8, 300), (0, "exact", 8, 1),
])
def test_arc_chunk_bounds_cover_every_arc_once(n, mode, n_pad, chunks):
    """The chunks of a row are contiguous runs of the lengths array that
    hold every length with an arc, and so every (length, start), exactly
    once, each within one length's arcs of an equal share."""
    lengths = (np.arange(n_pad) if mode == "locate"
               else tcbs._group_lengths(n_pad, tcbs.CBSConfig(), mode))
    arcs = np.where((lengths >= MIN_WIDTH) & (lengths <= n - MIN_WIDTH),
                    n - lengths + 1, 0)
    bounds = tcbs.arc_chunk_bounds(lengths, n, MIN_WIDTH, chunks)
    assert len(bounds) == chunks and bounds[0][0] == 0
    owner = np.full(len(lengths), -1)
    for c, (g0, g1) in enumerate(bounds):
        assert g0 <= g1
        if c:
            assert g0 == bounds[c - 1][1]
        owner[g0:g1] = c
    assert (owner[arcs > 0] >= 0).all()
    per_chunk = np.bincount(owner[owner >= 0], weights=arcs[owner >= 0],
                            minlength=chunks)
    assert per_chunk.sum() == arcs.sum()
    if arcs.sum():
        assert per_chunk.max() <= arcs.sum() / chunks + arcs.max()


def _screen_case(w, wx, n, lengths):
    """The exact |T| of every window arc [B, G, n_pad + 1] (-inf where
    invalid) and a function of thresholds -> the screen's skip mask."""
    rows = tuple(torch.as_tensor(a) for a in (w, wx, n))
    lengths = torch.as_tensor(np.asarray(lengths, dtype=np.int32))
    cw, cwx = tcbs._row_cumsums(*rows[:2])
    t = tcbs._tstat_block(cw, cwx, rows[2].reshape(-1, 1), lengths, MIN_WIDTH)
    return t, lambda m: tcbs.arc_screen_reference(*rows, lengths, MIN_WIDTH, m)


def _check_screen(t, screen, every_value):
    """No arc is skipped at its own |T| nor, at any threshold taken from its
    row's |T| values, unless it is strictly below; NaN arcs never are."""
    finite = torch.isfinite(t)
    assert not (screen(torch.where(finite, t, 0.0)) & finite).any()
    rows_t = torch.where(finite, t, -torch.inf).flatten(1)
    thresholds = []
    for b in range(t.shape[0]):
        vals = torch.unique(rows_t[b][torch.isfinite(rows_t[b])])
        if not every_value and len(vals) > 17:
            vals = torch.quantile(vals, torch.linspace(0, 1, 17, dtype=vals.dtype))
        thresholds.append(vals)
    most = max([len(v) for v in thresholds] + [0])
    for k in range(most):
        m = torch.tensor([float(v[min(k, len(v) - 1)]) if len(v) else 0.0
                          for v in thresholds], dtype=t.dtype)
        skip = screen(m)
        assert not (skip & torch.isnan(t)).any()
        assert (t[skip] < m[:, None, None].expand_as(t)[skip]).all()


@pytest.mark.parametrize("mode", ["exact", "thin"])
@pytest.mark.parametrize("family", ["arc_rows", "adversarial"])
@pytest.mark.parametrize("n_pad", [8, 32, 128, 2048])
def test_arc_screen_never_skips_a_reaching_arc(n_pad, family, mode):
    if mode == "exact" and n_pad == 2048:
        mode = "short"  # every length would be a [rows, 2048, 2049] block
    make = (chip_smoke.cbs_arc_rows if family == "arc_rows"
            else chip_smoke.cbs_adversarial_rows)
    w, wx, n = make(n_pad)
    t, screen = _screen_case(w, wx, n,
                             tcbs._group_lengths(n_pad, tcbs.CBSConfig(), mode))
    _check_screen(t, screen, every_value=n_pad <= 32)


def test_arc_screen_is_monotone_in_the_threshold():
    """A larger threshold never skips fewer arcs, so holding the screen at
    each arc's own |T| holds it at every lower threshold too."""
    w, wx, n = chip_smoke.cbs_arc_rows(128)
    t, screen = _screen_case(w, wx, n, np.arange(128))
    rng = np.random.default_rng(7)
    finite = t[torch.isfinite(t)]
    for _ in range(20):
        lo, hi = sorted(rng.choice(finite.numpy(), 2))
        m_lo = torch.full((len(n),), lo, dtype=t.dtype)
        assert (screen(m_lo) <= screen(torch.full_like(m_lo, hi))).all()


def test_arc_screen_skips_most_arcs_of_ordinary_rows():
    """Permuted rows of a real-looking segment: at the row's maximum the
    screen skips all but a few arcs, so few take the exact formula; a
    near-flat row (every |T| rounding noise) skips none."""
    rng = np.random.default_rng(11)
    n_pad, n = 2048, 1900
    x = rng.normal(0.0, 0.1, n)
    x[n // 3: n // 2] += 0.5
    rows = [(rng.uniform(0.5, 1.5, n), x[rng.permutation(n)]) for _ in range(6)]
    w, wx, sizes = chip_smoke._arc_row_tables(rows, n_pad)
    t, screen = _screen_case(w, wx, sizes,
                             tcbs._group_lengths(n_pad, tcbs.CBSConfig(), "thin"))
    valid = t > -torch.inf
    skip = screen(t.flatten(1).amax(dim=1))
    assert float(skip.sum()) / float(valid.sum()) > 0.99
    w, wx, sizes = chip_smoke.cbs_adversarial_rows(128)
    near_flat = chip_smoke.ADVERSARIAL_ROWS.index("near_flat")
    t, screen = _screen_case(w[near_flat:near_flat + 1], wx[near_flat:near_flat + 1],
                             sizes[near_flat:near_flat + 1], np.arange(128))
    assert not screen(t.flatten(1).amax(dim=1)).any()


_weights = st.one_of(st.just(0.0), st.floats(1e-3, 1e3), st.floats(1e-305, 1e-295),
                     st.floats(1e148, 1e152))
_values = st.one_of(st.just(0.0), st.floats(-10.0, 10.0), st.floats(-1e152, 1e152),
                    st.floats(-1e-298, 1e-298))


@settings(max_examples=60, deadline=None)
@given(st.lists(st.lists(st.tuples(_weights, _values), min_size=0, max_size=24),
                min_size=1, max_size=4))
def test_arc_screen_holds_on_drawn_rows(rows):
    """Hypothesis-drawn rows of up to 24 slots, weights and values across
    scales (zeros, near 1e-300 and 1e150 included): the screen never skips
    an arc at any threshold from its row's |T| values."""
    n_pad = 24
    w, wx, n = chip_smoke._arc_row_tables(
        [(np.array([p[0] for p in r]), np.array([p[1] for p in r])) for r in rows],
        n_pad)
    with np.errstate(all="ignore"):
        t, screen = _screen_case(w, wx, n, np.arange(n_pad))
        _check_screen(t, screen, every_value=True)


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
