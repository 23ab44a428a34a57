"""The port's device permutation stream (ops/cbs.py) against the JAX
package's accelerator path, on the CPU.

* ``fold_in`` / ``random_bits`` are bit-equal to ``jax.random``;
* one permutation round (``perm_round_device``) equals JAX's
  ``_perm_round_device`` on tie-free fixtures: the sort keys bit-equal, the
  shuffled rows equal, the exceed counts equal, ``obs`` to rtol 1e-12;
* ``exec_cbs`` with the device stream forced gives the segments of JAX's
  ``exec_cbs`` with its TPU branch forced (``jax.default_backend``
  patched), in the perm and hybrid modes, at round sizes other than JAX's
  (the decisions do not depend on the round size);
* under null data the device stream's split decision keeps its level, and
  it finds a planted arc (tests/test_cbs_calibration.py at a CPU size).

JAX sorts with ``is_stable=False``, the port with a stable sort: rows where
two real slots draw the same 31-bit key may shuffle differently.  The round
fixtures assert that they hold no such tie."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per xdist worker)
from statutil import wilson_ci
from wisecondorx_tpu.ops import cbs as jcbs
from wisecondorx_tpu_torch.ops import cbs as tcbs

CPU = torch.device("cpu")
BINSIZE = 100000


def _jax_row_keys(seed, salt, lo, hi, draw, n):
    k = jax.random.PRNGKey(seed)
    for word in (salt, lo, hi, draw):
        k = jax.random.fold_in(k, word)
    return k, np.asarray(jax.random.bits(k, (n,), dtype=jnp.uint32)).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 7, 2**33 + 5, -3])
def test_fold_in_and_bits_bit_equal_to_jax(seed):
    words = [(0, 0, 0, 0), (1, 0, 17, 0), (12345, 3, 900, 1),
             (0x7FFFFFFF, 2**31 - 1, 0, 9999)]
    base = tcbs.prng_key(seed)
    assert base == tuple(int(v) for v in np.asarray(jax.random.PRNGKey(seed)))
    cols = torch.as_tensor(np.array(words, dtype=np.int64).T)
    key = base
    for col in cols:
        key = tcbs.fold_in(key, col)
    for n in (1, 5, 4096):
        got = tcbs.random_bits(key, n).numpy()
        for r, (salt, lo, hi, draw) in enumerate(words):
            jkey, want = _jax_row_keys(seed, salt, lo, hi, draw, n)
            assert [int(key[0][r]), int(key[1][r])] == [int(v) for v in np.asarray(jkey)]
            np.testing.assert_array_equal(got[r], want)


def _round_fixture(sizes, n_pad, rows_per_seg, seed):
    rng = np.random.default_rng(seed)
    s = len(sizes)
    w = np.zeros((s, n_pad))
    wx = np.zeros((s, n_pad))
    for i, n in enumerate(sizes):
        x = rng.normal(0, 1, n)
        x[n // 3 : n // 2] += 1.5 * (i % 2)
        w[i, :n] = rng.uniform(0.5, 1.5, n)
        wx[i, :n] = w[i, :n] * x
    seg_of_row = np.repeat(np.arange(s), rows_per_seg)
    b = len(seg_of_row)
    live = np.ones(b, dtype=bool)
    live[::5] = False
    salt = np.full(b, 0x12345)
    lo = np.repeat(np.arange(s) * 1000, rows_per_seg)
    hi = lo + np.repeat(sizes, rows_per_seg)
    draw = np.concatenate([np.arange(k) + 3 for k in [rows_per_seg] * s])
    obs_ext = rng.uniform(2.5, 4.5, s)
    return w, wx, np.asarray(sizes), seg_of_row, live, salt, lo, hi, draw, obs_ext


@pytest.mark.parametrize("use_ext_obs", [False, True])
@pytest.mark.parametrize("mode,n_pad,sizes", [
    ("exact", 64, (40, 57, 64)),
    ("thin", 512, (300, 512, 450)),
])
def test_perm_round_matches_jax(mode, n_pad, sizes, use_ext_obs):
    seed = 11
    (w, wx, n_seg, seg_of_row, live, salt, lo, hi, draw,
     obs_ext) = _round_fixture(sizes, n_pad, 24, seed)
    jcfg, tcfg = jcbs.CBSConfig(), tcbs.CBSConfig()
    mw, kmax = tcfg.min_width, tcfg.kmax
    key_words = [torch.as_tensor(a, dtype=torch.int64) for a in (salt, lo, hi, draw)]
    n_rows = torch.as_tensor(n_seg[seg_of_row])
    keys = tcbs.perm_keys(tcbs.prng_key(seed), *key_words, n_rows, n_pad)

    # The keys equal jax.random's, row by row; no row has a tie among its
    # real slots (where the two sorts could order differently).
    idx = np.arange(n_pad)
    for r in range(len(seg_of_row)):
        _, bits = _jax_row_keys(seed, salt[r], lo[r], hi[r], draw[r], n_pad)
        n = n_seg[seg_of_row[r]]
        want = np.where(idx < n, bits & 0x7FFFFFFF, 0x80000000 | idx)
        np.testing.assert_array_equal(keys[r].numpy(), want)
        assert len(np.unique(want[:n])) == n

    # The shuffled rows equal JAX's sort with payloads.
    w_rows, wx_rows = w[seg_of_row], wx[seg_of_row]
    got_w, got_wx = tcbs.shuffle_rows(keys, torch.as_tensor(w_rows),
                                      torch.as_tensor(wx_rows))
    want_w, want_wx = jcbs._shuffle_rows(jnp.asarray(keys.numpy().astype(np.uint32)),
                                         jnp.asarray(w_rows), jnp.asarray(wx_rows))
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
    np.testing.assert_array_equal(got_wx.numpy(), np.asarray(want_wx))

    want_counts, want_obs = jcbs._perm_round_device(
        jax.random.PRNGKey(seed), jnp.asarray(w), jnp.asarray(wx),
        jnp.asarray(n_seg, jnp.int32), jnp.asarray(seg_of_row, jnp.int32),
        jnp.asarray(live), *(jnp.asarray(a, jnp.int32) for a in (salt, lo, hi, draw)),
        jnp.asarray(obs_ext), jnp.asarray(jcbs._group_lengths(n_pad, jcfg, mode)),
        mw, kmax, use_ext_obs,
    )
    got_counts, got_obs = tcbs.perm_round_device(
        tcbs.prng_key(seed), torch.as_tensor(w), torch.as_tensor(wx),
        torch.as_tensor(n_seg), torch.as_tensor(seg_of_row), torch.as_tensor(live),
        *key_words, torch.as_tensor(obs_ext),
        torch.as_tensor(tcbs._group_lengths(n_pad, tcfg, mode)),
        mw, kmax, use_ext_obs,
    )
    np.testing.assert_array_equal(got_counts.numpy(), np.asarray(want_counts))
    np.testing.assert_allclose(got_obs.numpy(), np.asarray(want_obs), rtol=1e-12)
    # Not a vacuous comparison: some rows exceed and some do not.
    assert 0 < int(got_counts.sum()) < int(live.sum())


def _genome(seed):
    """Eight chromosomes with steps and focal gains, one longer than the
    tests' exact_max (so it takes the thinned or short arc family), one
    with an NA run and one all-NA."""
    rng = np.random.default_rng(seed)
    rs, ws = [], []
    for c in range(8):
        n = 300 if c == 0 else int(rng.integers(30, 200))
        y = rng.normal(0, 0.08 if c else 0.1, n)
        if c % 3 == 0:
            y[2 * n // 3 :] += 0.4
        if c % 4 == 1:
            y[n // 4 : n // 4 + 12] += 0.9
        if c == 2:
            y[10:40] = 0.0
        rs.append(y)
        ws.append(np.ones(n) if c == 0 else rng.uniform(0.5, 1.5, n))
    rs[5] = np.zeros(rs[5].shape)
    rs += [np.zeros(5)] * 15
    ws += [np.ones(5)] * 15
    return rs, ws


@pytest.mark.parametrize("perm_batch", [64, 1024])
@pytest.mark.parametrize("p_method", ["perm", "hybrid"])
def test_exec_cbs_device_stream_matches_jax_tpu_branch(p_method, perm_batch,
                                                       monkeypatch):
    rs, ws = _genome(7)
    kw = dict(alpha=1e-2, nperm=500, seed=0, exact_max=256, p_method=p_method)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    # JAX sizes its rounds as row_elems // n_pad rows: 128 to 1,024 here.
    want = jcbs.exec_cbs(rs, ws, "F", BINSIZE,
                         jcbs.CBSConfig(**kw, row_elems=1 << 16))
    monkeypatch.undo()
    tcbs.reset_round_counts()
    got = tcbs.exec_cbs(rs, ws, "F", BINSIZE,
                        tcbs.CBSConfig(**kw, perm_batch=perm_batch), CPU,
                        _device_stream=True)
    assert tcbs.ROUNDS["device"] > 0 and tcbs.ROUNDS["host"] == 0
    assert got == want
    assert len(got) > 10


def test_cpu_takes_the_host_stream_by_default():
    rs, ws = _genome(3)
    kw = dict(alpha=1e-2, nperm=200, seed=0, exact_max=256)
    tcbs.reset_round_counts()
    tcbs.exec_cbs(rs, ws, "F", BINSIZE, tcbs.CBSConfig(**kw), CPU)
    assert tcbs.ROUNDS["host"] > 0 and tcbs.ROUNDS["device"] == 0


def test_exec_cbs_batch_equals_per_sample():
    """A plate segmented in one engine run gives each sample the segments
    of its own run: every draw is keyed by its segment, not its batch."""
    plate = [_genome(s) for s in (1, 2)]
    cfg = tcbs.CBSConfig(alpha=1e-2, nperm=300, exact_max=256)
    batch = tcbs.exec_cbs_batch([(r, w, "F", BINSIZE) for r, w in plate], cfg,
                                CPU, _device_stream=True)
    for (r, w), got in zip(plate, batch):
        assert got == tcbs.exec_cbs(r, w, "F", BINSIZE, cfg, CPU,
                                    _device_stream=True)


ALPHA, NPERM = 0.05, 500


def test_device_stream_null_level_tracks_alpha():
    """Skewed weights, i.i.d. Gaussian null: the realized Type-I level's
    Wilson interval holds alpha's attainable target and is not above alpha."""
    rng = np.random.default_rng(424242)
    reps, n = 300, 60
    jobs = [(rng.normal(0.0, 1.0, n), 10.0 ** rng.uniform(-1.5, 1.5, n))
            for _ in range(reps)]
    cfg = tcbs.CBSConfig(alpha=ALPHA, nperm=NPERM, seed=7)
    res = tcbs._segment_jobs(jobs, cfg, CPU, device_stream=True)
    rejected = sum(len(r) > 1 for r in res)
    lo, hi = wilson_ci(rejected, reps)
    exact_target = np.floor(ALPHA * (NPERM + 1)) / (NPERM + 1)
    assert lo <= ALPHA, (rejected, reps, lo, hi)
    assert hi >= exact_target, (rejected, reps, lo, hi, exact_target)


def test_device_stream_power_on_planted_arc():
    rng = np.random.default_rng(5150)
    reps, n = 12, 60
    jobs = []
    for _ in range(reps):
        y = rng.normal(0.0, 1.0, n)
        ln = n // 6
        a = int(rng.integers(0, n - ln))
        y[a : a + ln] += 8.0 / np.sqrt(ln)
        jobs.append((y, np.abs(rng.normal(1.0, 0.15, n)) + 1e-3))
    cfg = tcbs.CBSConfig(alpha=0.01, nperm=NPERM, seed=3)
    res = tcbs._segment_jobs(jobs, cfg, CPU, device_stream=True)
    assert sum(len(r) > 1 for r in res) >= reps - 1
