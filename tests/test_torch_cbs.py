"""CBS of the PyTorch port against wisecondorx_tpu.ops.cbs on the CPU.

Threshold mode is a pure function of the data, so the segments must be
identical.  In permutation mode both packages draw from the same host
per-draw stream (keyed by seed, content salt, segment and draw index), so
the decisions, and with them the segments, must be identical too."""

import numpy as np
import pytest

import torch_parity  # noqa: F401  (one torch thread per xdist worker)
from wisecondorx_tpu.ops import cbs as jcbs
from wisecondorx_tpu_torch.ops import cbs as tcbs

BINSIZE = 100000  # NA-run split threshold = 20 bins


def _genome(seed, n_chr=24):
    """Per-chromosome ratios/weights with steps, a focal gain, an NA run
    longer than the split threshold and one all-NA chromosome."""
    rng = np.random.default_rng(seed)
    rs, ws = [], []
    for c in range(n_chr):
        n = int(rng.integers(30, 260))
        y = rng.normal(0, 0.08, n)
        if c % 3 == 0:
            y[n // 2 :] += 0.5
        if c % 4 == 1:
            y[n // 4 : n // 4 + 12] += 0.9
        if c == 2:
            y[40:70] = 0.0  # NA run > 20 bins
        if c == 5:
            y[:] = 0.0  # all-NA chromosome
        rs.append(y)
        ws.append(rng.uniform(0.5, 1.5, n))
    return rs, ws


@pytest.mark.parametrize("seed", [0, 1])
def test_threshold_mode_identical_segments(seed):
    rs, ws = _genome(seed)
    cfg_j = jcbs.CBSConfig(t_threshold=4.0)
    cfg_t = tcbs.CBSConfig(t_threshold=4.0)
    want = jcbs.exec_cbs(rs, ws, "M", BINSIZE, cfg_j)
    got = tcbs.exec_cbs(rs, ws, "M", BINSIZE, cfg_t)
    assert len(want) > 23
    assert got == want


def test_perm_mode_identical_segments():
    rs, ws = _genome(7)
    rs[6:] = [np.zeros(5)] * (len(rs) - 6)  # six chromosomes keep it quick
    # Exercise both arc families: one chromosome above exact_max.
    rng = np.random.default_rng(8)
    long = rng.normal(0, 0.1, 300)
    long[200:] += 0.4
    rs[0], ws[0] = long, np.ones(300)
    kw = dict(alpha=1e-2, nperm=500, perm_batch=250, seed=0, exact_max=256)
    want = jcbs.exec_cbs(rs, ws, "F", BINSIZE, jcbs.CBSConfig(**kw))
    got = tcbs.exec_cbs(rs, ws, "F", BINSIZE, tcbs.CBSConfig(**kw))
    assert got == want


def test_locate_tie_order_matches_jax():
    """Flat data: every arc ties at |T| = 0 except where the values step;
    the located arc follows the shortest-first, then smallest-start rule."""
    import jax.numpy as jnp
    import torch

    x = np.array([[0.0] * 10 + [1.0] * 6 + [0.0] * 16, [1.0] * 32])
    w = np.ones_like(x)
    n = np.array([32, 32])
    want = jcbs._locate_batch(jnp.asarray(w), jnp.asarray(w * x),
                              jnp.asarray(n, jnp.int32), 2)
    got = tcbs.locate_rows(torch.as_tensor(w), torch.as_tensor(w * x),
                           torch.as_tensor(n), 2)
    for g, v in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(v))
