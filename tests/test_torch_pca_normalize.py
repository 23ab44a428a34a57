"""PCA and the predict normalization of the PyTorch port against
wisecondorx_tpu (float64 on both sides)."""

import numpy as np
import torch

from synthetic import CohortSim
from torch_parity import t64
from wisecondorx_tpu.genome import samples_to_matrix
from wisecondorx_tpu.ops import mask as mask_ops
from wisecondorx_tpu.ops import normalize as jnorm
from wisecondorx_tpu.ops import pca as jpca
from wisecondorx_tpu_torch.ops import normalize as tnorm
from wisecondorx_tpu_torch.ops import pca as tpca


def _masked_cohort():
    sim = CohortSim(binsize=1e5, genome_scale=0.01, seed=8)
    samples, _ = sim.cohort(7, 6)
    matrix, layout = samples_to_matrix(samples)
    m = mask_ops.get_mask(matrix)
    tl = layout.truncated(22)
    normed = np.asarray(mask_ops.depth_normalize(matrix[: tl.total_bins]))
    return normed[m[: tl.total_bins]]


def test_train_pca_and_projection_match_jax():
    data = _masked_cohort()
    want_c, want_comp, want_mean = jpca.train_pca(data, 5)
    got_c, got_comp, got_mean = tpca.train_pca(t64(data), 5)
    # Same host eigensolver on both sides, so the component signs agree.
    np.testing.assert_allclose(got_comp, want_comp, rtol=1e-9, atol=1e-14)
    np.testing.assert_allclose(got_mean, want_mean, rtol=1e-12)
    np.testing.assert_allclose(got_c.numpy(), want_c, rtol=1e-9)

    sample = data[:, 0] * 1.01
    want_p = np.asarray(jpca.project_sample(sample, want_comp, want_mean))
    got_p = tpca.project_sample(t64(sample), t64(got_comp), t64(got_mean))
    np.testing.assert_allclose(got_p.numpy(), want_p, rtol=1e-9)


def test_normalize_repeat_matches_jax():
    rng = np.random.default_rng(5)
    n, k, ct = 600, 30, 40
    test_data = rng.lognormal(0, 0.05, size=n) * 1e-3
    test_data[100:130] *= 1.5  # aberrant bins that get z-masked
    global_idx = rng.integers(0, n, size=(n - ct, k))
    distances = rng.random((n - ct, k))
    global_idx[7] = -1  # no neighbours at all: NaN z and r
    cutoff = 0.8
    sent = jnorm.sentinel_indexes(global_idx, distances, cutoff)
    np.testing.assert_array_equal(
        tnorm.sentinel_indexes(global_idx, distances, cutoff), sent
    )
    want = jnorm.normalize_repeat_pre(test_data, sent, ct=ct)
    got = tnorm.normalize_repeat(
        t64(test_data), torch.as_tensor(sent.astype(np.int64)), ct=ct
    )
    names = ("z", "r", "ref_sizes", "m_lr", "m_z")
    assert np.isnan(want[0][7]) and np.isnan(got[0][7].item())
    for g, w, name in zip(got, want, names):
        np.testing.assert_allclose(
            np.asarray(g, dtype=np.float64), np.asarray(w, dtype=np.float64),
            rtol=1e-10, equal_nan=True, err_msg=name,
        )


def test_m_lr_recentres_the_median_bin_to_exactly_zero():
    """predict recentres the host's numpy log2 ratios by m_lr.  The port
    takes m_lr with torch.log2, which equals numpy's log2 bit for bit, so
    the median bin of an odd count recentres to exactly 0, as in the
    reference tool.  The JAX package takes m_lr with XLA's log2, which is
    up to one ulp off numpy's for some inputs: the one known difference
    between the two predicts (test_torch_slice.py's cohort avoids it)."""
    import jax.numpy as jnp

    from wisecondorx_tpu_torch.models.predictor import _log_trans

    rng = np.random.default_rng(3)
    n, k = 401, 20
    test_data = rng.lognormal(0, 0.05, size=n)
    idx = np.argsort(rng.random((n, n)), axis=1)[:, :k]
    z, r, sizes, m_lr, _ = tnorm.normalize_repeat(
        t64(test_data), torch.as_tensor(idx)
    )
    r = r.numpy()
    assert np.isfinite(r).all()
    assert float(m_lr) == np.median(np.log2(r))
    lr = _log_trans([r], [z.numpy()], [np.ones(n)], [sizes.numpy()],
                    float(m_lr))[0][0]
    assert np.count_nonzero(lr == 0.0) == 1

    ratios = rng.uniform(0.5, 2.0, 4001)
    want = np.log2(ratios)
    np.testing.assert_array_equal(torch.log2(t64(ratios)).numpy(), want)
    ulps = np.abs(np.asarray(jnp.log2(ratios)) - want) / np.spacing(np.abs(want))
    assert ulps.max() <= 1.0 and (ulps > 0).any()


def test_host_helpers_are_the_jax_packages():
    rng = np.random.default_rng(9)
    d = rng.random((200, 12))
    np.testing.assert_array_equal(
        tnorm.optimal_cutoff_schedule(d), jnorm.optimal_cutoff_schedule(d)
    )
    assert tnorm.get_optimal_cutoff(d, 3) == jnorm.get_optimal_cutoff(d, 3)
    assert tnorm.get_optimal_cutoff(d, 0) == float("inf")
    np.testing.assert_array_equal(tnorm.get_weights(d), jnorm.get_weights(d))
    sample = CohortSim(binsize=1e5, genome_scale=0.01, seed=1).sample("F")
    bins = np.array([len(sample[str(c)]) for c in range(1, 23)])
    mask = rng.random(bins.sum()) < 0.9
    np.testing.assert_array_equal(
        tnorm.coverage_normalize_and_mask(sample, bins, mask),
        jnorm.coverage_normalize_and_mask(sample, bins, mask),
    )
