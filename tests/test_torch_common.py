"""Masked reductions of the PyTorch port against wisecondorx_tpu.ops.common
(float64 on both sides; rtol 1e-12 leaves room for summation order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import t64
from wisecondorx_tpu.ops import common as jc
from wisecondorx_tpu_torch.ops import common as tc


def _inputs(k, seed):
    rng = np.random.default_rng(seed)
    x = rng.lognormal(0, 0.3, size=(40, k))
    valid = rng.random((40, k)) < 0.6
    valid[0] = False  # all masked -> NaN
    valid[1] = True  # all valid
    valid[2] = False
    valid[2, :2] = True  # even count of two
    x[3, 1] = x[3, 0]  # a tie
    return x, valid


@pytest.mark.parametrize("k", [8, 9])  # even and odd row widths
@pytest.mark.parametrize("name", ["masked_mean", "masked_std", "masked_median"])
def test_masked_reductions_match_jax(name, k):
    x, valid = _inputs(k, seed=k)
    want = np.asarray(getattr(jc, name)(jnp.asarray(x), jnp.asarray(valid)))
    got = getattr(tc, name)(t64(x), torch.as_tensor(valid)).numpy()
    assert np.isnan(got[0]) and np.isnan(want[0])
    np.testing.assert_allclose(got, want, rtol=1e-12, equal_nan=True)


def test_median_averages_two_middles():
    """torch.median returns the lower middle of an even count; the port's
    median must average the two middles like numpy."""
    x = np.array([[4.0, 1.0, 3.0, 2.0]])
    assert tc.median(t64(x), dim=1).item() == 2.5
    assert torch.median(t64(x), dim=1).values.item() == 2.0


def test_nanmedian_matches_jax():
    rng = np.random.default_rng(3)
    for n in (10, 11):
        x = rng.normal(size=n)
        x[[1, 4]] = np.nan
        want = float(jnp.nanmedian(jnp.asarray(x)))
        assert tc.nanmedian(t64(x)).item() == pytest.approx(want, rel=1e-12)
    assert np.isnan(tc.nanmedian(t64([np.nan, np.nan])).item())
