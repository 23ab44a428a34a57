"""The port's scikit-learn-free sex model against wisecondorx_tpu.ops.gmm
(sklearn GaussianMixture): genders equal and the cutoff within one grid
step (0.02 / 4999 = 4.0e-6) on separated, overlapping and fully separated
(plateau-fix) cohorts."""

import numpy as np
import pytest

from wisecondorx_tpu.ops import gmm as jgmm
from wisecondorx_tpu_torch.ops import gmm as tgmm

GRID_STEP = 0.02 / 4999


def _samples(y_fractions):
    """Minimal sample dicts with the given chrY read fractions."""
    return [{"1": np.array([1e6 * (1 - y)]), "24": np.array([1e6 * y])}
            for y in y_fractions]


def _cohort(kind, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "separated":
        f = rng.normal(4e-4, 1.5e-4, 40)
        m = rng.normal(9e-3, 8e-4, 35)
    elif kind == "overlapping":
        f = rng.normal(3e-3, 1.2e-3, 40)
        m = rng.normal(8e-3, 1.5e-3, 35)
    else:  # the mixture density underflows between the modes
        f = rng.normal(5e-4, 1e-4, 40)
        m = rng.normal(1.2e-2, 1e-4, 35)
    return _samples(np.abs(np.concatenate([f, m])))


@pytest.mark.parametrize("kind", ["separated", "overlapping", "plateau"])
def test_gender_model_matches_sklearn(kind):
    samples = _cohort(kind)
    want_g, want_cut, want_fit = jgmm.train_gender_model(samples, random_state=0)
    got_g, got_cut, got_fit = tgmm.train_gender_model(samples)
    assert got_g == want_g
    assert abs(got_cut - want_cut) <= GRID_STEP * 1.0001
    if kind == "plateau":
        interior = want_fit["density"][1:-1]
        assert not ((interior < want_fit["density"][:-2])
                    & (interior < want_fit["density"][2:])).any()
    order = np.argsort(got_fit["means"])
    np.testing.assert_allclose(
        got_fit["means"][order], np.sort(want_fit["means"]), rtol=1e-6
    )


def test_yfrac_override_and_predict_gender():
    samples = _cohort("separated")
    genders, cutoff, _ = tgmm.train_gender_model(samples, yfrac_override=0.005)
    assert cutoff == 0.005
    assert genders == jgmm.train_gender_model(samples, yfrac_override=0.005)[0]
    assert tgmm.predict_gender(samples[-1], cutoff) == "M"
    assert tgmm.predict_gender(samples[0], cutoff) == "F"
