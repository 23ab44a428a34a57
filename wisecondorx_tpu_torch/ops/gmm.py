"""Sex (gender) model: a 2-component Gaussian mixture over chrY fractions.

Counterpart of wisecondorx_tpu/ops/gmm.py, without scikit-learn: the 1-D
expectation-maximisation of ``GaussianMixture(n_components=2,
covariance_type="full", reg_covar=1e-99, tol=1e-12, max_iter=10000)``
written out in numpy float64.  Initial responsibilities come from the
optimal two-cluster split of the sorted fractions (exact 1-D k-means, so
no seed is needed).  The cutoff is the first strict local minimum of the
mixture density on the same 5000-point grid over [0, 0.02], with the
same plateau fix as the JAX package.
"""

from __future__ import annotations

import logging
import math

import numpy as np

GRID = np.linspace(0, 0.02, 5000)
REG_COVAR = 1e-99
_LOG_2PI = math.log(2.0 * math.pi)


def y_fraction(sample: dict) -> float:
    """Fraction of reads on chrY."""
    total = float(np.sum([np.sum(sample[k]) for k in sample.keys()]))
    return float(np.sum(sample["24"])) / total


def predict_gender(sample: dict, trained_cutoff: float) -> str:
    """'M' iff the chrY fraction exceeds the trained cutoff."""
    return "M" if y_fraction(sample) > float(trained_cutoff) else "F"


def _kmeans_split(y: np.ndarray) -> np.ndarray:
    """One-hot responsibilities of the 2-means optimum of 1-D data: the
    split of the sorted values with the least within-cluster sum of
    squares."""
    order = np.argsort(y, kind="stable")
    ys = y[order]
    n = len(ys)
    best, best_k = np.inf, 1
    for k in range(1, n):
        a, b = ys[:k], ys[k:]
        cost = np.sum((a - a.mean()) ** 2) + np.sum((b - b.mean()) ** 2)
        if cost < best:
            best, best_k = cost, k
    resp = np.zeros((n, 2))
    resp[order[:best_k], 0] = 1.0
    resp[order[best_k:], 1] = 1.0
    return resp


def _m_step(x, resp):
    nk = resp.sum(axis=0) + 10 * np.finfo(np.float64).eps
    means = resp.T @ x / nk
    var = np.array([
        np.sum(resp[:, k] * (x - means[k]) ** 2) / nk[k] for k in range(2)
    ]) + REG_COVAR
    return nk / len(x), means, var


def _weighted_log_prob(x, weights, means, var):
    prec_chol = 1.0 / np.sqrt(var)
    y = (x[:, None] - means[None, :]) * prec_chol[None, :]
    return -0.5 * (_LOG_2PI + y * y) + np.log(prec_chol) + np.log(weights)


def _logsumexp2(a):
    m = np.max(a, axis=1)
    return m + np.log(np.sum(np.exp(a - m[:, None]), axis=1))


def fit_gmm(y: np.ndarray, max_iter: int = 10000, tol: float = 1e-12):
    """EM for a 2-component 1-D mixture; returns (weights, means, var)."""
    x = np.asarray(y, dtype=np.float64)
    weights, means, var = _m_step(x, _kmeans_split(x))
    lower = -np.inf
    for _ in range(max_iter):
        wlp = _weighted_log_prob(x, weights, means, var)
        norm = _logsumexp2(wlp)
        resp = np.exp(wlp - norm[:, None])
        weights, means, var = _m_step(x, resp)
        weights = weights / weights.sum()
        prev, lower = lower, float(np.mean(norm))
        if abs(lower - prev) < tol:
            break
    return weights, means, var


def train_gender_model(samples: list[dict], yfrac_override: float | None = None):
    """Fit the mixture and derive the M/F cutoff.

    Returns (genders list of "M"/"F"/None, cutoff float, fit dict)."""
    y_fractions = np.array([y_fraction(s) for s in samples])
    weights, means, var = fit_gmm(y_fractions)
    density = np.exp(_logsumexp2(_weighted_log_prob(GRID, weights, means, var)))

    if yfrac_override is not None:
        cutoff = float(yfrac_override)
    else:
        interior = (density[1:-1] < density[:-2]) & (density[1:-1] < density[2:])
        minima = np.nonzero(interior)[0] + 1
        if len(minima) > 0:
            cutoff = float(GRID[minima[0]])
        else:
            # Very separated clusters: the density underflows to exactly 0
            # between the modes, leaving no strict minimum.  Take the
            # first interior point of the global-minimum plateau.
            i = int(np.argmin(density[1:-1])) + 1
            if i <= 1 or i >= len(density) - 2:
                raise RuntimeError(
                    "Could not determine a --yfrac cutoff: the Gaussian "
                    "mixture density is monotone on [0, 0.02]. Provide "
                    "--yfrac."
                )
            cutoff = float(GRID[i])
        logging.info("Determined --yfrac cutoff: %s", round(cutoff, 4))

    genders: list = [None] * len(samples)
    for i, yf in enumerate(y_fractions):
        if yf > cutoff:
            genders[i] = "M"
        elif yf < cutoff:
            genders[i] = "F"
    fit = {"y_fractions": y_fractions, "grid": GRID, "density": density,
           "means": means, "weights": weights}
    return genders, cutoff, fit
