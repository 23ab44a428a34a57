"""The sex model of newref: a 2-component Gaussian mixture over chrY
fractions, whose density minimum is the M/F cutoff.

A frozen copy of the repository's plain numpy version (scikit-learn's
``GaussianMixture(n_components=2, covariance_type="full",
reg_covar=1e-99, tol=1e-12, max_iter=10000, random_state=seed)`` written
out in float64, k-means++ start and all), kept here so that a change to
the program cannot move the reference.  WisecondorX fits it on every
reference's controls, also on a NIPT reference's all-female cohort,
where the cutoff splits the females and so chooses the F pass's
controls and each sample's printed sex.
"""

from __future__ import annotations

import math

import numpy as np

GRID = np.linspace(0, 0.02, 5000)
REG_COVAR = 1e-99
N_COMPONENTS = 2
#: KMeans defaults (tol is relative to the mean variance of the data).
KMEANS_MAX_ITER = 300
KMEANS_TOL = 1e-4


def y_fraction(sample: dict) -> float:
    """Fraction of reads on chrY."""
    total = float(np.sum([np.sum(sample[k]) for k in sample.keys()]))
    return float(np.sum(sample["24"])) / total


def predict_gender(sample: dict, trained_cutoff: float) -> str:
    """'M' iff the chrY fraction exceeds the trained cutoff."""
    return "M" if y_fraction(sample) > float(trained_cutoff) else "F"


def _random_state(seed) -> np.random.RandomState:
    """sklearn's ``check_random_state``: None is numpy's global
    ``RandomState``, an int seeds a new one, an instance passes through."""
    if seed is None:
        return np.random.mtrand._rand
    if isinstance(seed, np.random.RandomState):
        return seed
    return np.random.RandomState(seed)


def _sq_distances(centers, x, x_sq):
    """``_euclidean_distances(centers, x, Y_norm_squared=x_sq,
    squared=True)`` for dense float64 input."""
    d = -2 * (centers @ x.T)
    d += np.einsum("ij,ij->i", centers, centers)[:, None]
    d += x_sq.reshape(1, -1)
    return np.maximum(d, 0, out=d)


def _kmeans_plusplus(x, rs):
    """Two k-means++ centres, sklearn's ``_kmeans_plusplus`` with unit
    sample weights and ``2 + int(log 2)`` local trials."""
    n = x.shape[0]
    weight = np.ones(n, dtype=x.dtype)
    x_sq = np.einsum("ij,ij->i", x, x)
    centers = np.empty((N_COMPONENTS, x.shape[1]), dtype=x.dtype)
    centers[0] = x[rs.choice(n, p=weight / weight.sum())]
    closest = _sq_distances(centers[0, np.newaxis], x, x_sq)
    pot = closest @ weight
    for c in range(1, N_COMPONENTS):
        rand_vals = rs.uniform(size=2 + int(np.log(N_COMPONENTS))) * pot
        ids = np.searchsorted(np.cumsum(weight * closest), rand_vals)
        np.clip(ids, None, closest.size - 1, out=ids)
        dist = _sq_distances(x[ids], x, x_sq)
        np.minimum(closest, dist, out=dist)
        cand_pot = dist @ weight.reshape(-1, 1)
        best = np.argmin(cand_pot)
        pot = cand_pot[best]
        closest = dist[best]
        centers[c] = x[ids[best]]
    return centers


def _lloyd_labels(x, centers):
    """Nearest centre, as ``_update_chunk_dense`` scores it
    (``|c|^2 - 2 x.c``, ties to the lower index)."""
    d = -2.0 * (x @ centers.T) + np.einsum("ij,ij->i", centers, centers)
    return np.argmin(d, axis=1).astype(np.int32)


def _lloyd_centers(x, labels):
    """Per-cluster sums accumulated in sample order within each 256-row
    chunk, chunks summed in order, then scaled by 1 / weight."""
    chunk = 256
    sums = np.zeros((N_COMPONENTS, x.shape[1]))
    counts = np.zeros(N_COMPONENTS)
    for start in range(0, x.shape[0], chunk):
        part = np.zeros((N_COMPONENTS, x.shape[1]))
        for i in range(start, min(start + chunk, x.shape[0])):
            part[labels[i]] += x[i]
        sums += part
        counts += np.bincount(labels[start:start + chunk],
                              minlength=N_COMPONENTS)
    if (counts == 0).any():
        raise ValueError("k-means left a cluster empty (duplicate chrY "
                         "fractions?)")
    return sums * (1.0 / counts)[:, None]


def _kmeans_labels(y: np.ndarray, rs: np.random.RandomState) -> np.ndarray:
    """Labels of ``KMeans(n_clusters=2, n_init=1, random_state=rs).fit``
    (lloyd): data centred first, tolerance ``1e-4 * mean(var(X))``."""
    x = np.array(y, dtype=np.float64).reshape(-1, 1)
    tol = np.mean(np.var(x, axis=0)) * KMEANS_TOL
    x -= x.mean(axis=0)
    centers = _kmeans_plusplus(x, rs)
    labels_old = np.full(x.shape[0], -1, dtype=np.int32)
    strict = False
    for _ in range(KMEANS_MAX_ITER):
        labels = _lloyd_labels(x, centers)
        new = _lloyd_centers(x, labels)
        shift_tot = (np.sqrt(((new - centers) ** 2).sum(axis=1)) ** 2).sum()
        centers = new
        if np.array_equal(labels, labels_old):
            strict = True
            break
        if shift_tot <= tol:
            break
        labels_old = labels
    if not strict:
        labels = _lloyd_labels(x, centers)
    return labels


def _logsumexp(a):
    """sklearn's ``utils._array_api._logsumexp`` along axis 1."""
    a_max = np.max(a, axis=1, keepdims=True)
    is_max = a == a_max
    a = a.copy()
    a[is_max] = -np.inf
    m = np.sum(is_max.astype(a.dtype), axis=1, keepdims=True, dtype=a.dtype)
    shift = np.where(np.isfinite(a_max), a_max, 0)
    s = np.sum(np.exp(a - shift), axis=1, keepdims=True, dtype=a.dtype)
    s = np.where(s == 0, s, s / m)
    return np.squeeze(np.log1p(s) + np.log(m) + a_max, axis=1)


def _gaussian_parameters(x, resp):
    """``_estimate_gaussian_parameters(..., "full")`` for one feature:
    (nk, means (K, 1), covariances (K, 1, 1))."""
    nk = resp.sum(axis=0) + 10 * np.finfo(resp.dtype).eps
    means = (resp.T @ x) / nk[:, np.newaxis]
    cov = np.empty((N_COMPONENTS, 1, 1), dtype=x.dtype)
    for k in range(N_COMPONENTS):
        diff = x - means[k, :]
        cov[k] = ((resp[:, k] * diff.T) @ diff) / nk[k]
        cov[k] += REG_COVAR
    return nk, means, cov


def _precisions_cholesky(cov):
    """Cholesky of the 1x1 precisions: ``1 / cholesky(cov)``."""
    if (cov <= 0).any():
        raise ValueError("the mixture fit collapsed a component")
    return 1.0 / np.sqrt(cov)


def _weighted_log_prob(x, weights, means, prec_chol):
    """``_estimate_log_gaussian_prob`` (full, one feature) + log weights."""
    log_prob = np.empty((x.shape[0], N_COMPONENTS), dtype=x.dtype)
    for k in range(N_COMPONENTS):
        pc = prec_chol[k]
        y = (x @ pc) - (means[k, :] @ pc)
        log_prob[:, k] = np.sum(np.square(y), axis=1)
    log_det = np.log(prec_chol.reshape(N_COMPONENTS, -1)[:, ::2]).sum(axis=1)
    return (-0.5 * (math.log(2 * math.pi) + log_prob) + log_det
            + np.log(weights))


def fit_gmm(y: np.ndarray, random_state=0, max_iter: int = 10000,
            tol: float = 1e-12):
    """``GaussianMixture.fit`` for 2 components on 1-D data; returns
    (weights, means, precisions_cholesky), means (2, 1)."""
    x = np.array(y, dtype=np.float64).reshape(-1, 1)
    rs = _random_state(random_state)
    resp = np.zeros((x.shape[0], N_COMPONENTS), dtype=x.dtype)
    resp[np.arange(x.shape[0]), _kmeans_labels(x, rs)] = 1
    weights, means, cov = _gaussian_parameters(x, resp)
    weights /= x.shape[0]
    prec_chol = _precisions_cholesky(cov)
    lower = -np.inf
    for _ in range(max_iter):
        prev = lower
        wlp = _weighted_log_prob(x, weights, means, prec_chol)
        norm = _logsumexp(wlp)
        with np.errstate(under="ignore"):
            log_resp = wlp - norm[:, np.newaxis]
        weights, means, cov = _gaussian_parameters(x, np.exp(log_resp))
        weights /= np.sum(weights)
        prec_chol = _precisions_cholesky(cov)
        lower = np.mean(norm)
        if abs(lower - prev) < tol:
            break
    return weights, means, prec_chol


def train_gender_model(
    samples: list[dict],
    yfrac_override: float | None = None,
    random_state: int | None = 0,
    max_iter: int = 10000,
    tol: float = 1e-12,
):
    """Fit the mixture and derive the M/F cutoff.

    ``random_state`` seeds the k-means start as sklearn's does (None: the
    global numpy ``RandomState``).  Returns (genders list of "M"/"F"/None,
    cutoff float, fit dict)."""
    y_fractions = np.array([y_fraction(s) for s in samples])
    weights, means, prec_chol = fit_gmm(y_fractions, random_state,
                                        max_iter=max_iter, tol=tol)
    density = np.exp(_logsumexp(
        _weighted_log_prob(GRID.reshape(-1, 1), weights, means, prec_chol)))

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

    genders: list = [None] * len(samples)
    for i, yf in enumerate(y_fractions):
        if yf > cutoff:
            genders[i] = "M"
        elif yf < cutoff:
            genders[i] = "F"
    fit = {"y_fractions": y_fractions, "grid": GRID, "density": density,
           "means": means.ravel(), "weights": weights.ravel()}
    return genders, cutoff, fit
