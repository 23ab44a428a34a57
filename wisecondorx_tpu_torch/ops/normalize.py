"""Predict-stage normalization.

Counterpart of wisecondorx_tpu/ops/normalize.py.  The host float64
helpers (coverage normalization, the optimal-cutoff schedule, weights,
the sentinel fold) are copied from the JAX package, whose module imports
JAX; :func:`normalize_repeat` is the three-round z-masked neighbour
normalization as torch ops on the tensor's device.
"""

from __future__ import annotations

import numpy as np
import torch

from wisecondorx_tpu_torch.ops.common import (
    masked_mean,
    masked_median,
    masked_std,
    nanmedian,
)

#: scipy.stats.norm.ppf(0.99) — the reference's aberrant-bin z threshold.
Z_MASK_THRESHOLD = 2.3263478740408408

#: Cutoff-iteration depths cached in the reference npz (``wcx_cutoffs``).
CUTOFF_CACHE_REPEATS = 10

#: Target rows per gather block; bounds the [block, k] gather + sort.
NORMALIZE_BLOCK = 16384


def coverage_normalize_and_mask(
    sample: dict, bins_per_chr: np.ndarray, mask: np.ndarray
) -> np.ndarray:
    """Pad/truncate each chromosome to the reference layout,
    depth-normalize over the pass's chromosome range, apply the mask."""
    parts = []
    for c, n_bins in enumerate(np.asarray(bins_per_chr)):
        arr = np.zeros(int(n_bins), dtype=np.float64)
        chr_data = np.asarray(sample[str(c + 1)])
        m = min(int(n_bins), len(chr_data))
        arr[:m] = chr_data[:m]
        parts.append(arr)
    all_data = np.concatenate(parts)
    all_data = all_data / np.sum(all_data)
    return all_data[np.asarray(mask, dtype=bool)]


def get_optimal_cutoff(distances: np.ndarray, repeats: int) -> float:
    """Iterative mean + 3*std over reference distances; ``repeats <= 0``
    means no distance masking (an infinite cutoff)."""
    if repeats <= 0:
        return float("inf")
    return float(optimal_cutoff_schedule(distances, repeats)[repeats - 1])


def optimal_cutoff_schedule(
    distances: np.ndarray, max_repeats: int = CUTOFF_CACHE_REPEATS
) -> np.ndarray:
    """Cutoff after each of 1..max_repeats iterations, so that
    ``schedule[r-1] == get_optimal_cutoff(d, r)``."""
    distances = np.asarray(distances, dtype=np.float64)
    out = []
    cutoff = np.inf
    prev_n = -1
    for _ in range(max_repeats):
        sel = distances[distances < cutoff]
        if sel.size == prev_n:
            # Unchanged selection: every further iteration repeats.
            out.extend([cutoff] * (max_repeats - len(out)))
            break
        prev_n = sel.size
        cutoff = float(np.mean(sel) + 3 * np.std(sel))
        out.append(cutoff)
    return np.array(out)


def get_weights(distances: np.ndarray) -> np.ndarray:
    """weight_i = 1 / mean(sqrt(distances_i)), host float64.  Degenerate
    rows give NaN, which the predict assembler turns into unweighted CBS
    with a logged warning."""
    distances = np.asarray(distances, dtype=np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        return 1.0 / np.mean(np.sqrt(distances), axis=1)


def sentinel_indexes(
    global_idx: np.ndarray, distances: np.ndarray, optimal_cutoff: float
) -> np.ndarray:
    """Fold the ``distance < cutoff`` neighbour filter into the index
    table: excluded neighbours become -1.  Compared in float64 whatever
    the stored distance type."""
    return np.where(
        np.asarray(distances, dtype=np.float64) < optimal_cutoff,
        global_idx,
        -1,
    ).astype(np.int32)


def normalize_repeat(test_data: torch.Tensor, sentinel_idx: torch.Tensor,
                     ct: int = 0, rounds: int = 3):
    """The reference's three-round z-masked normalization, vectorized
    over target bins, for one sample or a batch of samples.

    ``test_data`` [n] or [c, n]: masked, coverage-normalized, PCA-projected
    sample(s); ``sentinel_idx`` [n - ct, k]: global neighbour indexes of
    the target rows with the distance cutoff folded in as -1, shared by
    the batch; int64 (``PassTables``'s type), which the gather takes
    without a cast in any round.  Bins whose |z| crossed the threshold in an earlier round
    stop serving as neighbours (they become -1 in ``test_copy``); the
    targets' own values always come from ``test_data``.

    Returns (z, r, ref_sizes, m_lr, m_z) as tensors on the input device,
    each with the batch axis of ``test_data`` (m_lr, m_z: one per sample).
    """
    batched = test_data.dim() == 2
    data = test_data if batched else test_data[None]
    targets = data[:, ct:]
    m = sentinel_idx.shape[0]
    block = max(1, NORMALIZE_BLOCK // data.shape[0])
    safe_idx = sentinel_idx.clamp(min=0)
    idx_ok = sentinel_idx >= 0
    test_copy = data.clone()
    z = r = ref_sizes = None
    for _ in range(rounds):
        means, stds, meds, sizes = [], [], [], []
        for a in range(0, m, block):
            b = min(a + block, m)
            neigh = test_copy[:, safe_idx[a:b]]  # [c, block, k]
            valid = idx_ok[a:b] & (neigh >= 0)
            means.append(masked_mean(neigh, valid))
            stds.append(masked_std(neigh, valid))
            meds.append(masked_median(neigh, valid))
            sizes.append(valid.sum(dim=-1))
        mean, std = torch.cat(means, dim=1), torch.cat(stds, dim=1)
        z = (targets - mean) / std
        r = targets / torch.cat(meds, dim=1)
        ref_sizes = torch.cat(sizes, dim=1)
        aberrant = torch.abs(z) >= Z_MASK_THRESHOLD  # NaN -> False
        test_copy[:, ct:] = torch.where(aberrant, -1.0, test_copy[:, ct:])
    out = (z, r, ref_sizes, nanmedian(torch.log2(r)), nanmedian(z))
    return out if batched else tuple(t[0] for t in out)
