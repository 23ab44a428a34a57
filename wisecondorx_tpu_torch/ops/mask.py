"""Usability-mask construction (reference newref_tools.py:77-102).

A bin is usable when, after per-sample depth normalization, the summed
coverage across samples exceeds 5% of the median nonzero per-bin coverage
(the 5%-floor is a reference-fork addition on top of the upstream
zero-coverage mask; SURVEY.md 2.6).

Copy of the part of wisecondorx_tpu/ops/mask.py that newref uses; the port
imports nothing of that package.  Host numpy: it runs once per reference
build.
"""

from __future__ import annotations

import numpy as np


def _threshold(sum_per_bin: np.ndarray) -> np.ndarray:
    median_cov = np.median(sum_per_bin[sum_per_bin > 0])
    return sum_per_bin > (0.05 * median_cov)


def get_masks(matrix: np.ndarray, col_subsets, block: int = 32768):
    """Usability masks for the full cohort and per-gender column subsets
    in ONE chunked pass — bit-identical to thresholding the depth-normalized
    ``matrix`` / ``matrix[:, cols]`` (elementwise division and the
    per-row pairwise sums are unchanged by row blocking), with ~130 MB
    peak temporaries instead of several full-matrix copies.

    ``col_subsets``: list of boolean column selectors (None = all).
    Returns one bool[total_bins] mask per subset.
    """
    matrix = np.asarray(matrix)
    totals = matrix.sum(axis=0)
    sums = [
        np.empty(matrix.shape[0], dtype=np.float64) for _ in col_subsets
    ]
    for a in range(0, matrix.shape[0], block):
        chunk = matrix[a : a + block] / totals
        for out, cols in zip(sums, col_subsets):
            sel = chunk if cols is None else chunk[:, cols]
            out[a : a + block] = sel.sum(axis=1)
    return [_threshold(s) for s in sums]
