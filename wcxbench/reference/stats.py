"""Segment z-scores against the null-ratio table: the plain reference.

A frozen copy of the port's ``ops/stats.py:get_z_score`` (itself a numpy
mirror of WisecondorX's overall_tools.py:88-119), kept here so that a later
change to the program cannot move the yardstick.
"""

from __future__ import annotations

import math

import numpy as np


def get_z_score(results_c, results_r, results_w, results_nr):
    """Per-segment z vs the weighted null-ratio distribution
    (reference overall_tools.py:88-119).

    ``results_c`` rows are [chr0, start, end, ratio]; returns a list of
    floats clipped to +-1000, or the string "nan" where the null is
    degenerate (reference emits that literal into its BED files).
    """
    zs = []
    for chrom, s, e, r_seg in (seg[:4] for seg in results_c):
        rr = np.asarray(results_r[chrom][s:e], dtype=float)
        nr = np.asarray(results_nr[chrom][s:e], dtype=float)
        ww = np.asarray(results_w[chrom][s:e], dtype=float)
        sel = rr != 0
        nr_sel = nr[sel]
        w_sel = ww[sel]
        nr_sel = np.where(np.isfinite(nr_sel), nr_sel, np.nan)

        # Weighted average per null sample over informative bins,
        # NaN-masked (np.ma.average semantics).
        ok = ~np.isnan(nr_sel)  # [m, n_null]
        den = np.sum(w_sel[:, None] * ok, axis=0)
        with np.errstate(invalid="ignore", divide="ignore"):
            num = np.nansum(nr_sel * w_sel[:, None], axis=0)
            null_segments = np.where(den > 0, num / den, np.nan)

        finite = np.isfinite(null_segments)
        if nr_sel.shape[0] == 0 or not finite.any():
            zs.append("nan")
            continue
        null_mean = float(np.mean(null_segments[finite]))
        null_sd = float(np.std(null_segments[finite]))
        if math.isnan(null_mean) or math.isnan(null_sd):
            zs.append("nan")
            continue
        with np.errstate(invalid="ignore", divide="ignore"):
            z = (float(r_seg) - null_mean) / null_sd
        if math.isnan(z):
            zs.append("nan")
            continue
        zs.append(float(min(max(z, -1000.0), 1000.0)))
    return zs
