"""Segment z-scores and sample-level QC statistics.

Numpy mirrors of reference overall_tools.py:88-148: the between-sample
segment z-score against the null-ratio table, the median segment variance
(MSV) and the copy-number-profile-abnormality (CPA) score.  These operate
on a handful of segments — host numpy is the right tool (SURVEY.md 2.24-25).

Copy of wisecondorx_tpu/ops/stats.py; the port imports nothing of that
package.
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


def get_median_segment_variance(results_c, results_r):
    """MSV (reference overall_tools.py:127-135; doi 10.1093/nar/gky1263)."""
    variances = []
    for seg in results_c:
        chrom, s, e = seg[0], int(seg[1]), int(seg[2])
        seg_r = [x for x in results_r[chrom][s:e] if x != 0]
        if seg_r:
            variances.append(np.var(seg_r))
    if not variances:
        return float("nan")
    return float(np.median(variances))


def get_cpa(results_c, binsize):
    """CPA score (reference overall_tools.py:143-148;
    doi 10.1186/s13073-020-00735-4).

    Parity note: the rows arriving here are the 5-column
    ``[chr, start, end, segment_z, ratio]`` produced by exec_cbs
    (predict_tools.py:259-262), so ``segment[3]`` — and therefore the CPA
    sum — is the *z-score*, not the ratio.  Degenerate segments carry the
    string "nan" there, on which the reference raises TypeError; we map it
    to NaN instead (documented fix).
    """
    x = 0.0
    for seg in results_c:
        v = float(seg[3]) if not isinstance(seg[3], str) else float("nan")
        x += (int(seg[2]) - int(seg[1]) + 1) * binsize * abs(v)
    return x / len(results_c) * 1e-8
