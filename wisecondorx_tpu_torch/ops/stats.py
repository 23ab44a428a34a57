"""Segment z-scores and sample-level QC statistics.

Numpy mirrors of reference overall_tools.py:88-148: the between-sample
segment z-score against the null-ratio table, the median segment variance
(MSV) and the copy-number-profile-abnormality (CPA) score.

Copy of wisecondorx_tpu/ops/stats.py, but for the z-score's weighted sums
over the null-ratio table's rows, which a native pass
(``native/nullsums.cpp``) computes one chromosome's intervals at a time,
bit for bit with the numpy version kept here; the port imports nothing of
that package, and tests/test_torch_host.py holds the two to the same
values on either route.
"""

from __future__ import annotations

import ctypes
import logging
import math
import subprocess
import threading

import numpy as np

from wisecondorx_tpu_torch.utils.native import build_library

#: Rows of the null-ratio table reduced by :func:`get_z_score` since the
#: last :func:`reset_z_row_counts`, by route: ``native`` (one
#: ``native/nullsums.cpp`` call a chromosome) or ``numpy``
#: (:func:`_numpy_null_sums`).
Z_ROWS = {"native": 0, "numpy": 0}

_SUMS_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()
#: None until :func:`load_null_sums` first runs, then the library or False.
_null_sums = None


def reset_z_row_counts() -> None:
    with _COUNT_LOCK:
        for key in Z_ROWS:
            Z_ROWS[key] = 0


def _count(route: str, rows: int) -> None:
    with _COUNT_LOCK:
        Z_ROWS[route] += rows


def load_null_sums():
    """The native null-sum pass (``native/nullsums.cpp``), built with g++
    if needed and loaded once per process; None, after one warning, when
    it cannot be built or loaded (the sums then take numpy)."""
    global _null_sums
    with _SUMS_LOCK:
        if _null_sums is None:
            try:
                lib = ctypes.CDLL(
                    str(build_library("wcxnullsums", ["nullsums.cpp"]))
                )
            except (OSError, subprocess.CalledProcessError) as exc:
                logging.warning(
                    "The native z-score sums did not build or load (%s); "
                    "they are computed with numpy.", exc
                )
                _null_sums = False
            else:
                lib.wcx_null_sums.restype = ctypes.c_int64
                lib.wcx_null_sums.argtypes = [
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                    ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_void_p,
                ]
                _null_sums = lib
        return _null_sums or None


def row_ordered(width: int) -> bool:
    """Whether numpy sums axis 0 of a C-contiguous ``[rows, width]``
    float64 table row after row, the order the native pass adds in.  At
    width 1 the table is one run of memory, which numpy sums pairwise."""
    return width > 1


def _numpy_null_sums(rr, ww, nr):
    """The plain version of ``native/nullsums.cpp`` for one interval's
    rows: per null column, the weighted sum of the finite null ratios over
    the informative bins (``r != 0``), the sum of their weights, and the
    number of informative bins."""
    rr = np.asarray(rr, dtype=float)
    nr = np.asarray(nr, dtype=float)
    ww = np.asarray(ww, dtype=float)
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
    _count("numpy", len(rr))
    return num, den, nr_sel.shape[0]


def _native_null_sums(rows, results_r, results_w, results_nr) -> dict:
    """{index into ``rows``: (num, den, informative bins)} from the native
    pass, one call a chromosome, for the chromosomes it takes: float64 null
    tables contiguous along a width :func:`row_ordered` admits, and ratios
    and weights of their length.  The other rows are left to numpy."""
    lib = load_null_sums()
    if lib is None:
        return {}
    by_chrom = {}
    for i, (chrom, s, e, _) in enumerate(rows):
        by_chrom.setdefault(chrom, []).append((i, s, e))
    out = {}
    for chrom, items in by_chrom.items():
        try:
            r = np.asarray(results_r[chrom], dtype=np.float64)
            w = np.asarray(results_w[chrom], dtype=np.float64)
            nr = np.asarray(results_nr[chrom])
            # Python's slicing, as numpy's route applies it.
            bounds = np.array(
                [slice(s, e).indices(len(r))[:2] for _, s, e in items],
                dtype=np.int64,
            ).reshape(-1, 2)
        except (TypeError, ValueError, IndexError):
            continue
        if not (r.ndim == w.ndim == 1 and nr.ndim == 2
                and nr.dtype == np.float64 and row_ordered(nr.shape[1])
                and len(r) == len(w) == nr.shape[0]
                and nr.strides[1] == nr.itemsize
                and nr.strides[0] % nr.itemsize == 0):
            continue
        r, w = np.ascontiguousarray(r), np.ascontiguousarray(w)
        bounds[:, 1] = np.maximum(bounds[:, 1], bounds[:, 0])
        width = nr.shape[1]
        num = np.empty((len(items), width))
        den = np.empty((len(items), width))
        informative = np.empty(len(items), np.int64)
        if lib.wcx_null_sums(
            r.ctypes.data, w.ctypes.data, nr.ctypes.data, len(r),
            nr.strides[0] // nr.itemsize, width, bounds.ctypes.data,
            len(items), num.ctypes.data, den.ctypes.data,
            informative.ctypes.data,
        ) != 0:
            raise RuntimeError(f"native z-score sums failed on {chrom}")
        _count("native", int((bounds[:, 1] - bounds[:, 0]).sum()))
        for t, (i, _, _) in enumerate(items):
            out[i] = num[t], den[t], int(informative[t])
    return out


def get_z_score(results_c, results_r, results_w, results_nr):
    """Per-segment z vs the weighted null-ratio distribution
    (reference overall_tools.py:88-119).

    ``results_c`` rows are [chr0, start, end, ratio]; returns a list of
    floats clipped to +-1000, or the string "nan" where the null is
    degenerate (reference emits that literal into its BED files).  The
    weighted null sums come from the native pass where it takes the
    chromosome, else from numpy; both give the same bits.
    """
    rows = [seg[:4] for seg in results_c]
    native = _native_null_sums(rows, results_r, results_w, results_nr)
    zs = []
    for i, (chrom, s, e, r_seg) in enumerate(rows):
        if i in native:
            num, den, informative = native[i]
        else:
            num, den, informative = _numpy_null_sums(
                results_r[chrom][s:e], results_w[chrom][s:e],
                results_nr[chrom][s:e],
            )
        with np.errstate(invalid="ignore", divide="ignore"):
            null_segments = np.where(den > 0, num / den, np.nan)

        finite = np.isfinite(null_segments)
        if informative == 0 or not finite.any():
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
