"""Reference quality control.

Scores a built reference npz before it is used for prediction.  The
behavioral contract (metric definitions, thresholds and the first-match
decision order) follows reference ref_qc.py:22-137 — a fork addition —
but the statistics here are computed as whole-array reductions rather
than the reference's per-bin Python loop, and the rule chains are data
(ordered rule tables) rather than if-cascades.

Metrics per pass (A / F / M key suffix):

* per-bin mean neighbour distance, its cohort mean and spread;
* the share of bins whose mean distance sits >= 3 sigma above the cohort
  mean ("outlier bins");
* bins holding fewer than 150 neighbour slots;
* for the M pass, the same numbers restricted to chrY.

Thresholds (kept verbatim from the reference, they are the spec):
150 neighbour slots; spread 2 / 10 (F passes), mean 2 / 10 (M pass),
chrY mean 5 / 100, outlier share 1%.

The reference's ``newref`` stage calls ``qc_reference`` without importing
it and dies with NameError after writing its outputs (reference
main.py:135, SURVEY.md 2.15); here the call is wired for real
(see cli.py).

Copy of wisecondorx_tpu/ref_qc.py without its file-path entry point (the
port's ``newref`` scores the in-memory arrays); the port imports nothing of
that package.
"""

from __future__ import annotations

import dataclasses
import logging
import math

import numpy as np

#: A bin serving fewer neighbour slots than this is considered shallow.
MIN_NEIGHBOUR_SLOTS = 150
#: Sigma multiplier defining a distance-outlier bin.
OUTLIER_SIGMA = 3

PASS, WARN, FAIL = 0, 1, 2
_SEVERITY_NAME = {PASS: "PASS", WARN: "WARN", FAIL: "FAIL"}
_SEVERITY_LOG = {PASS: logging.info, WARN: logging.warning, FAIL: logging.error}


@dataclasses.dataclass
class PassStats:
    """Distance statistics for one reference pass (or its chrY slice)."""

    n_bins: int = 0
    n_usable: int = 0  # bins with a finite mean distance
    dist_mean: float = math.nan  # cohort mean of per-bin mean distances
    dist_spread: float = math.nan  # cohort std of per-bin mean distances
    n_outliers: int = 0
    pct_outliers: float = 0.0
    n_shallow: int = 0  # bins with < MIN_NEIGHBOUR_SLOTS neighbour slots
    chr_y: "PassStats | None" = None

    @property
    def usable(self) -> bool:
        return self.n_usable > 0


def _reduce(mean_d: np.ndarray, slots: np.ndarray, outlier_cut: float | None):
    """Whole-array reduction of per-bin mean distances into a PassStats.

    ``outlier_cut`` is inherited from the full pass when reducing the chrY
    slice (the reference anchors chrY outliers to the pass-wide cutoff,
    ref_qc.py:41-66)."""
    st = PassStats(n_bins=int(mean_d.shape[0]))
    finite = np.isfinite(mean_d)
    st.n_usable = int(finite.sum())
    if not st.n_usable:
        return st, outlier_cut
    good = mean_d[finite]
    st.dist_mean = float(good.mean())
    st.dist_spread = float(good.std())
    if outlier_cut is None:
        outlier_cut = st.dist_mean + OUTLIER_SIGMA * st.dist_spread
    st.n_outliers = int((good >= outlier_cut).sum())
    st.pct_outliers = 100.0 * st.n_outliers / st.n_usable
    st.n_shallow = int((slots < MIN_NEIGHBOUR_SLOTS).sum())
    return st, outlier_cut


def _pass_stats(ref, suffix: str) -> PassStats | None:
    """Extract + reduce one pass from an opened reference npz."""
    try:
        distances = np.atleast_2d(
            np.asarray(ref["distances" + suffix], dtype=float)
        )
        indexes = np.atleast_2d(ref["indexes" + suffix])
    except KeyError:
        return None
    if not len(indexes):
        return PassStats()

    mean_d = distances.mean(axis=1)
    # The reference counts allocated neighbour slots, not filled ones
    # (ref_qc.py:37) — a shallow verdict therefore only fires when the
    # reference was built with refsize < 150.
    slots = np.full(mean_d.shape[0], indexes.shape[1], dtype=np.int64)
    st, cut = _reduce(mean_d, slots, None)

    if suffix == ".M" and st.usable:
        cum_key = "masked_bins_per_chr_cum" + suffix
        if cum_key in ref:
            cum = np.atleast_1d(ref[cum_key][...])
            if len(cum) >= 24:
                y0, y1 = int(cum[22]), int(cum[23])
                st.chr_y, _ = _reduce(mean_d[y0:y1], slots[y0:y1], cut)
    return st


# Ordered first-match rule chains.  Order is part of the contract: a
# shallow-slots WARN shadows a spread/mean FAIL, exactly as in the
# reference's if-cascade (ref_qc.py:105-137).
_RULES_AUTOSOMAL = (
    (lambda s: s.n_shallow > 0, WARN,
     lambda s: f"{s.n_shallow} bins hold fewer than "
               f"{MIN_NEIGHBOUR_SLOTS} neighbour slots"),
    (lambda s: s.dist_spread > 10, FAIL,
     lambda s: f"mean-distance spread {s.dist_spread:.2f} is far above "
               "normal"),
    (lambda s: s.dist_spread > 2, WARN,
     lambda s: f"mean-distance spread {s.dist_spread:.2f} is elevated"),
    (lambda s: s.pct_outliers > 1, WARN,
     lambda s: f"{s.pct_outliers:.2f}% of bins are {OUTLIER_SIGMA}-sigma "
               "distance outliers"),
)

_RULES_MALE = (
    (lambda s: s.n_shallow > 0, WARN,
     lambda s: f"{s.n_shallow} bins hold fewer than "
               f"{MIN_NEIGHBOUR_SLOTS} neighbour slots"),
    (lambda s: s.dist_mean > 10, FAIL,
     lambda s: f"cohort mean distance {s.dist_mean:.2f} indicates a heavy "
               "tail"),
    (lambda s: s.dist_mean > 2, WARN,
     lambda s: f"cohort mean distance {s.dist_mean:.2f} is elevated"),
    (lambda s: s.chr_y is not None and s.chr_y.usable
     and s.chr_y.dist_mean > 100, FAIL,
     lambda s: f"chrY mean distance {s.chr_y.dist_mean:.1f} — chrY is "
               "effectively unusable"),
    (lambda s: s.chr_y is not None and s.chr_y.usable
     and s.chr_y.dist_mean > 5, WARN,
     lambda s: f"chrY mean distance {s.chr_y.dist_mean:.1f} is high"),
    (lambda s: s.pct_outliers > 1, WARN,
     lambda s: f"{s.pct_outliers:.2f}% of bins are {OUTLIER_SIGMA}-sigma "
               "distance outliers"),
)


def _judge(stats: PassStats | None, rules) -> tuple[int, str]:
    if stats is None or not stats.usable:
        return FAIL, "pass contains no usable distance data"
    for predicate, severity, message in rules:
        if predicate(stats):
            return severity, message(stats)
    return PASS, ""


def _passes_in(ref) -> list[str]:
    """Key suffixes present: sex-specific passes win over the plain one."""
    keys = set(ref.keys())
    found = [s for s in (".F", ".M") if "bins_per_chr" + s in keys]
    if not found and "bins_per_chr" in keys:
        found = [""]
    return found


def _describe(st: PassStats) -> str:
    return (
        f"bins={st.n_bins} mean_dist={st.dist_mean:.4f} "
        f"spread={st.dist_spread:.4f} outliers={st.n_outliers} "
        f"({st.pct_outliers:.2f}%) shallow(<{MIN_NEIGHBOUR_SLOTS})="
        f"{st.n_shallow}"
    )


def qc_reference_arrays(ref, label="in-memory reference") -> int:
    """Score a reference from its flat suffixed-key mapping — either an
    opened npz or the in-memory dict from
    :func:`wisecondorx_tpu_torch.io.npz.flatten_reference` (the ``newref``
    CLI path, which skips re-decompressing the file it just wrote).
    Returns the worst severity: 0/1/2.

    Logs one metrics line per pass (plus a chrY detail line for the M
    pass) and an overall verdict."""
    passes = _passes_in(ref)
    if not passes:
        logging.error(
            "Reference QC: %s has no bins_per_chr key in any pass — "
            "not a reference npz?",
            label,
        )
        return FAIL

    try:
        binsize = int(np.atleast_1d(ref["binsize"])[0])
    except (KeyError, TypeError, ValueError):
        binsize = None
    logging.info(
        "Reference QC on %s (binsize %s)",
        label,
        f"{binsize} bp" if binsize else "unknown",
    )

    worst = PASS
    for suffix in passes:
        label_g = {"": "A", ".F": "F", ".M": "M"}[suffix]
        stats = _pass_stats(ref, suffix)
        if stats is None:
            logging.warning(
                "[%s] pass has no indexes/distances keys — skipped",
                label_g,
            )
            continue

        rules = _RULES_MALE if label_g == "M" else _RULES_AUTOSOMAL
        severity, reason = _judge(stats, rules)
        worst = max(worst, severity)
        emit = _SEVERITY_LOG[severity]
        if stats.usable:
            emit("[%s] %s", label_g, _describe(stats))
            if stats.chr_y is not None and stats.chr_y.usable:
                emit("[%s]   chrY: %s", label_g, _describe(stats.chr_y))
        else:
            emit("[%s] bins=%d, none usable", label_g, stats.n_bins)
        emit(
            "[%s] verdict: %s%s",
            label_g,
            _SEVERITY_NAME[severity],
            f" — {reason}" if reason else "",
        )

    if worst == PASS:
        logging.info("Reference QC verdict: PASS")
    elif worst == WARN:
        logging.warning(
            "Reference QC verdict: WARN — inspect the per-pass metrics above"
        )
    else:
        logging.error(
            "Reference QC verdict: FAIL — predictions from this reference "
            "are likely unreliable; rebuild it from more or cleaner "
            "control samples"
        )
    return worst
