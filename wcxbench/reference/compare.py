"""Read the tables a predict wrote and hold them to the plain reference.

The per-bin ratios, z-scores and the sex call are held to the reference's
own: its float64 rebuild of the reference from the controls, then its
normalization of the sample's counts.  The segments and calls follow the
program step by step: the frozen CBS runs on the program's printed
ratios, with the weights and null ratios of the reference the program
built, since the permutation stream is keyed by the bytes of the ratios
and a float64 ratio draws another stream; those ratios, and that
reference's tables, are each held to the rebuild by themselves.

Each sample's ``<outid>_bins.bed``, ``_segments.bed``, ``_aberrations.bed``
and ``_statistics.txt`` are read back as written.  A bin the tables leave
"nan" is a zero (masked or blanked) bin, as the writer maps zeros to
"nan".  The ratios are parsed in the precision they were printed in (the
shortest text of a float32 or of a float64), so that the frozen CBS gets
the program's values bit for bit.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

from wcxbench.reference.predict import CHR_NAMES, reference_segments

_CHR_INDEX = {name: i for i, name in enumerate(CHR_NAMES)}
TABLES = ("bins.bed", "segments.bed", "aberrations.bed", "statistics.txt")


def _lines(path):
    with open(path) as f:
        return f.read().splitlines()


def _column(strings):
    """float64 values of printed floats, "nan" as 0; parsed as float32
    where every value is the shortest text of a float32."""
    vals = [s for s in strings if s != "nan"]
    as32 = all(str(np.float32(s)) == s for s in vals[:2000])
    dt = np.float32 if as32 else np.float64
    out = np.array([0.0 if s == "nan" else s for s in strings], dtype=dt)
    return out.astype(np.float64)


def read_tables(outid: str) -> dict | None:
    """The program's tables for one sample, or None where any is missing."""
    paths = {k: f"{outid}_{k}" for k in TABLES}
    if not all(os.path.exists(p) for p in paths.values()):
        return None
    rows = [ln.split("\t") for ln in _lines(paths["bins.bed"])[1:]]
    chrom = np.array([_CHR_INDEX[r[0]] for r in rows])
    r = _column([row[4] for row in rows])
    z = _column([row[5] for row in rows])
    n_chr = int(chrom.max()) + 1 if len(chrom) else 0
    bounds = np.searchsorted(chrom, np.arange(1, n_chr))
    gender = next(ln.split(": ")[1] for ln in _lines(paths["statistics.txt"])
                  if ln.startswith("Gender"))
    return {
        "r": np.split(r, bounds), "z": np.split(z, bounds),
        "segments": _lines(paths["segments.bed"])[1:],
        "calls": _lines(paths["aberrations.bed"])[1:],
        "gender": gender,
    }


def _gaps(got: list, want: list, relative: bool) -> np.ndarray:
    if len(got) != len(want) or any(len(a) != len(b) for a, b in zip(got, want)):
        return np.array([np.inf])
    g, w = np.concatenate(got), np.concatenate(want)
    gap = np.abs(g - w)
    if relative:
        gap = gap / np.maximum(1.0, np.abs(w))
    return np.where(np.isnan(gap), np.inf, gap)


def _widest(gaps: np.ndarray, expected: dict) -> float:
    """The widest gap over the bins whose value the reference determines
    at the configuration's precision (every bin where shapes differ)."""
    skip = np.concatenate(expected["undetermined"])
    if len(skip) != len(gaps):
        return float(gaps.max())
    kept = gaps[~skip]
    return float(kept.max()) if kept.size else 0.0


class PredictCheck:
    """Accumulates the comparison of many samples' tables.  Tables
    byte-equal to ones already judged against the same expectation count
    again without being read twice, and the reference's CBS runs once per
    distinct set of program ratios."""

    def __init__(self, alpha: float, zscore: float, device):
        self.alpha, self.zscore, self.device = alpha, zscore, device
        self._segments: dict = {}
        self._judged: dict = {}
        self.missing = 0
        self.judged: list = []

    def _cbs(self, ratios: list, state: dict) -> dict:
        key = (id(state), b"".join(a.tobytes() for a in ratios))
        if key not in self._segments:
            self._segments[key] = reference_segments(
                ratios, state, self.alpha, self.zscore, self.device)
        return self._segments[key]

    def judge_bins(self, got: dict, expected: dict) -> dict:
        """Gaps of per-chromosome ratios and z-scores ``got["r"]``,
        ``got["z"]`` from the reference's."""
        ratio = _gaps(got["r"], expected["r"], relative=False)
        z = _gaps(got["z"], expected["z"], relative=True)
        return {"ratio": ratio, "z": z, "ratio_max": _widest(ratio, expected),
                "z_max": _widest(z, expected), "segments": 0, "calls": 0,
                "undetermined": int(np.concatenate(expected["undetermined"]).sum())}

    def judge(self, got: dict, expected: dict, state: dict) -> dict:
        """``expected``: the reference's own bins; ``state``: its bins from
        the program's reference, whose weights and null ratios the
        segments' step-by-step check takes."""
        out = self.judge_bins(got, expected)
        if len(got["r"]) != len(expected["r"]) or len(got["r"]) != len(state["w"]):
            out["segments"] = max(1, len(got["segments"]))
            out["calls"] = max(1, len(got["calls"]))
            return out
        want = self._cbs(got["r"], state)
        out["segments"] = len(set(got["segments"]) ^ set(want["segments"]))
        out["calls"] = (len(set(got["calls"]) ^ set(want["calls"]))
                        + (got["gender"] != expected["gender"]))
        return out

    def add(self, outid: str, expected: dict, state: dict) -> None:
        """Judge one sample's tables at ``outid`` against ``expected`` (and
        ``state``, as :meth:`judge` takes them)."""
        paths = [f"{outid}_{k}" for k in TABLES]
        if not all(os.path.exists(p) for p in paths):
            self.missing += 1
            return
        digest = hashlib.sha256()
        for p in paths:
            with open(p, "rb") as f:
                digest.update(f.read())
        key = (id(expected), digest.digest())
        if key not in self._judged:
            self._judged[key] = self.judge(read_tables(outid), expected, state)
        self.judged.append(self._judged[key])

    def numbers(self) -> dict:
        j = self.judged
        if not j:
            inf = float("inf")
            return {"samples_missing": self.missing, "ratio_gap_median": inf,
                    "ratio_gap_max": inf, "z_gap_median": inf, "z_gap_max": inf,
                    "segments_differ": 0, "calls_differ": 0}
        return {
            "samples_missing": self.missing,
            "ratio_gap_median": float(np.median(np.concatenate([x["ratio"] for x in j]))),
            "ratio_gap_max": max(x["ratio_max"] for x in j),
            "z_gap_median": float(np.median(np.concatenate([x["z"] for x in j]))),
            "z_gap_max": max(x["z_max"] for x in j),
            "segments_differ": sum(x["segments"] for x in j),
            "calls_differ": sum(x["calls"] for x in j),
        }
