"""The plain reference of ``predict``: what each sample's tables must say.

Written from WisecondorX's published predict semantics (predict_tools.py,
overall_tools.py, predict_output.py) as plain torch and numpy, imports
nothing of the program, and reads the sample's counts and a reference in
the layout of a ``.npz``: the check's own float64 rebuild from the
controls (``reference/newref.py``), or, for the segments' step-by-step
check, the one the program built:

1. coverage-normalize each pass (the autosomal one and the gonosomal one
   the sample's sex resolves to), apply its mask and divide by the PCA
   reconstruction from the stored components;
2. three rounds of neighbour normalization: each target bin against its
   stored neighbours whose distance is below the reference's optimal
   cutoff, bins with |z| >= norm.ppf(0.99) leaving the neighbour pool
   after each round (a bin whose |z| lies within a hair of the
   threshold leaves the bins that drew on it undetermined at float32
   precision: the widest gaps skip them);
3. combine, blank bins with fewer than ``minrefbins`` neighbours, log2 and
   recentre: the per-bin ratios and z-scores of ``<outid>_bins.bed``;
4. segments and calls: the frozen CBS (``reference/cbs.py``) and segment
   z-scores (``reference/stats.py``), in the program's own table format.

``dtype`` and ``tf32`` give the lower-precision control: float32 with the
PCA products' inputs rounded to TF32 (10 mantissa bits, ties away from
zero, as the tensor cores round them).
"""

from __future__ import annotations

import numpy as np
import torch

from wcxbench.reference import cbs as cbs_ref
from wcxbench.reference import stats as stats_ref

#: scipy.stats.norm.ppf(0.99): the aberrant-bin z threshold.
Z_MASK = 2.3263478740408408
#: Relative distance of |z| from Z_MASK within which a bin's masking
#: decision is taken as undetermined at float32 precision (float32 puts
#: |z| about 1e-6 off, relative), and within which it stays so for a bin
#: whose own pool held an undetermined bin (its z then moves by up to one
#: order statistic of about 300, some 1e-3).
UNDETERMINED, UNDETERMINED_WIDE = 1e-4, 1e-2
#: A log2 ratio this close to 0 before the recentring may be exactly 0
#: at float32 precision, which WisecondorX leaves uncentred (a target
#: equal to its neighbours' median): its recentring is not determined.
ZERO_LR = 1e-5
#: Relative distance within which two neighbour distances, or a distance
#: and the optimal cutoff, are not told apart at float32 precision: the
#: program's distances sit within 5e-6 (relative to the row's k-th) of
#: the exact ones.  A row whose usable neighbours differ from the exact
#: ones only across such a near tie is not determined by the
#: configuration's precision.
TIE = 1e-4
#: chromosome names as the tables write them.
CHR_NAMES = [str(c) for c in range(1, 23)] + ["X", "Y"]


def load_reference(path: str) -> dict:
    with np.load(path, encoding="latin1", allow_pickle=True) as npz:
        return {k: npz[k] for k in npz.files}


def cutoff_schedule(distances: np.ndarray, repeats: int) -> list:
    """The optimal cutoffs after 1..``repeats`` rounds of mean + 3 sd of
    the reference distances below the last one (float64)."""
    d = np.asarray(distances, dtype=np.float64).ravel()
    cutoff, out = np.inf, []
    for _ in range(repeats):
        sel = d[d < cutoff]
        cutoff = float(np.mean(sel) + 3 * np.std(sel))
        out.append(cutoff)
    return out


def optimal_cutoff(distances: np.ndarray, repeats: int) -> float:
    """Iterated mean + 3 sd of the reference distances (float64)."""
    return cutoff_schedule(distances, repeats)[-1] if repeats > 0 else float("inf")


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10 mantissa bits (ties away from
    zero)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def _mm(a, b, tf32: bool):
    if tf32:
        return round_tf32(a) @ round_tf32(b)
    return a @ b


def _median(x, valid):
    """numpy's median (mean of the two middles) of each row's valid lanes;
    NaN where none is valid."""
    s = torch.where(valid, x, torch.inf).sort(dim=1).values
    n = valid.sum(dim=1)
    k = x.shape[1]
    lo = s.gather(1, ((n - 1) // 2).clamp(0, k - 1)[:, None])[:, 0]
    hi = s.gather(1, (n // 2).clamp(0, k - 1)[:, None])[:, 0]
    return torch.where(n > 0, (lo + hi) * 0.5, torch.nan)


def _nanmedian(x):
    x = x[~torch.isnan(x)]
    if x.numel() == 0:
        return float("nan")
    s = x.sort().values
    n = s.numel()
    return float((s[(n - 1) // 2] + s[n // 2]) * 0.5)


def _suffix(gender: str) -> str:
    return "" if gender == "A" else f".{gender}"


def _pass_layout(ref: dict, gender: str):
    sfx = _suffix(gender)
    counts = np.asarray(ref["masked_bins_per_chr" + sfx], dtype=np.int64)
    starts = np.cumsum(counts) - counts
    chr_of_row = np.repeat(np.arange(len(counts)), counts)
    ct = 0 if gender == "A" else int(np.cumsum(counts)[21])
    return counts, starts, chr_of_row, ct


def normalize_pass(counts: dict, ref: dict, gender: str, cutoff: float,
                   dtype=torch.float64, tf32: bool = False,
                   device="cpu", rounds: int = 3):
    """One pass's per-target-bin (z, r, neighbour count), as numpy float64,
    and its weights 1 / mean(sqrt(distance))."""
    sfx = _suffix(gender)
    parts = []
    for c, n in enumerate(np.asarray(ref["bins_per_chr" + sfx])):
        arr = np.zeros(int(n), dtype=np.float64)
        chr_data = np.asarray(counts[str(c + 1)])
        m = min(int(n), len(chr_data))
        arr[:m] = chr_data[:m]
        parts.append(arr)
    cov = np.concatenate(parts)
    cov = cov / np.sum(cov)
    x = cov[np.asarray(ref["mask" + sfx], dtype=bool)]

    comps, mean, ct, gidx_t, ok, weights, fixed = _cached(
        ref, ("pass", gender, cutoff, dtype, str(device)),
        lambda: _pass_tables(ref, gender, cutoff, dtype, device))
    xt = torch.as_tensor(x, dtype=dtype, device=device)
    coeffs = _mm((xt - mean)[None], comps.T, tf32)
    proj = xt / (_mm(coeffs, comps, tf32)[0] + mean)

    targets = proj[ct:]
    pool = proj.clone()
    # Bins whose masking decision float32 arithmetic could take either
    # way (|z| within a hair of the threshold), the target rows whose
    # neighbour pool held such a bin, and the rows whose usable
    # neighbours differ across a near tie (``undetermined_rows``): their
    # values are not determined at the configuration's precision.
    near = torch.zeros(pool.shape[0], dtype=torch.bool, device=device)
    undetermined = fixed.clone()
    for i in range(rounds):
        neigh = pool[gidx_t]
        valid = ok & (neigh >= 0)
        undetermined |= (near[gidx_t] & ok).any(dim=1)
        n = valid.sum(dim=1)
        mean_n = torch.where(valid, neigh, 0.0).sum(dim=1) / n
        dev_n = torch.where(valid, neigh - mean_n[:, None], 0.0)
        sd = torch.sqrt((dev_n * dev_n).sum(dim=1) / n)
        z = (targets - mean_n) / sd
        r = targets / _median(neigh, valid)
        aberrant = torch.abs(z) >= Z_MASK
        if i < rounds - 1:
            margin = torch.where(undetermined, UNDETERMINED_WIDE, UNDETERMINED)
            near[ct:] |= (torch.abs(z).double() - Z_MASK).abs() <= margin * Z_MASK
        pool[ct:] = torch.where(aberrant, -1.0, pool[ct:])
    z64, r64 = z.double(), r.double()
    m_lr = _nanmedian(torch.log2(r64))
    m_z = _nanmedian(z64)
    return (z64.cpu().numpy(), r64.cpu().numpy(), n.cpu().numpy(), weights,
            m_lr, m_z, undetermined.cpu().numpy())


def neighbour_sets_differ(got_idx, want_idx, device="cpu") -> np.ndarray:
    """Rows whose two neighbour tables (one index space) hold different
    sets."""
    t = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device).sort(dim=1).values
    return (t(got_idx) != t(want_idx)).any(dim=1).cpu().numpy()


def excused_rows(got: dict, want: dict, maskrepeats: int, device="cpu") -> dict:
    """``{"undetermined_rows<pass>": rows}`` of ``want`` (a rebuild's
    arrays): the rows whose usable neighbours (distance below the optimal
    cutoff) differ in ``got`` (a reference the program built) from the
    rebuild's, where the rebuild's set lies across a near tie (its k-th
    and (k+1)-th distances, or a distance and the cutoff, within TIE).
    A pass whose tables do not line up gives none."""
    got_cut, want_cut = (_cached(ref, ("cutoff", maskrepeats),
                                 lambda: optimal_cutoff(ref["distances"], maskrepeats))
                         for ref in (got, want))
    out = {}
    for sfx in ("", ".F", ".M"):
        key = "indexes" + sfx
        if key not in want or key not in got or np.shape(got[key]) != np.shape(want[key]):
            continue
        want_d = np.asarray(want["distances" + sfx])
        got_d = np.asarray(got["distances" + sfx])
        differ = neighbour_sets_differ(np.where(got_d < got_cut, got[key], -1),
                                       np.where(want_d < want_cut, want[key], -1),
                                       device)
        fragile = np.array(want["ties" + sfx], dtype=bool)
        if np.isfinite(want_cut):
            fragile |= (np.abs(want_d - want_cut) <= TIE * want_cut).any(axis=1)
        out["undetermined_rows" + sfx] = differ & fragile
    return out


def _cached(ref: dict, key, make):
    """``make()`` once per reference dict and key: what every sample of a
    check reads alike."""
    cache = ref.setdefault("_cache", {})
    if key not in cache:
        cache[key] = make()
    return cache[key]


def _pass_tables(ref: dict, gender: str, cutoff: float, dtype, device):
    """A pass's PCA, neighbour tables (global masked indexes of the target
    rows), usable-neighbour flags, weights, and the rows given as
    undetermined, on the device."""
    sfx = _suffix(gender)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    sizes_c, starts_c, chr_of_row, ct = _pass_layout(ref, gender)
    idx = np.asarray(ref["indexes" + sfx])[ct:].astype(np.int64)
    rows_chr = chr_of_row[ct:]
    gidx = idx + (idx >= starts_c[rows_chr][:, None]) * sizes_c[rows_chr][:, None]
    dist = np.asarray(ref["distances" + sfx])[ct:].astype(np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        weights = 1.0 / np.mean(np.sqrt(dist), axis=1)
    fixed = np.zeros(len(idx), dtype=bool)
    if "undetermined_rows" + sfx in ref:
        fixed = np.asarray(ref["undetermined_rows" + sfx])[ct:]
    return (t(ref["pca_components" + sfx]), t(ref["pca_mean" + sfx]), ct,
            torch.as_tensor(gidx, device=device),
            torch.as_tensor(dist < cutoff, device=device), weights,
            torch.as_tensor(fixed, dtype=torch.bool, device=device))


def _split(values, ref, gender):
    """Masked-space values (rows may carry a trailing axis) onto the full
    bin axis of the pass, zero elsewhere, split per chromosome."""
    sfx = _suffix(gender)
    mask = np.asarray(ref["mask" + sfx], dtype=bool)
    full = np.zeros((len(mask),) + values.shape[1:], dtype=values.dtype)
    full[mask] = values
    ends = np.cumsum(np.asarray(ref["bins_per_chr" + sfx], dtype=np.int64))
    return np.split(full, ends[:-1])


def sample_gender(counts: dict, ref: dict) -> tuple[str, str, dict]:
    """(sex call, gonosomal pass, counts gender-corrected as predict uses
    them)."""
    total = float(sum(np.sum(v) for v in counts.values()))
    gender = "M" if float(np.sum(counts["24"])) / total > float(ref["trained_cutoff"]) else "F"
    counts = dict(counts)
    if bool(ref["is_nipt"]):
        return gender, "F", counts
    if gender == "M":
        counts["23"] = counts["23"] * 2
        counts["24"] = counts["24"] * 2
    ref_gender = gender
    if gender == "M" and not bool(ref["has_male"]):
        ref_gender = "F"
    elif gender == "F" and not bool(ref["has_female"]):
        ref_gender = "M"
    return gender, ref_gender, counts


def reference_bins(counts: dict, ref: dict, maskrepeats: int = 5,
                   minrefbins: int = 150, dtype=torch.float64,
                   tf32: bool = False, device="cpu") -> dict:
    """Per-chromosome log2 ratios ``r``, z-scores ``z``, weights ``w``,
    null ratios ``nr`` and undetermined bins of one sample, and its sex
    call."""
    gender, ref_gender, counts = sample_gender(counts, ref)
    cutoff = _cached(ref, ("cutoff", maskrepeats),
                     lambda: optimal_cutoff(ref["distances"], maskrepeats))
    z_a, r_a, n_a, w_a, m_lr, m_z, u_a = normalize_pass(
        counts, ref, "A", cutoff, dtype, tf32, device)
    z_g, r_g, n_g, w_g, _, _, u_g = normalize_pass(
        counts, ref, ref_gender, cutoff, dtype, tf32, device)
    results_r = np.concatenate([r_a, r_g])
    results_z = np.concatenate([z_a, z_g]) - m_z
    with np.errstate(invalid="ignore", divide="ignore"):
        results_w = np.concatenate([w_a * np.nanmean(w_g), w_g * np.nanmean(w_a)])
        results_w = results_w / np.nanmean(results_w)
    if np.isnan(results_w).any() or np.isinf(results_w).any():
        results_w = np.ones(len(results_w))
    null_a = np.asarray(ref["null_ratios"], dtype=np.float64)
    null_g = np.asarray(ref["null_ratios" + _suffix(ref_gender)],
                        dtype=np.float64)[len(null_a):]
    if null_a.shape[1] != null_g.shape[1]:
        width = max(null_a.shape[1], null_g.shape[1])
        pad = lambda a: np.pad(a, ((0, 0), (0, width - a.shape[1])),
                               constant_values=np.nan)
        null_a, null_g = pad(null_a), pad(null_g)
    insufficient = np.concatenate([n_a, n_g]) < minrefbins

    def post(values):
        values = np.array(values)
        values[insufficient] = 0
        return _split(values, ref, ref_gender)

    undetermined = _split(np.concatenate([u_a, u_g]), ref, ref_gender)
    out_r, out_z, out_w = [], [], []
    for r, z, w, u in zip(post(results_r), post(results_z), post(results_w),
                          undetermined):
        with np.errstate(divide="ignore", invalid="ignore"):
            lr = np.log2(r)
        bad = ~np.isfinite(lr)
        lr[bad], z[bad], w[bad] = 0.0, 0.0, 0.0
        # WisecondorX recentres only the ratios that are not exactly 0: a
        # ratio within float32's rounding of 0 may or may not be.
        u |= np.abs(lr) <= ZERO_LR
        lr[lr != 0] -= m_lr
        out_r.append(lr)
        out_z.append(z)
        out_w.append(w)
    return {"gender": gender, "ref_gender": ref_gender, "r": out_r, "z": out_z,
            "w": out_w, "nr": post(np.concatenate([null_a, null_g])),
            "undetermined": undetermined,
            "binsize": int(np.atleast_1d(ref["binsize"])[0])}


def reference_segments(bins_r: list, expected: dict, alpha: float,
                       zscore: float, device="cpu", seed: int = 0) -> dict:
    """Segment rows and aberration rows, as ``<outid>_segments.bed`` and
    ``_aberrations.bed`` write them (without headers), of the per-bin
    ratios ``bins_r`` under the reference's weights and null ratios."""
    binsize = expected["binsize"]
    rows = cbs_ref.exec_cbs_batch(
        [(bins_r, expected["w"], expected["ref_gender"], binsize)],
        cbs_ref.CBSConfig(alpha=alpha, seed=seed), device=device)[0]
    seg_z = stats_ref.get_z_score(rows, bins_r, expected["w"], expected["nr"])
    segments, calls = [], []
    for (c, s, e, ratio), z in zip(rows, seg_z):
        row = [CHR_NAMES[c], int(s * binsize + 1), int(e * binsize), ratio, z]
        line = "\t".join(str(x) for x in row)
        segments.append(line)
        if isinstance(z, str):
            continue
        if float(z) > zscore:
            calls.append(line + "\tgain")
        elif float(z) < -zscore:
            calls.append(line + "\tloss")
    return {"segments": segments, "calls": calls}
