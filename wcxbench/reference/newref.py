"""The plain reference of ``newref``: the reference ``.npz`` rebuilt from
the controls' counts alone.

Written from WisecondorX's published newref semantics (newref_tools.py,
newref_control.py) as plain torch and numpy, imports nothing of the
program, and takes nothing the program made:

* sexes: the chrY-fraction mixture's cutoff (``reference/gmm.py``, seed
  0) and each control's call under it; males' gonosomes doubled unless
  NIPT;
* masks: per-sample depth normalization, bins above 5 % of the median
  non-zero summed coverage (the whole cohort and each sex), then each
  pass's PCA (5 components) and the bins whose squared distance to the
  median profile passes max(median + 10 MAD, 5) dropped from the shared
  mask, pass after pass;
* each pass's PCA components and mean, refitted on its final mask;
* each pass's neighbours: the exact ``refsize`` nearest other-chromosome
  bins by squared Euclidean distance of the PCA-corrected profiles,
  stored in own-chromosome-excluded index space;
* null ratios: log2 of each chosen control's corrected value over the
  median at the pass's neighbours (indexes in own-chromosome-excluded
  space applied to the masked vector, -1 wrapping, as WisecondorX does),
  the controls drawn as the configuration's seed 0 draws them;
* the optimal-cutoff schedule of the autosomal distances.

:func:`rebuild` gives these in the layout of a reference ``.npz``;
``dtype`` float32 with ``tf32`` rounds every PCA and distance product's
inputs to TF32: the control put in the program's place.  A bin whose PCA
filter decision lies within ``UNDETERMINED`` of its cutoff is not
determined at float32 precision; ``follow`` (a program's masks) then
takes that one decision as the program took it.
:func:`check_reference` holds a program's reference to a rebuild.
"""

from __future__ import annotations

import numpy as np
import torch

from wcxbench.reference import gmm
from wcxbench.reference.predict import (TIE, cutoff_schedule, neighbour_sets_differ,
                                        optimal_cutoff, round_tf32)

LAST_CHR = {"A": 22, "F": 23, "M": 24}
N_COMPONENTS = 5
NULL_SAMPLES = 100
#: Relative distance from the PCA filter's cutoff within which a bin's
#: filter decision is not determined at float32 precision.
UNDETERMINED = 1e-4


def _mm(a, b, tf32: bool):
    return round_tf32(a) @ round_tf32(b) if tf32 else a @ b


def _suffix(gender: str) -> str:
    return "" if gender == "A" else f".{gender}"


def sex_model(counts: list) -> tuple[list, float]:
    """Each control's sex call ("M", "F", or None on the cutoff) and the
    cutoff."""
    calls, cutoff, _ = gmm.train_gender_model(counts, random_state=0)
    return calls, float(cutoff)


def cohort_matrix(counts: list, sexes: list, nipt: bool):
    """[bins, samples] float64 counts, males' gonosomes doubled unless
    NIPT, and the bins of each chromosome."""
    counts = [dict(c) for c in counts]
    if not nipt:
        for c, sex in zip(counts, sexes):
            if sex == "M":
                c["23"] = c["23"] * 2
                c["24"] = c["24"] * 2
    bins = np.array([max(len(c[str(k)]) for c in counts) for k in range(1, 25)])
    starts = np.concatenate([[0], np.cumsum(bins)[:-1]])
    mat = np.zeros((int(bins.sum()), len(counts)))
    for j, c in enumerate(counts):
        for k in range(24):
            arr = np.asarray(c[str(k + 1)])
            mat[starts[k]: starts[k] + len(arr), j] = arr
    return mat, bins


def _threshold(matrix: np.ndarray) -> np.ndarray:
    per_bin = (matrix / matrix.sum(axis=0)).sum(axis=1)
    return per_bin > 0.05 * np.median(per_bin[per_bin > 0])


def _pca_correct(x: torch.Tensor, tf32: bool):
    """[bins, samples] -> (the samples divided by their rank-5
    reconstruction [bins, samples], components [5, bins], mean [bins])."""
    xs = x.T
    mean = xs.mean(dim=0)
    xc = xs - mean
    gram = _mm(xc, xc.T, tf32).double().cpu().numpy()
    _, vecs = np.linalg.eigh(gram)
    u = torch.as_tensor(np.ascontiguousarray(vecs[:, ::-1][:, :N_COMPONENTS]),
                        dtype=x.dtype, device=x.device)
    coeffs = _mm(u.T, xc, tf32)
    norms = torch.linalg.vector_norm(coeffs, dim=1, keepdim=True)
    components = coeffs / torch.where(norms > 0, norms, 1.0)
    recon = _mm(u, coeffs, tf32) + mean
    return (xs / recon).T.contiguous(), components, mean


def _median0(x):
    s = x.sort(dim=1).values
    n = x.shape[1]
    return (s[:, (n - 1) // 2] + s[:, n // 2]) * 0.5


def pass_corrected(matrix, bins, cols, mask, gender, dtype, tf32, device):
    """The pass's PCA-corrected masked profiles, components and mean."""
    n_bins = int(bins[: LAST_CHR[gender]].sum())
    sub = torch.as_tensor(matrix[:n_bins][:, cols], dtype=dtype, device=device)
    keep = torch.as_tensor(np.nonzero(mask[:n_bins])[0], device=device)
    return _pca_correct(sub[keep] / sub.sum(dim=0), tf32)


def reference_masks(matrix, bins, sexes, nipt, dtype=torch.float64,
                    tf32=False, device="cpu", follow=None):
    """{pass: mask over the pass's bins} as newref's mask stage and PCA
    filter leave them, the passes' sample columns, and the bins whose
    filter decision float32 arithmetic could take either way (their
    squared distance within UNDETERMINED of the cutoff, relative); those
    take ``follow``'s decision where it is given."""
    sexes = np.array(sexes, dtype=object)
    plan = [("A", np.ones(len(sexes), dtype=bool))]
    subsets = [matrix]
    if (sexes == "F").sum() > 4:
        plan.append(("F", sexes == "F"))
        subsets.append(matrix[:, sexes == "F"])
    if (sexes == "M").sum() > 4 and not nipt:
        plan.append(("M", sexes == "M"))
        subsets.append(matrix[:, sexes == "M"])
    total = np.logical_and.reduce([_threshold(m) for m in subsets])
    undetermined = np.zeros(len(total), dtype=bool)
    out = {}
    for gender, cols in plan:
        n_bins = int(bins[: LAST_CHR[gender]].sum())
        pass_mask = total[:n_bins]  # a view: the filter narrows later passes
        corrected, _, _ = pass_corrected(matrix, bins, cols, total, gender,
                                         dtype, tf32, device)
        d = ((corrected - _median0(corrected)[:, None]) ** 2).sum(dim=1)
        d = d.double().cpu().numpy()
        mad = np.median(np.abs(d - np.median(d)))
        cutoff = max(np.median(d) + 10 * mad, 5.0)
        rows = np.nonzero(pass_mask)[0]
        drop = d > cutoff
        near = np.abs(d - cutoff) <= UNDETERMINED * cutoff
        undetermined[rows[near]] = True
        theirs = None if follow is None else follow.get("mask" + _suffix(gender))
        if theirs is not None and len(theirs) == n_bins:
            drop[near] = ~np.asarray(theirs, dtype=bool)[rows[near]]
        pass_mask[rows[drop]] = False
        out[gender] = pass_mask.copy()
    return out, dict(plan), undetermined


def _layout(mask, bins, gender):
    chr_of_bin = np.repeat(np.arange(LAST_CHR[gender]), bins[: LAST_CHR[gender]])
    chr_of_row = chr_of_bin[mask]
    sizes = np.bincount(chr_of_row, minlength=LAST_CHR[gender])
    starts = np.cumsum(sizes) - sizes
    return chr_of_row, starts, sizes


def exact_neighbours(data: torch.Tensor, chr_of_row, k: int, r0: int,
                     tf32: bool, block: int = 2048):
    """Rows r0.. against every other-chromosome row: the k nearest by
    squared Euclidean distance, as (global masked indexes, distances),
    both [rows - r0, k] on the data's device, and the rows whose k-th and
    (k+1)-th distances lie within TIE of each other (relative): their
    neighbour set is not determined at float32 precision."""
    dev = data.device
    chr_t = torch.as_tensor(chr_of_row, device=dev)
    norms = (data * data).sum(dim=1)
    kk = min(k + 1, data.shape[0])
    idx_out, val_out, tie_out = [], [], []
    for a in range(r0, data.shape[0], block):
        b = min(a + block, data.shape[0])
        d = norms[a:b, None] + norms[None, :] - 2.0 * _mm(data[a:b], data.T, tf32)
        d = torch.where(chr_t[a:b, None] == chr_t[None, :], torch.inf, d)
        vals, idx = torch.topk(d, kk, dim=1, largest=False, sorted=True)
        if kk > k:
            tie_out.append(vals[:, k] - vals[:, k - 1] <= TIE * vals[:, k - 1].abs())
        else:
            tie_out.append(torch.zeros(b - a, dtype=torch.bool, device=dev))
        idx_out.append(idx[:, :k])
        val_out.append(vals[:, :k])
    return torch.cat(idx_out), torch.cat(val_out), torch.cat(tie_out)


def to_excluded(idx, chr_of_row, starts, sizes, r0):
    """Global masked indexes of rows r0.. in own-chromosome-excluded
    space."""
    rows = chr_of_row[r0: r0 + len(idx)]
    return idx - (idx >= starts[rows][:, None]) * sizes[rows][:, None]


def to_global(idx, chr_of_row, starts, sizes, r0):
    rows = chr_of_row[r0: r0 + len(idx)]
    return idx + (idx >= starts[rows][:, None]) * sizes[rows][:, None]


def null_ratios(data: torch.Tensor, stored_idx: np.ndarray, chosen, r0: int):
    """log2(data[b, s] / median(data[idx[b] % n, s])) for the chosen
    columns, the first ``r0`` rows' indexes taken as 0 (the gonosomal
    passes' autosome placeholders)."""
    n = data.shape[0]
    sub = data[:, torch.as_tensor(np.asarray(chosen), device=data.device)]
    idx = torch.as_tensor(np.asarray(stored_idx, np.int64), device=data.device)
    idx[:r0] = 0
    out = []
    for a in range(0, n, 1024):
        g = sub[idx[a: a + 1024] % n]  # [rows, k, chosen]
        s = g.sort(dim=1).values
        k = g.shape[1]
        med = (s[:, (k - 1) // 2] + s[:, k // 2]) * 0.5
        out.append(torch.log2(sub[a: a + 1024] / med))
    return torch.cat(out)


def rebuild(counts: list, cfg: dict, dtype=torch.float64, tf32: bool = False,
            device="cpu", seed: int = 0, follow: dict | None = None) -> dict:
    """The reference rebuilt from the controls' counts: {"arrays": the
    ``.npz`` members predict reads, "passes": each pass's corrected
    profiles and layout, "undetermined": bins whose PCA filter decision
    is not determined at float32 precision, "sexes": the calls}."""
    sexes, cutoff = sex_model(counts)
    nipt = bool(cfg["nipt"]) and sexes.count("F") >= 5
    matrix, bins = cohort_matrix(counts, sexes, nipt)
    masks, plan, undetermined = reference_masks(matrix, bins, sexes, nipt,
                                                dtype, tf32, device, follow)
    k = int(cfg["refsize"])
    arrays = {"binsize": int(cfg["binsize"]), "is_nipt": nipt,
              "trained_cutoff": cutoff, "has_female": "F" in plan,
              "has_male": "M" in plan}
    passes = {}
    for gender, cols in plan.items():
        sfx = _suffix(gender)
        mask = masks[gender]
        data, comps, mean = pass_corrected(matrix, bins, cols, mask, gender,
                                           dtype, tf32, device)
        chr_of_row, starts, sizes = _layout(mask, bins, gender)
        r0 = 0 if gender == "A" else int(starts[22])
        idx, vals, tie = exact_neighbours(data, chr_of_row, k, r0, tf32)
        glob = idx.cpu().numpy()
        ties = np.zeros(data.shape[0], dtype=bool)
        ties[r0:] = tie.cpu().numpy()
        indexes = np.zeros((data.shape[0], k), dtype=np.int64)
        distances = np.ones((data.shape[0], k), dtype=np.float64)
        indexes[r0:] = to_excluded(glob, chr_of_row, starts, sizes, r0)
        distances[r0:] = vals.double().cpu().numpy()
        rng = np.random.default_rng([seed, ord(gender)])
        chosen = rng.choice(data.shape[1], size=min(data.shape[1], NULL_SAMPLES),
                            replace=False)
        arrays.update({
            "mask" + sfx: mask,
            "bins_per_chr" + sfx: np.asarray(bins[: LAST_CHR[gender]]),
            "masked_bins_per_chr" + sfx: sizes,
            "pca_components" + sfx: comps.double().cpu().numpy(),
            "pca_mean" + sfx: mean.double().cpu().numpy(),
            "indexes" + sfx: indexes,
            "distances" + sfx: distances,
            "null_ratios" + sfx: null_ratios(data, indexes, chosen, r0)
            .double().cpu().numpy(),
            "ties" + sfx: ties,
        })
        if gender == "A":
            arrays["wcx_cutoffs"] = np.array(cutoff_schedule(distances, 10))
        passes[gender] = {"data": data, "chr_of_row": chr_of_row,
                          "starts": starts, "sizes": sizes, "r0": r0,
                          "neighbours": glob}
    return {"arrays": arrays, "passes": passes, "undetermined": undetermined,
            "sexes": sexes}


def _call(y: float, cutoff: float):
    return "M" if y > cutoff else ("F" if y < cutoff else None)


def _pair_gap(data, rows, got_glob, got_dist, scale, block: int = 512):
    """Largest gap between a stored distance and the exact distance of
    the same pair, on the scale of the row's k-th exact distance."""
    gap = 0.0
    dev = data.device
    for a in range(0, len(rows), block):
        r = torch.as_tensor(rows[a: a + block], device=dev)
        g = torch.as_tensor(got_glob[a: a + block], device=dev).clamp(min=0)
        exact = ((data[r][:, None, :] - data[g]) ** 2).sum(dim=2)
        stored = torch.as_tensor(got_dist[a: a + block], dtype=exact.dtype, device=dev)
        s = torch.as_tensor(scale[a: a + block], dtype=exact.dtype, device=dev)
        gap = max(gap, float(((stored - exact).abs() / s.clamp(min=1e-30)[:, None]).max()))
    return gap


def check_reference(ref: dict, built: dict, counts: list) -> dict:
    """The comparison numbers of a program's reference arrays ``ref`` (a
    loaded ``.npz``) against a float64 rebuild ``built`` of the same
    controls."""
    want = built["arrays"]
    inf = float("inf")
    y = [gmm.y_fraction(c) for c in counts]
    got_cut, own_cut = float(ref["trained_cutoff"]), want["trained_cutoff"]
    out = {"sex_calls_differ": int(sum(_call(v, got_cut) != _call(v, own_cut)
                                       for v in y)),
           "mask_bins_differ": 0, "knn_dist_gap": 0.0, "null_gap": 0.0}
    missing = []
    for gender, p in built["passes"].items():
        sfx = _suffix(gender)
        own_mask = want["mask" + sfx]
        if "mask" + sfx not in ref or len(ref["mask" + sfx]) != len(own_mask):
            out["mask_bins_differ"] += int(own_mask.sum())
            missing.append(np.ones(1))
            out["knn_dist_gap"] = out["null_gap"] = inf
            continue
        got_mask = np.asarray(ref["mask" + sfx], dtype=bool)
        differ = got_mask != own_mask
        out["mask_bins_differ"] += int(
            (differ & ~built["undetermined"][: len(got_mask)]).sum())
        if differ.any():  # other layouts: the tables do not line up
            missing.append(np.ones(1))
            out["knn_dist_gap"] = out["null_gap"] = inf
            continue
        r0 = p["r0"]
        got_idx = np.asarray(ref["indexes" + sfx])[r0:].astype(np.int64)
        own_idx = want["indexes" + sfx][r0:]
        sets_differ = neighbour_sets_differ(got_idx, own_idx, p["data"].device)
        hit = [np.isin(g, w) for g, w in zip(got_idx[sets_differ], own_idx[sets_differ])]
        miss = np.zeros(len(got_idx))
        miss[sets_differ] = [1.0 - h.mean() for h in hit]
        missing.append(miss)
        got_glob = to_global(got_idx, p["chr_of_row"], p["starts"], p["sizes"], r0)
        rows = np.arange(r0, p["data"].shape[0])
        out["knn_dist_gap"] = max(out["knn_dist_gap"], _pair_gap(
            p["data"], rows, got_glob, np.asarray(ref["distances" + sfx])[r0:],
            want["distances" + sfx][r0:, -1]))
        # Null ratios from the rebuild's own neighbours, on the rows whose
        # neighbour sets agree (the others are knn_missing_share's).
        got_null = np.asarray(ref["null_ratios" + sfx], dtype=np.float64)
        want_null = want["null_ratios" + sfx]
        if got_null.shape != want_null.shape:
            out["null_gap"] = inf
            continue
        same = np.ones(len(want_null), dtype=bool)
        same[r0:] = ~sets_differ
        g, w = got_null[same], want_null[same]
        both = np.isfinite(g) & np.isfinite(w)
        if (np.isfinite(g) != np.isfinite(w)).any():
            out["null_gap"] = inf
        elif both.any():
            out["null_gap"] = max(out["null_gap"], float(np.abs(g - w)[both].max()))
    if "wcx_cutoffs" in ref:
        got = float(np.atleast_1d(ref["wcx_cutoffs"])[4])
    else:
        got = optimal_cutoff(ref["distances"], 5)
    want_cut = float(want["wcx_cutoffs"][4])
    out["cutoff_gap"] = abs(got - want_cut) / want_cut
    out["knn_missing_share"] = float(np.concatenate(missing).mean()) if missing else 1.0
    return out


def control_arrays(counts: list, cfg: dict, device="cpu") -> dict:
    """The reference's arrays computed in float32 with TF32 products: the
    control put in the program's place."""
    return rebuild(counts, cfg, torch.float32, True, device)["arrays"]
