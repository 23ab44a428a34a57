"""Circular binary segmentation (CBS) with the arc statistic on a device.

Counterpart of wisecondorx_tpu/ops/cbs.py (see its docstring for the
algorithm and the CBS.R post-processing it mirrors).  The max-|T| scans
over arc lengths run as torch ops on the given device in float64; the
recursion, the significance decisions and the post-processing run on the
host.

Permutations come from the JAX package's host per-draw stream: draw ``d``
of a segment is ``np.random.default_rng([seed, salt, lo, hi, d])
.permutation(n)``, keyed by the segment's content salt, so the decisions
equal the JAX package's CPU run on every device.  A counter-based device
stream is later work.
"""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np
import torch


@dataclasses.dataclass
class CBSConfig:
    alpha: float = 1e-4
    nperm: int = 10000
    min_width: int = 2
    #: Permutation rows per round.
    perm_batch: int = 1024
    seed: int | None = 0
    #: All arc lengths <= kmax are tested exactly, wrap-around arcs too.
    kmax: int = 25
    #: Geometric spacing of the long-arc length grid.
    length_ratio: float = 1.08
    #: Segments up to this size use every arc length in the permutation
    #: test; larger ones use the thinned length family.
    exact_max: int = 2048
    #: Accept a split iff the observed max |T| >= this value, without a
    #: permutation test (deterministic mode).
    t_threshold: float | None = None
    #: Max segments decided together.
    seg_batch: int = 32


def _bucket(n: int) -> int:
    """Padded segment size: x4 steps up to 2048, x2 above."""
    p = 8
    while p < n:
        p *= 4 if p <= 512 else 2
    return p


def _arc_lengths(n_pad: int, cfg: CBSConfig) -> np.ndarray:
    """Thinned window-length family of a size bucket: every length in
    [min_width, kmax] plus a geometric grid up to ``n_pad``."""
    ls = set(range(cfg.min_width, cfg.kmax + 1))
    length = float(cfg.kmax)
    while length < n_pad:
        length = max(length * cfg.length_ratio, length + 1.0)
        ls.add(min(int(length), n_pad))
    return np.array(sorted(ls), dtype=np.int64)


def _group_lengths(n_pad: int, cfg: CBSConfig, mode: str) -> np.ndarray:
    if mode == "exact":
        return np.arange(n_pad, dtype=np.int64)
    return _arc_lengths(n_pad, cfg)


# ---------------------------------------------------------------------------
# Statistic kernels (torch, any device)
# ---------------------------------------------------------------------------


def _row_cumsums(w_rows, wx_rows):
    zero = torch.zeros((w_rows.shape[0], 1), dtype=w_rows.dtype,
                       device=w_rows.device)
    return (torch.cat([zero, torch.cumsum(w_rows, dim=1)], dim=1),
            torch.cat([zero, torch.cumsum(wx_rows, dim=1)], dim=1))


def _length_groups(n_lengths: int, rows: int, n_pad: int, device):
    """Arc lengths evaluated per step: bounds each [rows, G, n_pad + 1]
    temporary (2^25 elements on CUDA, 2^21 on the CPU)."""
    budget = 1 << (25 if torch.device(device).type == "cuda" else 21)
    g = max(1, budget // max(rows * (n_pad + 1), 1))
    return [(a, min(a + g, n_lengths)) for a in range(0, n_lengths, g)]


def _tstat_block(cw, cwx, n_col, lengths, min_width):
    """|T| of every window arc (i, i + L] for L in ``lengths`` [G]:
    a [B, G, n + 1] tensor, -inf where the arc is invalid."""
    n = cw.shape[1] - 1
    i_idx = torch.arange(n + 1, device=cw.device)
    end = (i_idx[None, :] + lengths[:, None]).clamp(max=n)  # [G, n + 1]
    w_tot = cw.gather(1, n_col)[:, :, None]  # [B, 1, 1]
    x_tot = cwx.gather(1, n_col)[:, :, None]
    w1 = cw[:, end] - cw[:, None, :]
    x1 = cwx[:, end] - cwx[:, None, :]
    w0 = w_tot - w1
    x0 = x_tot - x1
    t = (x1 / w1 - x0 / w0) * torch.rsqrt(1.0 / w1 + 1.0 / w0)
    n3 = n_col[:, :, None]
    L3 = lengths[None, :, None]
    valid = (
        (i_idx[None, None, :] + L3 <= n3)
        & (L3 >= min_width)
        & (L3 <= n3 - min_width)
    )
    return torch.where(valid, torch.abs(t), -torch.inf)


def _trimmed(w_rows, wx_rows, n_rows, lengths, min_width):
    """Cumulative sums cut to the longest true row, and the lengths that
    can be valid for some row.  Every arc dropped here is invalid for every
    row, so the maxima (and their first positions) are unchanged; the
    padded tail of a size bucket costs nothing."""
    n_eff = int(n_rows.max()) if n_rows.numel() else 0
    cw, cwx = _row_cumsums(w_rows[:, :n_eff], wx_rows[:, :n_eff])
    keep = (lengths >= min_width) & (lengths <= n_eff - min_width)
    return cw, cwx, lengths[keep]


def _wrap_max(cw, cwx, n_col, kmax: int, min_width: int):
    """Max |T| over wrap-around arcs (a suffix of length s plus a prefix of
    length p, s + p <= kmax), which equal the long "mirror" arcs by
    |T(arc)| == |T(complement)|."""
    b = cw.shape[0]
    kmax = min(kmax, cw.shape[1] - 1)
    s_idx = torch.arange(kmax + 1, device=cw.device)
    w_tot = cw.gather(1, n_col)
    x_tot = cwx.gather(1, n_col)
    pos = (n_col - s_idx[None, :]).clamp(0, cw.shape[1] - 1)
    sfx_w = w_tot - cw.gather(1, pos)
    sfx_x = x_tot - cwx.gather(1, pos)
    pre_w = cw[:, : kmax + 1]
    pre_x = cwx[:, : kmax + 1]
    w1 = sfx_w[:, :, None] + pre_w[:, None, :]
    x1 = sfx_x[:, :, None] + pre_x[:, None, :]
    w0 = w_tot[:, :, None] - w1
    x0 = x_tot[:, :, None] - x1
    t = (x1 / w1 - x0 / w0) * torch.rsqrt(1.0 / w1 + 1.0 / w0)
    s3 = s_idx[None, :, None]
    p3 = s_idx[None, None, :]
    k_len = s3 + p3
    n3 = n_col[:, :, None]
    valid = (
        (s3 >= 1) & (p3 >= 1) & (k_len <= kmax) & (k_len >= min_width)
        & (k_len <= n3 - min_width) & (s3 < n3)
    )
    t = torch.where(valid, torch.abs(t), -torch.inf)
    return t.reshape(b, -1).amax(dim=1)


def max_t_rows(w_rows, wx_rows, n_rows, lengths, min_width: int, kmax: int):
    """Max |T| per row over the window arcs of ``lengths`` plus the wrap
    arcs of circular length <= kmax.  ``w_rows``/``wx_rows`` [B, n_pad]
    (zero past each row's true size ``n_rows[b]``)."""
    cw, cwx, lengths = _trimmed(w_rows, wx_rows, n_rows, lengths, min_width)
    n_col = n_rows.reshape(-1, 1)
    best = torch.full((cw.shape[0],), -torch.inf, dtype=cw.dtype,
                      device=cw.device)
    for a, b in _length_groups(len(lengths), cw.shape[0], cw.shape[1] - 1,
                               cw.device):
        t = _tstat_block(cw, cwx, n_col, lengths[a:b], min_width)
        best = torch.maximum(best, t.amax(dim=2).amax(dim=1))
    if kmax > 0:
        best = torch.maximum(best, _wrap_max(cw, cwx, n_col, kmax, min_width))
    return best


def locate_rows(w_seg, wx_seg, n_seg, min_width: int):
    """Exact scan over every window length per segment: (i*, L*) [S] of
    the max |T|, ties to the shortest arc and then the smallest start."""
    lengths = torch.arange(w_seg.shape[1], device=w_seg.device)
    cw, cwx, lengths = _trimmed(w_seg, wx_seg, n_seg, lengths, min_width)
    n_pad = cw.shape[1] - 1
    n_col = n_seg.reshape(-1, 1)
    rows = cw.shape[0]
    best = torch.full((rows,), -torch.inf, dtype=cw.dtype, device=cw.device)
    best_i = torch.zeros(rows, dtype=torch.int64, device=cw.device)
    best_l = torch.zeros(rows, dtype=torch.int64, device=cw.device)
    big = n_pad + 1
    pos = torch.arange(n_pad + 1, device=cw.device)
    for a, b in _length_groups(len(lengths), rows, n_pad, cw.device):
        t = _tstat_block(cw, cwx, n_col, lengths[a:b], min_width)
        m = t.amax(dim=2)  # [S, G]
        first_i = torch.where(t == m[:, :, None], pos, big).amin(dim=2)
        m = torch.where(torch.isnan(m), -torch.inf, m)  # NaN never improves
        gm = m.amax(dim=1)
        first_g = torch.where(
            m == gm[:, None], torch.arange(b - a, device=cw.device), b - a
        ).amin(dim=1)
        better = gm > best  # strict: earlier (shorter) lengths win ties
        best = torch.where(better, gm, best)
        best_i = torch.where(better, first_i.gather(1, first_g[:, None])[:, 0],
                             best_i)
        best_l = torch.where(better, lengths[a:b][first_g], best_l)
    return best_i, best_l


# ---------------------------------------------------------------------------
# Host orchestration
# ---------------------------------------------------------------------------


class _Item:
    """One pending segment: job ``ji``, half-open value range [lo, hi)."""

    __slots__ = ("ji", "lo", "hi", "n", "exceed", "done", "max_ones",
                 "decision", "split")

    def __init__(self, ji, lo, hi):
        self.ji = ji
        self.lo = lo
        self.hi = hi
        self.n = hi - lo
        self.exceed = 0
        self.done = 0
        self.max_ones = 0
        self.decision = None  # True = split, False = final
        self.split = None  # (i, j) within [0, n)


def _alloc_rows(b, items, remaining):
    """Fair share of ``b`` permutation rows among undecided items, each
    capped at its remaining draw budget."""
    counts = [0] * len(items)
    left = b
    for pos in range(len(items)):
        give = min(remaining[pos], left // (len(items) - pos))
        counts[pos] = give
        left -= give
    for pos in range(len(items)):
        if not left:
            break
        extra = min(remaining[pos] - counts[pos], left)
        counts[pos] += extra
        left -= extra
    return counts


def _seg_tables(items, jobs, n_pad, device):
    """[S, n_pad] (w, w*x) tensors and true sizes of a chunk of items."""
    w_seg = np.zeros((len(items), n_pad))
    wx_seg = np.zeros((len(items), n_pad))
    n_seg = np.zeros(len(items), dtype=np.int64)
    for s, it in enumerate(items):
        x, w = jobs[it.ji]
        w_seg[s, : it.n] = w[it.lo : it.hi]
        wx_seg[s, : it.n] = w[it.lo : it.hi] * x[it.lo : it.hi]
        n_seg[s] = it.n
    return (torch.as_tensor(w_seg, device=device),
            torch.as_tensor(wx_seg, device=device),
            torch.as_tensor(n_seg, device=device))


def _job_salt(x: np.ndarray, w: np.ndarray) -> int:
    """Content-derived salt of a job's permutation streams (the same value
    as the JAX package's)."""
    return zlib.crc32(w.tobytes(), zlib.crc32(x.tobytes())) & 0x7FFFFFFF


def _chunks(seq, size):
    for a in range(0, len(seq), size):
        yield seq[a : a + size]


def _decide_group(items, jobs, salts, n_pad, mode, cfg, device):
    """Decide split significance for every item of one (bucket, mode)
    group; fills ``it.decision``."""
    lengths = torch.as_tensor(_group_lengths(n_pad, cfg, mode), device=device)
    observed = {}
    for chunk in _chunks(items, cfg.seg_batch):
        w_seg, wx_seg, n_seg = _seg_tables(chunk, jobs, n_pad, device)
        obs = max_t_rows(w_seg, wx_seg, n_seg, lengths, cfg.min_width,
                         cfg.kmax).cpu().numpy()
        for s, it in enumerate(chunk):
            o = float(obs[s])
            if not np.isfinite(o) or o <= 0:
                it.decision = False
            elif cfg.t_threshold is not None:
                it.decision = bool(o >= cfg.t_threshold)
            else:
                observed[id(it)] = o
    if cfg.t_threshold is not None:
        return
    undecided = [it for it in items if it.decision is None]
    for it in undecided:
        it.max_ones = int(np.floor(cfg.nperm * cfg.alpha)) + 1
    for chunk in _chunks(undecided, cfg.seg_batch):
        _perm_loop(chunk, jobs, salts, n_pad, lengths, cfg, observed, device)


def _perm_loop(chunk, jobs, salts, n_pad, lengths, cfg, observed, device):
    """Early-terminating permutation rounds: host per-draw permutation
    streams, max |T| of the permuted rows on the device."""
    b = max(64, int(cfg.perm_batch))
    seedval = 0 if cfg.seed is None else int(cfg.seed)

    def live(it):
        return it.decision is None and it.done < cfg.nperm

    while any(live(it) for it in chunk):
        active = [s for s, it in enumerate(chunk) if live(it)]
        counts = _alloc_rows(b, active, [cfg.nperm - chunk[s].done for s in active])
        w_rows = np.zeros((b, n_pad))
        wx_rows = np.zeros((b, n_pad))
        n_rows = np.zeros(b, dtype=np.int64)
        row_seg = np.full(b, -1, dtype=np.int64)
        r = 0
        for pos, s in enumerate(active):
            it = chunk[s]
            k = counts[pos]
            if not k:
                continue
            x, w = jobs[it.ji]
            ww = w[it.lo : it.hi]
            wx = ww * x[it.lo : it.hi]
            order = np.stack([
                np.random.default_rng(
                    [seedval, salts[it.ji], it.lo, it.hi, it.done + j]
                ).permutation(it.n)
                for j in range(k)
            ])
            w_rows[r : r + k, : it.n] = ww[order]
            wx_rows[r : r + k, : it.n] = wx[order]
            n_rows[r : r + k] = it.n
            row_seg[r : r + k] = s
            r += k
        best = max_t_rows(
            torch.as_tensor(w_rows, device=device),
            torch.as_tensor(wx_rows, device=device),
            torch.as_tensor(n_rows, device=device),
            lengths, cfg.min_width, cfg.kmax,
        ).cpu().numpy()
        for pos, s in enumerate(active):
            it = chunk[s]
            it.exceed += int(np.sum(best[row_seg == s] >= observed[id(it)]))
            it.done += counts[pos]
            if it.exceed >= it.max_ones:
                it.decision = False  # p > alpha proven: stop early
            elif it.done >= cfg.nperm:
                it.decision = True
    for it in chunk:
        if it.decision is None:
            it.decision = it.exceed < it.max_ones


def _segment_jobs(jobs: list, cfg: CBSConfig, device) -> list:
    """Level-synchronous recursive CBS over many (x, w) float64 value
    vectors; returns per-job sorted lists of (lo, hi) segment ranges."""
    salts = [_job_salt(x, w) for x, w in jobs]
    results = [[] for _ in jobs]
    pending = [_Item(ji, 0, len(x)) for ji, (x, w) in enumerate(jobs) if len(x)]
    while pending:
        testable = []
        for it in pending:
            if it.n < 2 * cfg.min_width:
                results[it.ji].append((it.lo, it.hi))
            else:
                testable.append(it)
        if not testable:
            break
        groups: dict = {}
        for it in testable:
            mode = "exact" if it.n <= cfg.exact_max else "thin"
            groups.setdefault((_bucket(it.n), mode), []).append(it)
        for (n_pad, mode), items in sorted(groups.items(), reverse=True):
            _decide_group(items, jobs, salts, n_pad, mode, cfg, device)

        # Locate accepted splits with the exact scan, batched per bucket.
        by_pad: dict = {}
        for it in testable:
            if it.decision:
                by_pad.setdefault(_bucket(it.n), []).append(it)
        for n_pad, items in sorted(by_pad.items(), reverse=True):
            for chunk in _chunks(items, cfg.seg_batch):
                i_star, l_star = locate_rows(
                    *_seg_tables(chunk, jobs, n_pad, device), cfg.min_width
                )
                i_star, l_star = i_star.cpu().numpy(), l_star.cpu().numpy()
                for s, it in enumerate(chunk):
                    it.split = (int(i_star[s]), int(i_star[s] + l_star[s]))
                    if it.split[1] <= it.split[0]:  # no valid arc found
                        it.decision = False

        nxt = []
        for it in testable:
            if not it.decision:
                results[it.ji].append((it.lo, it.hi))
                continue
            i, j = it.split
            for a, b in ((it.lo, it.lo + i), (it.lo + i, it.lo + j),
                         (it.lo + j, it.hi)):
                if b > a:
                    nxt.append(_Item(it.ji, a, b))
        pending = nxt
    return [sorted(r) for r in results]


def _prepare_chromosome(results_r, results_w, c):
    """CBS.R prep: zero ratios -> NA, zero weights -> 1.0, drop all-NA."""
    y = np.asarray(results_r[c], dtype=np.float64).copy()
    w = np.asarray(results_w[c], dtype=np.float64).copy()
    y[y == 0] = np.nan
    w[w == 0] = 1.0  # CBS.R's 1^-99 == 1.0
    keep = ~np.isnan(y)
    if not keep.any():
        return None
    pos = np.nonzero(keep)[0]
    return y, w, pos, y[keep], w[keep]


def exec_cbs(results_r: list, results_w: list, ref_gender: str,
             binsize: int, cfg: CBSConfig = CBSConfig(),
             device: torch.device = torch.device("cpu")) -> list:
    """Segment the per-chromosome log2 ratios.  Returns rows
    ``[chr0, start, end, ratio]`` with 0-based half-open bin ranges and
    4-decimal ratios."""
    jobs, meta = [], []
    for c in range(24 if ref_gender == "M" else 23):
        prep = _prepare_chromosome(results_r, results_w, c)
        if prep is None:
            continue
        y, w, pos, yv, wv = prep
        jobs.append((yv, wv))
        meta.append((c, y, w, pos))
    out = []
    na_run_threshold = int(2e6 / binsize)
    for (c, y, w, pos), segments in zip(meta, _segment_jobs(jobs, cfg, device)):
        for lo, hi in segments:
            s1 = int(pos[lo]) + 1
            e1 = int(pos[hi - 1]) + 1
            out.extend(_postprocess_segment(c, s1, e1, y, w, na_run_threshold))
    return out


def _postprocess_segment(c, s1, e1, y, w, thresh):
    """NA-run splitting and weighted-mean recompute of CBS.R; ``s1``/``e1``
    are 1-based inclusive positions on the full chromosome."""
    seg = y[s1 - 1 : e1]
    diff = np.diff(np.isnan(seg).astype(np.int64))
    start_pos = np.nonzero(diff == 1)[0] + s1  # last non-NA before each run
    end_pos = np.nonzero(diff == -1)[0] + s1  # last NA of each run
    sel = (end_pos - start_pos) > thresh
    inv_start = np.concatenate([[s1], end_pos[sel]])
    inv_end = np.concatenate([start_pos[sel], [e1]])
    sel2 = (inv_end - inv_start) > 0  # pieces of >= 2 bins
    rows = []
    for s, e in zip(inv_start[sel2], inv_end[sel2]):
        yy = y[s - 1 : e]
        ww = w[s - 1 : e]
        ok = ~np.isnan(yy)
        r = (float(np.sum(yy[ok] * ww[ok]) / np.sum(ww[ok]))
             if ok.any() else float("nan"))
        rows.append([c, int(s) - 1, int(e), round(r, 4)])
    return rows
