"""Circular binary segmentation: the plain reference.

A frozen copy of the plain PyTorch path of the port's CBS
(``wisecondorx_tpu_torch/ops/cbs.py`` as of the benchmark's first
version): the arc statistic written out as torch ops (no kernel), the
permutation test with the same two streams, the level-synchronous
recursion and CBS.R's post-processing.  Only the configuration the
benchmark runs is kept (``p_method="perm"``, no fixed threshold).  It is a
copy and not an import, so that a later change to the program cannot move
the yardstick: the benchmark feeds it the program's per-bin ratios and
holds the program's segments to its own.

The permutation stream follows the device, as in the program: Threefry
sort keys (bit-equal to ``jax.random``) on CUDA, numpy's per-draw
generator on the CPU.
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
    #: Permutation rows per round, in either stream.  The early stop acts
    #: between rounds; the decisions do not depend on the round size (draws
    #: are keyed by index), only the time does.
    perm_batch: int = 1024
    seed: int | None = 0
    #: All arc lengths <= kmax are tested exactly, wrap-around arcs too.
    kmax: int = 25
    #: Geometric spacing of the long-arc length grid.
    length_ratio: float = 1.08
    #: Segments up to this size use every arc length in the permutation
    #: test; larger ones use the thinned length family.
    exact_max: int = 2048
    #: Max segments decided together.
    seg_batch: int = 32


def _bucket(n: int) -> int:
    """Padded segment size: x4 steps up to 2048, x2 above."""
    p = 8
    while p < n:
        p *= 4 if p <= 512 else 2
    return p


def _arc_lengths(n_pad: int, cfg: CBSConfig):
    """Window-length family of a size bucket: every length in
    [min_width, kmax] plus a geometric grid up to ``n_pad``."""
    ls = set(range(cfg.min_width, cfg.kmax + 1))
    length = float(cfg.kmax)
    while length < n_pad:
        length = max(length * cfg.length_ratio, length + 1.0)
        ls.add(min(int(length), n_pad))
    return np.array(sorted(ls), dtype=np.int64)


def _lengths_tensor(n_pad: int, cfg: CBSConfig, mode: str, device):
    """Lengths of a (bucket, mode) group as an int32 tensor: "exact" every
    length, "thin" the thinned family."""
    lengths = (np.arange(n_pad, dtype=np.int64) if mode == "exact"
               else _arc_lengths(n_pad, cfg))
    return torch.as_tensor(lengths.astype(np.int32), device=device)


# ---------------------------------------------------------------------------
# Threefry-2x32 counter stream (jax.random's, on int64 tensors)
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds.  Key words and counters are int64
    tensors (or ints) holding uint32 values, broadcast together; returns
    the two output words, each in [0, 2^32).

    ``x0`` only feeds additions and XORs, whose low 32 bits depend only on
    the operands' low 32 bits, so it is masked once at the end; ``x1`` is
    masked before every rotation."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = x0 + k0
    x1 = (x1 + k1) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = (((x1 << r) | (x1 >> (32 - r))) ^ x0) & _M32
        x0 = x0 + ks[(i + 1) % 3]
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0 & _M32, x1


def prng_key(seed: int):
    """``jax.random.PRNGKey(seed)`` as two uint32 words (x64 semantics: a
    seed >= 2^32 or < 0 splits as (seed >> 32, seed & 0xFFFFFFFF))."""
    seed = int(seed)
    return (seed >> 32) & _M32, seed & _M32


def fold_in(key, data: torch.Tensor):
    """``jax.random.fold_in`` for a batch of int64 ``data`` words (taken
    mod 2^32): one key per entry."""
    data = data & _M32
    return threefry2x32(key[0], key[1], torch.zeros_like(data), data)


def random_bits(key, n: int):
    """``jax.random.bits(key, (n,), uint32)`` for a batch of keys
    ([B] words): [B, n] int64, entry i = x0 ^ x1 of threefry(key, (0, i))."""
    k0, k1 = key
    device = k1.device if torch.is_tensor(k1) else torch.device("cpu")
    idx = torch.arange(n, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(_col(k0), _col(k1), torch.zeros_like(idx), idx)
    return y0 ^ y1


def _col(k):
    return k[:, None] if torch.is_tensor(k) else k


def perm_keys_reference(base_key, row_salt, row_lo, row_hi, row_draw,
                        n_rows, n_pad: int):
    """Plain PyTorch version of :func:`perm_keys` (any device)."""
    k = base_key
    for word in (row_salt, row_lo, row_hi, row_draw):
        k = fold_in(k, word)
    bits = random_bits(k, n_pad) & 0x7FFFFFFF
    idx = torch.arange(n_pad, dtype=torch.int64, device=bits.device)
    return torch.where(idx < n_rows[:, None], bits, 0x80000000 | idx)


def shuffle_rows(keys, w_rows, wx_rows):
    """Sort each row by its keys, carrying the (w, w*x) payloads: a joint
    uniform shuffle of each row's pairs.  The sort is stable; the JAX
    package's is not, so rows where two real slots draw the same key
    (probability ~ n^2 / 2^32 per row) may order differently."""
    order = torch.sort(keys, dim=1, stable=True).indices
    return w_rows.gather(1, order), wx_rows.gather(1, order)


# ---------------------------------------------------------------------------
# The arc statistic, written out
# ---------------------------------------------------------------------------


def _row_cumsums(w_rows, wx_rows):
    """Zero-prefixed cumulative sums [B, n_pad + 1] of whole rows (the same
    torch sums the program's kernels start from)."""
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


def _trimmed(cw, cwx, n_rows, lengths, min_width):
    """Cumulative sums cut to the longest true row, and the lengths that
    can be valid for some row.  Every arc dropped here is invalid for every
    row, so the maxima (and their first positions) are unchanged; the
    padded tail of a size bucket costs nothing.  Reads the longest row
    back to the host."""
    n_eff = int(n_rows.max()) if n_rows.numel() else 0
    keep = (lengths >= min_width) & (lengths <= n_eff - min_width)
    return cw[:, : n_eff + 1], cwx[:, : n_eff + 1], lengths[keep]


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


def max_t_rows_reference(w_rows, wx_rows, n_rows, lengths, min_width: int,
                         kmax: int):
    """Plain PyTorch version of :func:`max_t_rows` (any device): [B, G,
    n + 1] blocks of |T| written out and reduced."""
    cw, cwx = _row_cumsums(w_rows, wx_rows)
    cw, cwx, lengths = _trimmed(cw, cwx, n_rows, lengths, min_width)
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


def locate_rows_reference(w_seg, wx_seg, n_seg, min_width: int):
    """Plain PyTorch version of :func:`locate_rows` (any device)."""
    lengths = torch.arange(w_seg.shape[1], device=w_seg.device)
    cw, cwx = _row_cumsums(w_seg, wx_seg)
    cw, cwx, lengths = _trimmed(cw, cwx, n_seg, lengths, min_width)
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


def perm_round(base_key, w_seg, wx_seg, n_seg, seg_of_row, row_salt, row_lo,
               row_hi, row_draw, lengths, min_width: int, kmax: int):
    """One device-stream permutation round for a chunk of S segments: the
    S unshuffled segments are scored with the permuted rows, so the
    observed statistic comes out of the same round.  Returns (exceed
    counts [S] int64, observed max |T| [S])."""
    s = w_seg.shape[0]
    n_rows = n_seg[seg_of_row]
    keys = perm_keys_reference(base_key, row_salt, row_lo, row_hi, row_draw,
                               n_rows, w_seg.shape[1])
    w_p, wx_p = shuffle_rows(keys, w_seg[seg_of_row], wx_seg[seg_of_row])
    best = max_t_rows_reference(torch.cat([w_seg, w_p]),
                                torch.cat([wx_seg, wx_p]),
                                torch.cat([n_seg, n_rows]), lengths,
                                min_width, kmax)
    obs = best[:s]
    ex = best[s:] >= obs[seg_of_row]
    counts = torch.zeros(s, dtype=torch.int64, device=w_seg.device)
    counts.index_add_(0, seg_of_row, ex.to(torch.int64))
    return counts, obs


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


def _live(it, cfg):
    return it.decision is None and it.done < cfg.nperm


def _settle(it, cfg):
    """Early stop once p > alpha is proven; accept after the full budget."""
    if it.exceed >= it.max_ones:
        it.decision = False
    elif it.done >= cfg.nperm:
        it.decision = True


def _decide_group(items, jobs, salts, n_pad, mode, cfg, device,
                  device_stream):
    """Decide split significance for every item of one (bucket, mode)
    group; fills ``it.decision``.  The host stream needs the observed
    statistic first; the device stream takes it from the round itself."""
    lengths = _lengths_tensor(n_pad, cfg, mode, device)
    observed = {}
    if not device_stream:
        for chunk in _chunks(items, cfg.seg_batch):
            w_seg, wx_seg, n_seg = _seg_tables(chunk, jobs, n_pad, device)
            obs = max_t_rows_reference(w_seg, wx_seg, n_seg, lengths,
                                       cfg.min_width, cfg.kmax).cpu().numpy()
            for s, it in enumerate(chunk):
                o = float(obs[s])
                if not np.isfinite(o) or o <= 0:
                    it.decision = False
                else:
                    observed[id(it)] = o
    undecided = [it for it in items if it.decision is None]
    for it in undecided:
        it.max_ones = int(np.floor(cfg.nperm * cfg.alpha)) + 1
    for chunk in _chunks(undecided, cfg.seg_batch):
        if device_stream:
            _perm_loop_device(chunk, jobs, salts, n_pad, lengths, cfg, device)
        else:
            _perm_loop_host(chunk, jobs, salts, n_pad, lengths, cfg,
                            observed, device)


def _perm_loop_device(chunk, jobs, salts, n_pad, lengths, cfg, device):
    """Early-terminating permutation rounds with Threefry sort keys:
    ``perm_batch`` rows per round, fair-shared among the undecided items."""
    w_seg, wx_seg, n_seg = _seg_tables(chunk, jobs, n_pad, device)
    base_key = prng_key(0 if cfg.seed is None else cfg.seed)
    b = max(64, int(cfg.perm_batch))
    while any(_live(it, cfg) for it in chunk):
        active = [s for s, it in enumerate(chunk) if _live(it, cfg)]
        counts = _alloc_rows(b, active,
                             [cfg.nperm - chunk[s].done for s in active])
        seg_of_row, words = _round_rows(chunk, active, counts, salts, device)
        ex_counts, _ = perm_round(base_key, w_seg, wx_seg, n_seg, seg_of_row,
                                  *words, lengths, cfg.min_width, cfg.kmax)
        ex_counts = ex_counts.cpu().numpy()
        for pos, s in enumerate(active):
            it = chunk[s]
            it.exceed += int(ex_counts[s])
            it.done += counts[pos]
            _settle(it, cfg)
    for it in chunk:
        if it.decision is None:
            it.decision = it.exceed < it.max_ones


def _round_rows(chunk, active, counts, salts, device):
    """Segment slot [B] and key words (salt, lo, hi, draw) [4, B] of one
    device-stream round: ``counts[pos]`` rows for item ``chunk[active[pos]]``,
    its next draws.  Rows nobody was given are left out: they would not
    count."""
    seg_of_row = np.repeat(active, counts)
    words = np.zeros((4, len(seg_of_row)), dtype=np.int64)
    r = 0
    for pos, s in enumerate(active):
        k = counts[pos]
        it = chunk[s]
        words[:, r : r + k] = [[salts[it.ji]], [it.lo], [it.hi], [0]]
        words[3, r : r + k] = np.arange(it.done, it.done + k)
        r += k
    return (torch.as_tensor(seg_of_row, dtype=torch.int64, device=device),
            torch.as_tensor(words, device=device))


def _perm_loop_host(chunk, jobs, salts, n_pad, lengths, cfg, observed,
                    device):
    """Early-terminating permutation rounds: host per-draw permutation
    streams, max |T| of the permuted rows on the device."""
    b = max(64, int(cfg.perm_batch))
    seedval = 0 if cfg.seed is None else int(cfg.seed)
    while any(_live(it, cfg) for it in chunk):
        active = [s for s, it in enumerate(chunk) if _live(it, cfg)]
        counts = _alloc_rows(b, active,
                             [cfg.nperm - chunk[s].done for s in active])
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
        best = max_t_rows_reference(
            torch.as_tensor(w_rows, device=device),
            torch.as_tensor(wx_rows, device=device),
            torch.as_tensor(n_rows, device=device),
            lengths, cfg.min_width, cfg.kmax,
        ).cpu().numpy()
        for pos, s in enumerate(active):
            it = chunk[s]
            it.exceed += int(np.sum(best[row_seg == s] >= observed[id(it)]))
            it.done += counts[pos]
            _settle(it, cfg)
    for it in chunk:
        if it.decision is None:
            it.decision = it.exceed < it.max_ones


def _group_items(items, cfg: CBSConfig) -> list:
    """The (bucket, mode) groups of a level's testable items, largest
    bucket first: ``[((n_pad, mode), items), ...]``."""
    groups: dict = {}
    for it in items:
        mode = "exact" if it.n <= cfg.exact_max else "thin"
        groups.setdefault((_bucket(it.n), mode), []).append(it)
    return sorted(groups.items(), reverse=True)


def _segment_jobs(jobs: list, cfg: CBSConfig, device) -> list:
    """Level-synchronous recursive CBS over many (x, w) float64 value
    vectors; returns per-job sorted lists of (lo, hi) segment ranges.  The
    device stream on CUDA, the host stream on the CPU."""
    device = torch.device(device)
    device_stream = device.type == "cuda"
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
        for (n_pad, mode), items in _group_items(testable, cfg):
            _decide_group(items, jobs, salts, n_pad, mode, cfg, device,
                          device_stream)

        # Locate accepted splits with the exact scan, batched per bucket.
        by_pad: dict = {}
        for it in testable:
            if it.decision:
                by_pad.setdefault(_bucket(it.n), []).append(it)
        for n_pad, items in sorted(by_pad.items(), reverse=True):
            for chunk in _chunks(items, cfg.seg_batch):
                i_star, l_star = locate_rows_reference(
                    *_seg_tables(chunk, jobs, n_pad, device), cfg.min_width)
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


def exec_cbs_batch(samples: list, cfg: CBSConfig = CBSConfig(),
                   device: torch.device = torch.device("cpu")) -> list:
    """Segment many samples' genomes: every pending segment of every sample
    joins the same rounds (the decisions do not depend on the grouping).
    ``samples`` holds (results_r, results_w, ref_gender, binsize) tuples;
    returns per sample rows ``[chr0, start, end, ratio]`` (0-based
    half-open bin ranges, 4-decimal ratios)."""
    jobs, meta = _sample_jobs(samples)
    all_segments = _segment_jobs(jobs, cfg, device)
    out = [[] for _ in samples]
    for (si, c, y, w, pos, binsize), segments in zip(meta, all_segments):
        na_run_threshold = int(2e6 / binsize)
        for lo, hi in segments:
            s1 = int(pos[lo]) + 1
            e1 = int(pos[hi - 1]) + 1
            out[si].extend(
                _postprocess_segment(c, s1, e1, y, w, na_run_threshold)
            )
    return out


def _sample_jobs(samples: list):
    """The CBS jobs ((values, weights) per non-empty chromosome) of
    :func:`exec_cbs_batch`'s samples, and per job (sample, chromosome,
    ratios, weights, positions of the kept bins, binsize)."""
    jobs, meta = [], []
    for si, (results_r, results_w, ref_gender, binsize) in enumerate(samples):
        for c in range(24 if ref_gender == "M" else 23):
            prep = _prepare_chromosome(results_r, results_w, c)
            if prep is None:
                continue
            y, w, pos, yv, wv = prep
            jobs.append((yv, wv))
            meta.append((si, c, y, w, pos, binsize))
    return jobs, meta


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
