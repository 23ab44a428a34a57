"""Circular binary segmentation (CBS) with the arc statistic on a device.

Counterpart of wisecondorx_tpu/ops/cbs.py (see its docstring for the
algorithm and the CBS.R post-processing it mirrors).  The max-|T| scans
over arc lengths run as torch ops on the given device in float64; the
recursion, the significance decisions and the post-processing run on the
host.

Permutations come from one of two streams, each keyed per draw by (seed,
the segment's content salt, its lo/hi, the draw index), so a segment's
draws do not depend on how segments are batched:

* the device stream (on CUDA): :func:`perm_round_device` makes the sort
  keys of a whole round with Threefry-2x32, bit-equal to ``jax.random``
  (``fold_in`` over the four key words, then ``bits``), so the decisions
  equal the JAX package's accelerator path;
* the host stream (on the CPU): draw ``d`` is
  ``np.random.default_rng([seed, salt, lo, hi, d]).permutation(n)``, so
  the decisions equal the JAX package's CPU run.

Kernels: on a CUDA tensor :func:`perm_keys` launches csrc/cbs_keys.cu and
:func:`max_t_rows` / :func:`locate_rows` launch csrc/cbs_arcs.cu (the arc
statistic, fused: no [rows, lengths, n] block is written); on a CPU tensor
each takes its plain PyTorch version (:func:`perm_keys_reference`,
:func:`max_t_rows_reference`, :func:`locate_rows_reference`), which runs
on any device.  There is no fallback: on CUDA a kernel that does not
build or launch raises.
"""

from __future__ import annotations

import dataclasses
import threading
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
    #: "perm" (Monte-Carlo permutation) or "hybrid" (permutation over the
    #: arcs up to kmax plus an analytic tail bound for the longer ones).
    p_method: str = "perm"
    #: Accept a split iff the observed max |T| >= this value, without a
    #: permutation test (deterministic mode).
    t_threshold: float | None = None
    #: Max segments decided together.
    seg_batch: int = 32


#: Permutation rounds run per stream since the last reset.  A device round
#: is one :func:`perm_round_device` call; a host round is one batch of
#: host-drawn permutations.
ROUNDS = {"device": 0, "host": 0}


def reset_round_counts() -> None:
    for key in ROUNDS:
        ROUNDS[key] = 0


#: Launches of each CBS kernel since the last :func:`reset_launch_counts`
#: (``cbs_arc_max`` and ``cbs_arc_argmax`` are csrc/cbs_arcs.cu's two
#: entry points).
LAUNCHES = {"cbs_arc_max": 0, "cbs_arc_argmax": 0, "cbs_keys": 0}
_count_lock = threading.Lock()  # predict-batch segments on several devices


def reset_launch_counts() -> None:
    with _count_lock:
        for key in LAUNCHES:
            LAUNCHES[key] = 0


def _count_launch(name: str) -> None:
    with _count_lock:
        LAUNCHES[name] += 1


def _on_card(t: torch.Tensor) -> bool:
    """Whether a wrapper launches its kernel for ``t`` (a CUDA tensor) or
    takes the plain version (a CPU tensor)."""
    return t.is_cuda


def _bucket(n: int) -> int:
    """Padded segment size: x4 steps up to 2048, x2 above."""
    p = 8
    while p < n:
        p *= 4 if p <= 512 else 2
    return p


def _arc_lengths(n_pad: int, cfg: CBSConfig, short_only: bool = False):
    """Window-length family of a size bucket: every length in
    [min_width, kmax] plus, unless ``short_only``, a geometric grid up to
    ``n_pad``."""
    ls = set(range(cfg.min_width, cfg.kmax + 1))
    if not short_only:
        length = float(cfg.kmax)
        while length < n_pad:
            length = max(length * cfg.length_ratio, length + 1.0)
            ls.add(min(int(length), n_pad))
    return np.array(sorted(ls), dtype=np.int64)


def _group_lengths(n_pad: int, cfg: CBSConfig, mode: str) -> np.ndarray:
    """Lengths of a (bucket, mode) group: "exact" every length, "thin" the
    thinned family, "short" hybrid's lengths up to kmax."""
    if mode == "exact":
        return np.arange(n_pad, dtype=np.int64)
    return _arc_lengths(n_pad, cfg, short_only=(mode == "short"))


def _lengths_tensor(n_pad: int, cfg: CBSConfig, mode: str, device):
    """:func:`_group_lengths` as an int32 tensor on ``device`` (what the
    arc kernel takes), converted once on the host."""
    return torch.as_tensor(_group_lengths(n_pad, cfg, mode).astype(np.int32),
                           device=device)


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


def perm_keys(base_key, row_salt, row_lo, row_hi, row_draw, n_rows,
              n_pad: int):
    """Sort keys of a round's permutation rows, [B, n_pad] int64: random
    31-bit keys on a row's real slots, ``0x80000000 | slot`` on its padding
    (which then sorts to the tail in slot order).  ``base_key`` is
    :func:`prng_key`'s pair; the four key words and ``n_rows`` are [B]
    int64.  A CUDA tensor launches csrc/cbs_keys.cu, a CPU tensor takes
    :func:`perm_keys_reference`."""
    if not _on_card(n_rows):
        return perm_keys_reference(base_key, row_salt, row_lo, row_hi,
                                   row_draw, n_rows, n_pad)
    from wisecondorx_tpu_torch.ops import _build

    lib = _build.load()
    rows, dev = n_rows.shape[0], n_rows.device
    words = (row_salt, row_lo, row_hi, row_draw, n_rows)
    for name, t in zip(("row_salt", "row_lo", "row_hi", "row_draw", "n_rows"),
                       words):
        _build.check_tensor(t, name, torch.int64, (rows,), dev)
    out = torch.empty((rows, n_pad), dtype=torch.int64, device=dev)
    if rows == 0 or n_pad == 0:
        return out
    err = lib.wcx_cbs_keys(
        int(base_key[0]) & _M32, int(base_key[1]) & _M32,
        *(t.data_ptr() for t in words), rows, n_pad, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"cbs_keys launch failed: CUDA error {err}")
    _count_launch("cbs_keys")
    return out


def shuffle_rows(keys, w_rows, wx_rows):
    """Sort each row by its keys, carrying the (w, w*x) payloads: a joint
    uniform shuffle of each row's pairs.  The sort is stable; the JAX
    package's is not, so rows where two real slots draw the same key
    (probability ~ n^2 / 2^32 per row) may order differently."""
    order = torch.sort(keys, dim=1, stable=True).indices
    return w_rows.gather(1, order), wx_rows.gather(1, order)


# ---------------------------------------------------------------------------
# The arc statistic: kernels (csrc/cbs_arcs.cu) and plain versions
# ---------------------------------------------------------------------------


def _row_cumsums(w_rows, wx_rows, width: int | None = None):
    """Zero-prefixed cumulative sums [B, width + 1] (width n_pad by
    default) of whole rows, shared by the kernels and the plain versions,
    so that on the card both start from the same float64 sums: the sums
    run over the whole padded rows and only their first ``width`` columns
    are kept."""
    width = w_rows.shape[1] if width is None else width
    zero = torch.zeros((w_rows.shape[0], 1), dtype=w_rows.dtype,
                       device=w_rows.device)
    return (torch.cat([zero, torch.cumsum(w_rows, dim=1)[:, :width]], dim=1),
            torch.cat([zero, torch.cumsum(wx_rows, dim=1)[:, :width]], dim=1))


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


#: The screen of csrc/cbs_arcs.cu (its header derives the margin): the
#: row guard (W >= W_LO, every |cw[j]| <= W_HI and |cwx[j]| <= X_HI), the
#: range of the threshold m, the relative term SHRINK and the absolute
#: floor max(FLOOR_K * Xmax * Wmax, F_MIN).
SCREEN_W_LO, SCREEN_W_HI, SCREEN_X_HI = 2.0**-100, 2.0**100, 2.0**100
SCREEN_M_LO, SCREEN_M_HI = 2.0**-200, 2.0**200
SCREEN_SHRINK = 1.0 - 2.0**-36
SCREEN_FLOOR_K, SCREEN_F_MIN = 2.0**-44, 2.0**-100


def _screen_row_terms(cw, cwx, n_col):
    """The screen's per-row terms (W, X, F, whether the row passes the
    guard), each [B, 1], from zero-prefixed sums and true sizes [B, 1]."""
    pos = torch.arange(cw.shape[1], device=cw.device)
    w_tot = cw.gather(1, n_col)
    x_tot = cwx.gather(1, n_col)
    inside = pos[None, :] <= n_col
    x_max = torch.where(inside, cwx.abs(), 0.0).amax(dim=1, keepdim=True)
    w_max = torch.where(inside, cw.abs(), 0.0).amax(dim=1, keepdim=True)
    ok = ((x_max <= SCREEN_X_HI) & (w_max <= SCREEN_W_HI)
          & (w_tot >= SCREEN_W_LO))  # NaN fails every comparison
    floor = torch.clamp_min(
        (torch.nan_to_num(x_max) * torch.nan_to_num(w_max)) * SCREEN_FLOOR_K,
        SCREEN_F_MIN)
    return w_tot, x_tot, floor, ok


def _screen_q(m, w_tot, ok):
    """The screen's Q for thresholds ``m`` (broadcast against [B, 1]): 0,
    which rules nothing out, outside the guards."""
    in_range = ok & (m >= SCREEN_M_LO) & (m <= SCREEN_M_HI)
    return torch.where(in_range, w_tot * ((m * m) * SCREEN_SHRINK), 0.0)


def arc_screen_reference(w_rows, wx_rows, n_rows, lengths, min_width: int, m):
    """Plain PyTorch version of the arc kernels' screen (tests only): [B,
    G, n_pad + 1] bool, True where the window arc (i, i + L] is valid and
    the screen proves its |T| strictly below ``m`` ([B] or [B, G, n_pad +
    1] float64 thresholds), so the kernel skips it.  The same float64
    operations, in the same order, as csrc/cbs_arcs.cu's screen_a,
    screen_q and screened_out."""
    cw, cwx = _row_cumsums(w_rows, wx_rows)
    n = cw.shape[1] - 1
    n_col = n_rows.reshape(-1, 1)
    w_tot, x_tot, floor, ok = _screen_row_terms(cw, cwx, n_col)
    a = cwx * w_tot - x_tot * cw  # a[j], [B, n + 1]
    w_tot, floor, ok = (t[:, :, None] for t in (w_tot, floor, ok))
    m = torch.as_tensor(m, dtype=cw.dtype, device=cw.device)
    if m.dim() == 1:
        m = m[:, None, None]
    i_idx = torch.arange(n + 1, device=cw.device)
    end = (i_idx[None, :] + lengths[:, None].long()).clamp(max=n)
    w1 = cw[:, end] - cw[:, None, :]
    num = a[:, end] - a[:, None, :]
    w0 = w_tot - w1
    t1 = num.abs() + floor
    skip = t1 * t1 < (w1 * w0) * _screen_q(m, w_tot, ok)
    L3 = lengths[None, :, None].long()
    n3 = n_col[:, :, None]
    valid = ((i_idx[None, None, :] + L3 <= n3) & (L3 >= min_width)
             & (L3 <= n3 - min_width))
    return skip & valid


#: Shared memory csrc/cbs_arcs.cu may stage a row's two sums in
#: (``wcx_cbs_arc_stage_bytes``).
ARC_STAGE_BYTES = 216 * 1024
#: CTAs an arc kernel launch aims at: a row's lengths are cut into enough
#: chunks that a call with few rows (the locate scan: at most
#: ``seg_batch`` segments) still spreads over the card.
ARC_TARGET_CTAS = 2048
#: Window arcs a chunk holds at least, counted as lengths x (width + 1),
#: so that staging a row costs little beside its arcs.
ARC_MIN_ARCS = 1 << 19
#: Chunks per row at least where rows are read through L2: a row's
#: chunks run next to each other, so fewer rows are in flight than L2
#: holds.
ARC_L2_CHUNKS = 4


def arc_width(n_pad: int, n_max: int | None) -> int:
    """Columns (less one) of the sums the arc kernels get: the largest true
    row size where the caller knows it, else ``n_pad``."""
    return n_pad if n_max is None else max(0, min(int(n_max), n_pad))


def arc_staged(width: int) -> bool:
    """Whether the arc kernels stage rows of ``width`` + 1 columns in
    shared memory (else they read them through L2)."""
    return 2 * (width + 1) * 8 <= ARC_STAGE_BYTES


def arc_chunks(rows: int, n_lengths: int, width: int) -> int:
    """Chunks per row of the arc kernels' grid: about ``ARC_TARGET_CTAS``
    blocks in all (at least ``ARC_L2_CHUNKS`` per row on the L2 path), no
    more than the lengths and no fewer than ``ARC_MIN_ARCS`` arcs each,
    and at most 2^31 - 1 blocks."""
    want = -(-ARC_TARGET_CTAS // max(rows, 1))
    if not arc_staged(width):
        want = max(want, ARC_L2_CHUNKS)
    most = max(1, min(n_lengths, n_lengths * (width + 1) // ARC_MIN_ARCS))
    return max(1, min(want, most, (2**31 - 1) // max(rows, 1)))


def arc_chunk_bounds(lengths, n: int, min_width: int, chunks: int) -> list:
    """[(g0, g1)] per chunk: the lengths a block of a row of true size
    ``n`` takes (csrc/cbs_arcs.cu chunk_range).  Chunk c starts at the
    first g whose preceding lengths hold total * c // chunks window arcs,
    so the chunks are contiguous, of about equal arcs, and hold every
    length with an arc exactly once."""
    L = np.asarray(lengths, dtype=np.int64)
    arcs = np.where((L >= min_width) & (L <= n - min_width), n - L + 1, 0)
    before = np.concatenate([[0], np.cumsum(arcs)])
    total = int(before[-1])

    def first(target):
        return 0 if target <= 0 else int(np.searchsorted(before, target))

    return [(first(total * c // chunks), first(total * (c + 1) // chunks))
            for c in range(chunks)]


def _arc_launch_args(w_rows, wx_rows, n_rows, lengths, n_max, exact_arcs):
    """Checks what the arc kernels take; returns (cw, cwx, width, chunks)."""
    from wisecondorx_tpu_torch.ops import _build

    rows, n_pad = w_rows.shape
    dev = w_rows.device
    for name, t in (("w_rows", w_rows), ("wx_rows", wx_rows)):
        _build.check_tensor(t, name, torch.float64, (rows, n_pad), dev)
    _build.check_tensor(n_rows, "n_rows", torch.int64, (rows,), dev)
    _build.check_tensor(lengths, "lengths", torch.int32, (lengths.shape[0],), dev)
    if exact_arcs is not None:
        _build.check_tensor(exact_arcs, "exact_arcs", torch.int64, (1,), dev)
    width = arc_width(n_pad, n_max)
    cw, cwx = _row_cumsums(w_rows, wx_rows, width)
    return cw, cwx, width, arc_chunks(rows, lengths.shape[0], width)


def _arc_max_launch(cw, cwx, n_rows, lengths, min_width, kmax, width, chunks,
                    exact_arcs=None):
    """Launches csrc/cbs_arcs.cu's wcx_cbs_arc_max on sums [B, width + 1]
    from :func:`_arc_launch_args`; returns the maxima [B]."""
    from wisecondorx_tpu_torch.ops import _build

    rows = cw.shape[0]
    out = torch.empty(rows, dtype=torch.float64, device=cw.device)
    if rows == 0:
        return out
    partial = torch.empty(rows * chunks, dtype=torch.float64, device=cw.device)
    err = _build.load().wcx_cbs_arc_max(
        cw.data_ptr(), cwx.data_ptr(), n_rows.data_ptr(), rows, width,
        lengths.data_ptr(), lengths.shape[0], int(min_width), int(kmax),
        chunks, partial.data_ptr(), out.data_ptr(),
        None if exact_arcs is None else exact_arcs.data_ptr(),
        torch.cuda.current_stream(cw.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"cbs_arc_max launch failed: CUDA error {err}")
    _count_launch("cbs_arc_max")
    return out


def _arc_argmax_launch(cw, cwx, n_seg, lengths, min_width, width, chunks,
                       exact_arcs=None):
    """Launches wcx_cbs_arc_argmax likewise; returns (i*, L*) [S]."""
    from wisecondorx_tpu_torch.ops import _build

    rows, dev = cw.shape[0], cw.device
    best_i = torch.empty(rows, dtype=torch.int64, device=dev)
    best_l = torch.empty(rows, dtype=torch.int64, device=dev)
    if rows == 0:
        return best_i, best_l
    part_v = torch.empty(rows * chunks, dtype=torch.float64, device=dev)
    part_g = torch.empty(rows * chunks, dtype=torch.int32, device=dev)
    part_i = torch.empty(rows * chunks, dtype=torch.int32, device=dev)
    err = _build.load().wcx_cbs_arc_argmax(
        cw.data_ptr(), cwx.data_ptr(), n_seg.data_ptr(), rows, width,
        lengths.data_ptr(), lengths.shape[0], int(min_width), chunks,
        part_v.data_ptr(), part_g.data_ptr(), part_i.data_ptr(),
        best_i.data_ptr(), best_l.data_ptr(),
        None if exact_arcs is None else exact_arcs.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"cbs_arc_argmax launch failed: CUDA error {err}")
    _count_launch("cbs_arc_argmax")
    return best_i, best_l


def max_t_rows(w_rows, wx_rows, n_rows, lengths, min_width: int, kmax: int,
               n_max: int | None = None, exact_arcs=None):
    """Max |T| per row over the window arcs of ``lengths`` plus the wrap
    arcs of circular length <= kmax; -inf where no arc is valid, NaN where
    a valid arc is NaN.  ``w_rows``/``wx_rows`` [B, n_pad] float64 (zero
    past each row's true size ``n_rows[b]``, int64).  A CUDA tensor
    launches csrc/cbs_arcs.cu (``lengths`` int32 there; no host sync), a
    CPU tensor takes :func:`max_t_rows_reference`.  ``n_max``, a bound on
    ``n_rows`` the caller knows on the host, sizes the sums the kernel
    stages; ``exact_arcs`` (int64 [1] on the card, or None) receives the
    number of arcs that took the exact formula."""
    if not _on_card(w_rows):
        return max_t_rows_reference(w_rows, wx_rows, n_rows, lengths,
                                    min_width, kmax)
    cw, cwx, width, chunks = _arc_launch_args(w_rows, wx_rows, n_rows, lengths,
                                              n_max, exact_arcs)
    return _arc_max_launch(cw, cwx, n_rows, lengths, min_width, kmax, width,
                           chunks, exact_arcs)


def locate_rows(w_seg, wx_seg, n_seg, min_width: int, n_max: int | None = None,
                exact_arcs=None):
    """Exact scan over every window length per segment: (i*, L*) [S] int64
    of the max |T|, ties to the shortest arc and then the smallest start;
    a length with a NaN arc never wins; (0, 0) where no arc is valid.  A
    CUDA tensor launches csrc/cbs_arcs.cu, a CPU tensor takes
    :func:`locate_rows_reference`.  ``n_max`` and ``exact_arcs`` as in
    :func:`max_t_rows`."""
    if not _on_card(w_seg):
        return locate_rows_reference(w_seg, wx_seg, n_seg, min_width)
    # Lengths past the widest row have no arc; g is L.
    lengths = torch.arange(arc_width(w_seg.shape[1], n_max), dtype=torch.int32,
                           device=w_seg.device)
    cw, cwx, width, chunks = _arc_launch_args(w_seg, wx_seg, n_seg, lengths,
                                              n_max, exact_arcs)
    return _arc_argmax_launch(cw, cwx, n_seg, lengths, min_width, width, chunks,
                              exact_arcs)


def perm_round_device(base_key, w_seg, wx_seg, n_seg, seg_of_row, row_live,
                      row_salt, row_lo, row_hi, row_draw, obs_ext, lengths,
                      min_width: int, kmax: int, use_ext_obs: bool = False,
                      n_max: int | None = None):
    """One permutation round for a chunk of S segments, generated on the
    segments' device.

    ``w_seg``/``wx_seg`` [S, n_pad] (zero past ``n_seg[s]``); per
    permutation row b: its segment ``seg_of_row[b]``, whether it counts
    (``row_live``), and its key words (salt, lo, hi, draw).  The S
    unshuffled segments are scored with the permuted rows, so the observed
    statistic comes out of the same round; with ``use_ext_obs`` (hybrid)
    the permuted maxima are compared with ``obs_ext`` instead.  ``n_max``
    (the largest segment, known on the host) sizes the arc kernel's sums.

    Returns (exceed counts [S] int64, observed max |T| [S])."""
    ROUNDS["device"] += 1
    s = w_seg.shape[0]
    n_rows = n_seg[seg_of_row]
    keys = perm_keys(base_key, row_salt, row_lo, row_hi, row_draw, n_rows,
                     w_seg.shape[1])
    w_p, wx_p = shuffle_rows(keys, w_seg[seg_of_row], wx_seg[seg_of_row])
    best = max_t_rows(torch.cat([w_seg, w_p]), torch.cat([wx_seg, wx_p]),
                      torch.cat([n_seg, n_rows]), lengths, min_width, kmax,
                      n_max=n_max)
    obs = best[:s]
    obs_cmp = obs_ext if use_ext_obs else obs
    ex = (best[s:] >= obs_cmp[seg_of_row]) & row_live
    counts = torch.zeros(s, dtype=torch.int64, device=w_seg.device)
    counts.index_add_(0, seg_of_row, ex.to(torch.int64))
    return counts, obs


# ---------------------------------------------------------------------------
# Analytic tail (the "hybrid" p-method)
# ---------------------------------------------------------------------------


def _nu(x):
    """Siegmund's overshoot correction nu(x) (computable approximation)."""
    from scipy.stats import norm

    x = np.maximum(np.asarray(x, dtype=np.float64), 1e-8)
    phi = norm.pdf(x / 2)
    cdf = norm.cdf(x / 2)
    return ((2.0 / x) * (cdf - 0.5)) / ((x / 2) * cdf + phi)


def _tail_prob_long_arcs(b: float, n: int, kmax: int) -> float:
    """P(max |T| over arcs longer than kmax >= b) under H0: the
    Siegmund-type two-parameter approximation of the JAX package (which
    documents its calibration; it is anti-conservative on skewed weights,
    so "perm" stays the default)."""
    from scipy.stats import norm

    if not np.isfinite(b) or b <= 1.0:
        return 1.0
    t0 = max(kmax / n, 1e-6)
    if t0 >= 0.5:
        return 0.0
    t = np.linspace(t0, 0.5, 1024)
    tt = t * (1.0 - t)
    integrand = _nu(b * np.sqrt(2.0 / (n * tt))) ** 2 / tt**2
    p = float(b**3 * norm.pdf(b) * np.trapezoid(integrand, t))
    return min(max(p, 0.0), 1.0)


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
    group; fills ``it.decision``.

    The host stream and the hybrid tail test need the observed statistic
    first; the device stream takes it from the permutation round itself.
    Hybrid's observed statistic is over the full thinned family, the one
    the analytic tail and the short-arc permutation maxima are held to."""
    lengths = _lengths_tensor(n_pad, cfg, mode, device)
    budgets = {}
    if cfg.t_threshold is not None or mode == "short" or not device_stream:
        obs_lengths = lengths
        if mode == "short":
            obs_lengths = _lengths_tensor(n_pad, cfg, "thin", device)
        for chunk in _chunks(items, cfg.seg_batch):
            w_seg, wx_seg, n_seg = _seg_tables(chunk, jobs, n_pad, device)
            obs = max_t_rows(w_seg, wx_seg, n_seg, obs_lengths,
                             cfg.min_width, cfg.kmax,
                             n_max=max(it.n for it in chunk)).cpu().numpy()
            for s, it in enumerate(chunk):
                o = float(obs[s])
                if not np.isfinite(o) or o <= 0:
                    it.decision = False
                elif cfg.t_threshold is not None:
                    it.decision = bool(o >= cfg.t_threshold)
                elif mode == "short":
                    # The analytic long-arc tail first; the permutation
                    # part spends what is left of alpha.
                    p_tail = _tail_prob_long_arcs(o, it.n, cfg.kmax)
                    if p_tail > cfg.alpha:
                        it.decision = False
                    else:
                        budgets[id(it)] = (o, cfg.alpha - p_tail)
                else:
                    budgets[id(it)] = (o, cfg.alpha)
    if cfg.t_threshold is not None:
        return
    undecided = [it for it in items if it.decision is None]
    for it in undecided:
        alpha = budgets[id(it)][1] if id(it) in budgets else cfg.alpha
        it.max_ones = int(np.floor(cfg.nperm * alpha)) + 1
    for chunk in _chunks(undecided, cfg.seg_batch):
        if device_stream:
            ext_obs = ([budgets[id(it)][0] for it in chunk]
                       if mode == "short" else None)
            _perm_loop_device(chunk, jobs, salts, n_pad, lengths, cfg, device,
                              ext_obs=ext_obs)
        else:
            _perm_loop_host(chunk, jobs, salts, n_pad, lengths, cfg,
                            {id(it): budgets[id(it)][0] for it in chunk},
                            device)


def _perm_loop_device(chunk, jobs, salts, n_pad, lengths, cfg, device,
                      ext_obs=None):
    """Early-terminating permutation rounds with the permutations generated
    on the device: ``perm_batch`` rows per round, fair-shared among the
    undecided items.  ``ext_obs`` (hybrid): per-item observed statistic the
    permuted maxima are compared with."""
    w_seg, wx_seg, n_seg = _seg_tables(chunk, jobs, n_pad, device)
    base_key = prng_key(0 if cfg.seed is None else cfg.seed)
    use_ext = ext_obs is not None
    obs_ext = torch.as_tensor(
        ext_obs if use_ext else np.zeros(len(chunk)), dtype=w_seg.dtype,
        device=device,
    )
    b = max(64, int(cfg.perm_batch))
    while any(_live(it, cfg) for it in chunk):
        active = [s for s, it in enumerate(chunk) if _live(it, cfg)]
        counts = _alloc_rows(b, active,
                             [cfg.nperm - chunk[s].done for s in active])
        seg_of_row, words = _round_rows(chunk, active, counts, salts, device)
        ex_counts, _ = perm_round_device(
            base_key, w_seg, wx_seg, n_seg, seg_of_row,
            torch.ones(len(seg_of_row), dtype=torch.bool, device=device),
            *words, obs_ext, lengths, cfg.min_width, cfg.kmax, use_ext,
            n_max=max(it.n for it in chunk),
        )
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
        ROUNDS["host"] += 1
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
        best = max_t_rows(
            torch.as_tensor(w_rows, device=device),
            torch.as_tensor(wx_rows, device=device),
            torch.as_tensor(n_rows, device=device),
            lengths, cfg.min_width, cfg.kmax, n_max=int(n_rows.max()),
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
        if it.n <= cfg.exact_max:
            mode = "exact"
        elif cfg.p_method == "hybrid":
            mode = "short"
        else:
            mode = "thin"
        groups.setdefault((_bucket(it.n), mode), []).append(it)
    return sorted(groups.items(), reverse=True)


def _segment_jobs(jobs: list, cfg: CBSConfig, device,
                  device_stream: bool | None = None) -> list:
    """Level-synchronous recursive CBS over many (x, w) float64 value
    vectors; returns per-job sorted lists of (lo, hi) segment ranges.

    ``device_stream`` picks the permutation stream; by default the device
    stream on CUDA and the host stream on the CPU."""
    device = torch.device(device)
    if device_stream is None:
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
                i_star, l_star = locate_rows(
                    *_seg_tables(chunk, jobs, n_pad, device), cfg.min_width,
                    n_max=max(it.n for it in chunk),
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
             device: torch.device = torch.device("cpu"),
             _device_stream: bool | None = None) -> list:
    """Segment the per-chromosome log2 ratios.  Returns rows
    ``[chr0, start, end, ratio]`` with 0-based half-open bin ranges and
    4-decimal ratios."""
    return exec_cbs_batch([(results_r, results_w, ref_gender, binsize)], cfg,
                          device, _device_stream=_device_stream)[0]


def exec_cbs_batch(samples: list, cfg: CBSConfig = CBSConfig(),
                   device: torch.device = torch.device("cpu"),
                   _device_stream: bool | None = None) -> list:
    """Segment many samples' genomes in one engine run: every pending
    segment of every sample joins the same rounds.  ``samples`` holds
    (results_r, results_w, ref_gender, binsize) tuples; returns one
    :func:`exec_cbs` row list per sample.  ``_device_stream`` overrides the
    permutation stream the device picks (for tests and timings)."""
    jobs, meta = _sample_jobs(samples)
    all_segments = _segment_jobs(jobs, cfg, device, _device_stream)
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
