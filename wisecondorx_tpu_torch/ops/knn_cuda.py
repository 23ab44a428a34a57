"""Per-bin KNN on the two hand-written CUDA kernels (csrc/), with their
plain PyTorch versions beside them.

Counterpart of wisecondorx_tpu/ops/knn_pallas.py.  The search works on
centred, RMS-rescaled float32 data (distances are translation invariant;
without the rescale the norm-trick product cancels in float32 at the
~1e-12 distance scale of depth-normalized profiles) and runs, per row
chunk:

* K1 :func:`bucket_scan` (csrc/knn_bucket.cu): distances to every
  candidate, each row's candidates spread over L buckets (column g to
  bucket g mod L) that keep their M smallest (value, index) pairs, plus
  each bucket's smallest dropped value;
* K2 :func:`extract_topk` (csrc/knn_topk.cu): the ``ref_size`` smallest
  of each row's L*M pool and a flag for rows whose pool may have lost a
  true neighbour.

Flagged rows are rerun exactly with a dense product and a stable sort, so
the result is exact for any (L, M); the geometry only sets how many rows
are rerun.

Dispatch: a CPU tensor takes the plain version of each kernel
(:func:`bucket_scan_reference`, :func:`extract_topk_reference`); a CUDA
tensor launches the kernel or raises.  There is no fallback.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from wisecondorx_tpu_torch.ops.knn import (
    SENTINEL_DISTANCE,
    excluded_index,
    finish_result,
)

#: Buckets per row (L) and bucket depth (M) on the card.  Pool L*M = 8192
#: holds k=300 with headroom; the chance that a bucket receives more than
#: M of a row's true neighbours (the rerun case) is about 1e-3 per row.
LANES = 2048
DEPTH = 4
#: Target rows per K1+K2 launch; bounds the [chunk, L*M] pool buffers
#: (8192 rows = 512 MB at L*M = 8192).
ROW_CHUNK = 8192

#: Sample-axis padding of the candidates: K1's streamed slice depth (KC in
#: csrc/knn_bucket.cu).
S_MULTIPLE = 32

#: Rows of every exact rerun product: a batch of flagged rows is padded
#: to this count, so a row's product has one shape whichever rows were
#: flagged beside it.
RERUN_ROWS = 256

#: Launches of each kernel since the last :func:`reset_launch_counts`.
LAUNCHES = {"knn_bucket": 0, "knn_topk": 0}
_count_lock = threading.Lock()  # searches on several devices count at once


def reset_launch_counts() -> None:
    with _count_lock:
        for key in LAUNCHES:
            LAUNCHES[key] = 0


def _count_launch(name: str) -> None:
    with _count_lock:
        LAUNCHES[name] += 1


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


# ---------------------------------------------------------------------------
# K1: distance + bucketed top-M scan
# ---------------------------------------------------------------------------


def bucket_scan_reference(rows, rnorm, rchr, rstart, rsize, cand, cnorm,
                          cchr, n_valid: int, sentinel: float, *,
                          lanes: int, depth: int):
    """Plain PyTorch version of K1 (any device).

    rows [R, S] f32 targets; rnorm/rchr/rstart/rsize [R]; cand [N_pad, S]
    f32 with N_pad % lanes == 0; cnorm/cchr [N_pad].  Returns
    (vals f32 [R, L*M], idx int32 [R, L*M], drop f32 [R, L]) with pool
    position m*L + l for depth m of bucket l.
    """
    r = rows.shape[0]
    dev = rows.device
    vals = torch.full((r, lanes * depth), torch.inf, dtype=torch.float32,
                      device=dev)
    idx = torch.full((r, lanes * depth), -1, dtype=torch.int32, device=dev)
    drop = torch.full((r, lanes), torch.inf, dtype=torch.float32, device=dev)
    rnorm, rchr = rnorm[:, None], rchr[:, None]
    rstart, rsize = rstart[:, None], rsize[:, None]
    for j in range(cand.shape[0] // lanes):
        cols = slice(j * lanes, (j + 1) * lanes)
        d = (rnorm + cnorm[None, cols]) - 2.0 * (rows @ cand[cols].T)
        g = torch.arange(j * lanes, (j + 1) * lanes, dtype=torch.int32,
                         device=dev)[None, :]
        invalid = (rchr == cchr[None, cols]) | (g >= n_valid) | (d >= sentinel)
        cur_v = torch.where(invalid, torch.inf, d)
        cur_i = excluded_index(g, rstart, rsize).to(torch.int32)
        cur_i = cur_i.expand(r, -1)
        for m in range(depth):
            sl = slice(m * lanes, (m + 1) * lanes)
            v_m, i_m = vals[:, sl], idx[:, sl]
            take = cur_v < v_m
            new_v, new_i = torch.where(take, cur_v, v_m), torch.where(take, cur_i, i_m)
            cur_v, cur_i = torch.where(take, v_m, cur_v), torch.where(take, i_m, cur_i)
            vals[:, sl], idx[:, sl] = new_v, new_i
        drop = torch.minimum(drop, cur_v)
    return vals, idx, drop


def bucket_scan(rows, rnorm, rchr, rstart, rsize, cand, cnorm, cchr,
                n_valid: int, sentinel: float, *, lanes: int = LANES,
                depth: int = DEPTH):
    """K1.  Same arguments and results as :func:`bucket_scan_reference`;
    a CUDA tensor launches csrc/knn_bucket.cu, a CPU tensor takes the
    plain version."""
    if not rows.is_cuda:
        return bucket_scan_reference(
            rows, rnorm, rchr, rstart, rsize, cand, cnorm, cchr, n_valid,
            sentinel, lanes=lanes, depth=depth,
        )
    from wisecondorx_tpu_torch.ops import _build

    lib = _build.load()
    if depth != lib.wcx_knn_bucket_depth():
        raise ValueError(
            f"K1 is compiled for depth {lib.wcx_knn_bucket_depth()}, got {depth}"
        )
    ct, kc = lib.wcx_knn_bucket_col_tile(), lib.wcx_knn_bucket_k_chunk()
    r, s_pad = rows.shape
    n_pad = cand.shape[0]
    if lanes % ct or n_pad % lanes or s_pad % kc or s_pad == 0:
        raise ValueError(
            f"K1 needs lanes % {ct} == 0, n_pad % lanes == 0 and "
            f"s_pad % {kc} == 0 (lanes={lanes}, n_pad={n_pad}, s_pad={s_pad})"
        )
    if n_pad >= 2**31 or n_pad // lanes >= 0xFFFF:
        raise ValueError("K1 indexes candidates with int32 and column "
                         "blocks with 16 bits")
    if rows.data_ptr() % 16 or cand.data_ptr() % 16:
        raise ValueError("K1 reads rows and cand with 16-byte copies")
    dev = rows.device
    f32, i32 = torch.float32, torch.int32
    _build.check_tensor(rows, "rows", f32, (r, s_pad), dev)
    _build.check_tensor(cand, "cand", f32, (n_pad, s_pad), dev)
    for name, t, dt in (("rnorm", rnorm, f32), ("rchr", rchr, i32),
                        ("rstart", rstart, i32), ("rsize", rsize, i32)):
        _build.check_tensor(t, name, dt, (r,), dev)
    _build.check_tensor(cnorm, "cnorm", f32, (n_pad,), dev)
    _build.check_tensor(cchr, "cchr", i32, (n_pad,), dev)
    vals = torch.empty((r, lanes * depth), dtype=f32, device=dev)
    idx = torch.empty((r, lanes * depth), dtype=i32, device=dev)
    drop = torch.empty((r, lanes), dtype=f32, device=dev)
    ptr = torch.Tensor.data_ptr
    err = lib.wcx_knn_bucket(
        ptr(rows), ptr(rnorm), ptr(rchr), ptr(rstart), ptr(rsize), r,
        ptr(cand), ptr(cnorm), ptr(cchr), n_pad, s_pad, int(n_valid),
        float(sentinel), lanes, ptr(vals), ptr(idx), ptr(drop),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"K1 (knn_bucket) launch failed: CUDA error {err}")
    _count_launch("knn_bucket")
    return vals, idx, drop


# ---------------------------------------------------------------------------
# K2: top-k of the pool + exactness flag
# ---------------------------------------------------------------------------


def extract_topk_reference(vals, idx, drop, ref_size: int):
    """Plain PyTorch version of K2 (any device): the ``ref_size``
    smallest pool entries in ascending order (ties: lowest pool position,
    via a stable sort), and the rerun flag.

    The flag is the TPU rule -- the smallest dropped value is finite and
    <= the largest kept finite value -- plus one case that rule misses: a
    finite drop while fewer than ``ref_size`` finite values were kept."""
    order = torch.sort(vals, dim=1, stable=True).indices[:, :ref_size]
    top_v = vals.gather(1, order)
    top_i = idx.gather(1, order)
    finite = torch.isfinite(top_v)
    tau = torch.where(finite, top_v, -torch.inf).max(dim=1).values
    min_drop = drop.min(dim=1).values
    flagged = torch.isfinite(min_drop) & (
        (min_drop <= tau) | (finite.sum(dim=1) < ref_size)
    )
    return top_v, top_i, flagged


def extract_topk(vals, idx, drop, ref_size: int):
    """K2.  Same arguments and results as :func:`extract_topk_reference`;
    a CUDA tensor launches csrc/knn_topk.cu, a CPU tensor takes the plain
    version."""
    if not vals.is_cuda:
        return extract_topk_reference(vals, idx, drop, ref_size)
    from wisecondorx_tpu_torch.ops import _build

    lib = _build.load()
    r, pool = vals.shape
    lanes = drop.shape[1]
    if not 0 < ref_size <= pool:
        raise ValueError(f"ref_size {ref_size} must be in [1, pool={pool}]")
    pool_max = lib.wcx_knn_topk_pool_max()
    if pool > pool_max or pool % 4 or lanes % 4:
        raise ValueError(
            f"K2 holds a row in registers with 16-byte loads: needs pool <= "
            f"{pool_max}, pool % 4 == 0 and lanes % 4 == 0 (pool={pool}, "
            f"lanes={lanes})"
        )
    if vals.data_ptr() % 16 or drop.data_ptr() % 16:
        raise ValueError("K2 reads vals and drop with 16-byte loads")
    dev = vals.device
    _build.check_tensor(vals, "vals", torch.float32, (r, pool), dev)
    _build.check_tensor(idx, "idx", torch.int32, (r, pool), dev)
    _build.check_tensor(drop, "drop", torch.float32, (r, lanes), dev)
    top_v = torch.empty((r, ref_size), dtype=torch.float32, device=dev)
    top_i = torch.empty((r, ref_size), dtype=torch.int32, device=dev)
    flagged = torch.empty(r, dtype=torch.uint8, device=dev)
    ptr = torch.Tensor.data_ptr
    err = lib.wcx_knn_topk(
        ptr(vals), ptr(idx), ptr(drop), r, pool, lanes, ref_size,
        ptr(top_v), ptr(top_i), ptr(flagged),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"K2 (knn_topk) launch failed: CUDA error {err}")
    _count_launch("knn_topk")
    return top_v, top_i, flagged.bool()


# ---------------------------------------------------------------------------
# The search
# ---------------------------------------------------------------------------


def prepare_candidates(data: torch.Tensor, lanes: int):
    """Centre, RMS-rescale and zero-pad ``data`` [n, s] to float32
    [n_pad, s_pad].  Returns (cand, cnorm, scale)."""
    n, s = data.shape
    work = data - data.mean(dim=0)
    rms = float(torch.sqrt((work * work).mean()))
    scale = 1.0 / rms if np.isfinite(rms) and rms != 0.0 else 1.0
    n_pad, s_pad = _round_up(max(n, 1), lanes), _round_up(s, S_MULTIPLE)
    cand = torch.zeros((n_pad, s_pad), dtype=torch.float32, device=data.device)
    cand[:n, :s] = (work * scale).to(torch.float32)
    return cand, (cand * cand).sum(dim=1), scale


def exact_rows(rows, rnorm, rchr, rstart, rsize, cand, cnorm, cchr,
               n_valid: int, sentinel: float, ref_size: int):
    """Dense exact search for a few rows (the rerun of flagged rows):
    masked distances to every candidate and a stable sort."""
    d = (rnorm[:, None] + cnorm[None, :]) - 2.0 * (rows @ cand.T)
    g = torch.arange(cand.shape[0], device=cand.device)[None, :]
    invalid = (
        (rchr[:, None] == cchr[None, :]) | (g >= n_valid) | (d >= sentinel)
    )
    d = torch.where(invalid, torch.inf, d)
    kk = min(ref_size, d.shape[1])
    order = torch.sort(d, dim=1, stable=True).indices[:, :kk]
    vals = d.gather(1, order)
    excl = excluded_index(order, rstart[:, None].long(), rsize[:, None].long())
    if kk < ref_size:
        vals = torch.nn.functional.pad(vals, (0, ref_size - kk), value=torch.inf)
        excl = torch.nn.functional.pad(excl, (0, ref_size - kk), value=-1)
    return vals, excl


def knn_search_cuda(
    data: torch.Tensor,
    chr_of_bin,
    masked_chr_starts,
    masked_bins_per_chr,
    ref_size: int = 300,
    row_range: tuple[int, int] | None = None,
    *,
    lanes: int = LANES,
    depth: int = DEPTH,
    row_chunk: int = ROW_CHUNK,
    stats: dict | None = None,
):
    """Per-bin KNN through K1 + K2 (the kernels on a CUDA tensor, their
    plain versions on a CPU tensor).

    Same contract as :func:`wisecondorx_tpu_torch.ops.knn.knn_search_exact`
    (indexes int64, own-chromosome-excluded space; unfilled slots -1 /
    1e10) with float32 distances; the order of equal distances at the k
    boundary is unspecified.  ``stats`` receives ``flagged_rows``,
    ``n_rows`` and ``scale``.
    """
    if lanes * depth < ref_size:
        raise ValueError(f"pool lanes*depth={lanes * depth} < ref_size={ref_size}")
    n = data.shape[0]
    dev = data.device
    r0, r1 = row_range if row_range is not None else (0, n)
    n_rows = r1 - r0
    if n_rows <= 0:
        return (
            torch.zeros((0, ref_size), dtype=torch.int64, device=dev),
            torch.zeros((0, ref_size), dtype=torch.float32, device=dev),
        )
    cand, cnorm, scale = prepare_candidates(data, lanes)
    sentinel = min(SENTINEL_DISTANCE * scale * scale, 1e30)
    n_pad = cand.shape[0]
    cchr = torch.full((n_pad,), -2, dtype=torch.int32, device=dev)
    cchr[:n] = torch.as_tensor(np.asarray(chr_of_bin, np.int32), device=dev)
    starts = torch.as_tensor(np.asarray(masked_chr_starts, np.int32), device=dev)
    sizes = torch.as_tensor(np.asarray(masked_bins_per_chr, np.int32), device=dev)
    rchr_all = cchr[r0:r1]
    rstart_all = starts[rchr_all.long()].contiguous()
    rsize_all = sizes[rchr_all.long()].contiguous()

    vals_out, idx_out, flags = [], [], []
    for a in range(r0, r1, row_chunk):
        b = min(a + row_chunk, r1)
        sl = slice(a - r0, b - r0)
        vals, idx, drop = bucket_scan(
            cand[a:b], cnorm[a:b], cchr[a:b], rstart_all[sl], rsize_all[sl],
            cand, cnorm, cchr, n, sentinel, lanes=lanes, depth=depth,
        )
        top_v, top_i, flg = extract_topk(vals, idx, drop, ref_size)
        del vals, idx, drop
        vals_out.append(top_v)
        idx_out.append(top_i.long())
        flags.append(flg)
    top_v, top_i = torch.cat(vals_out), torch.cat(idx_out)
    flagged = torch.nonzero(torch.cat(flags)).flatten()

    for fs in range(0, flagged.numel(), RERUN_ROWS):
        rows_f = flagged[fs : fs + RERUN_ROWS]
        m = rows_f.numel()
        padded = torch.cat([rows_f, rows_f[:1].expand(RERUN_ROWS - m)])
        g_rows = padded + r0
        v, e = exact_rows(
            cand[g_rows], cnorm[g_rows], cchr[g_rows], rstart_all[padded],
            rsize_all[padded], cand, cnorm, cchr, n, sentinel, ref_size,
        )
        top_v[rows_f] = v[:m]
        top_i[rows_f] = e[:m]
    if stats is not None:
        stats.update(flagged_rows=int(flagged.numel()), n_rows=n_rows,
                     scale=scale)

    indexes, distances = finish_result(top_v, top_i)
    # Un-scale finite distances back to the data's own units.
    finite = distances < SENTINEL_DISTANCE
    distances = torch.where(
        finite, distances / np.float32(scale * scale), distances
    ).to(torch.float32)
    return indexes, distances
