"""Within-sample reference search: per-bin K nearest neighbours, and the
null ratios built from it.

Counterpart of wisecondorx_tpu/ops/knn.py.  :func:`knn_search_exact` is the
plain PyTorch search (the JAX ``merge_method="sort"`` path): tiled
norm-trick distances, own-chromosome candidates masked to +inf, and a
running merge with a *stable* sort, which keeps the reference's bisect
tie order (equal distances ordered by candidate position).  It is the
port's in-repo oracle for the CUDA kernels of :mod:`.knn_cuda`.

:func:`knn_search` picks the path from the tensor's device: CUDA tensors
go through the hand-written kernels, CPU tensors through the exact path.

Reference-parity details: candidates at distance >= 1e10 are never
selected; unfilled slots report index -1 / distance 1e10; reported
indexes live in the own-chromosome-excluded space of the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from wisecondorx_tpu_torch.ops.common import median

#: The reference's initial "infinite" distance.
SENTINEL_DISTANCE = 1e10


def _layout_tensors(chr_of_bin, masked_chr_starts, masked_bins_per_chr,
                    device):
    chr_t = torch.as_tensor(np.asarray(chr_of_bin, np.int64), device=device)
    starts = torch.as_tensor(
        np.asarray(masked_chr_starts, np.int64), device=device
    )
    sizes = torch.as_tensor(
        np.asarray(masked_bins_per_chr, np.int64), device=device
    )
    return chr_t, starts, sizes


def excluded_index(g, row_start, row_size):
    """Own-chromosome-excluded index of candidate ``g`` for a row whose
    chromosome starts at ``row_start`` and spans ``row_size`` bins."""
    return g - torch.where(g >= row_start, row_size, 0)


def finish_result(vals, idx):
    """Unfilled (+inf) slots become index -1 / distance 1e10."""
    unfilled = torch.isinf(vals)
    return (
        torch.where(unfilled, -1, idx),
        torch.where(unfilled, SENTINEL_DISTANCE, vals),
    )


def knn_search_exact(
    data: torch.Tensor,
    chr_of_bin,
    masked_chr_starts,
    masked_bins_per_chr,
    ref_size: int = 300,
    row_range: tuple[int, int] | None = None,
    col_tile: int = 8192,
    row_tile: int = 4096,
):
    """Exact per-bin K nearest neighbours over other-chromosome bins.

    ``data``: [n_masked, n_samples] PCA-corrected bin vectors on any
    device.  Returns (indexes int64[rows, ref_size], distances
    [rows, ref_size]) on ``data.device`` with indexes in
    own-chromosome-excluded space.

    Row tiles are aligned to multiples of ``row_tile`` in ``data`` and
    always span all of their rows, whatever ``row_range`` asks for: a row's
    distances come from one product of one shape and the same rows, so a
    search split into row ranges (checkpoint chunks, devices, processes)
    equals the whole search bit for bit.  A matrix product's rows do
    depend on the rows that share it (a product of 1-3 rows differs from
    the same rows of a larger one in the last bits).
    """
    n = data.shape[0]
    dev, dtype = data.device, data.dtype
    r0, r1 = row_range if row_range is not None else (0, n)
    if not 0 <= r0 <= r1 <= n:
        raise ValueError(f"row_range {row_range} outside [0, {n}]")
    n_rows = r1 - r0
    if n_rows <= 0:
        return (
            torch.zeros((0, ref_size), dtype=torch.int64, device=dev),
            torch.zeros((0, ref_size), dtype=dtype, device=dev),
        )
    chr_t, starts, sizes = _layout_tensors(
        chr_of_bin, masked_chr_starts, masked_bins_per_chr, dev
    )
    norms = (data * data).sum(dim=1)
    out_i, out_v = [], []
    for a in range(r0 - r0 % row_tile, r1, row_tile):
        b = min(a + row_tile, n)
        rows = data[a:b]
        rchr = chr_t[a:b, None]
        rstart = starts[chr_t[a:b]][:, None]
        rsize = sizes[chr_t[a:b]][:, None]
        run_v = torch.full((b - a, ref_size), torch.inf, dtype=dtype,
                           device=dev)
        run_i = torch.full((b - a, ref_size), -1, dtype=torch.int64,
                           device=dev)
        for c0 in range(0, n, col_tile):
            c1 = min(c0 + col_tile, n)
            d = norms[a:b, None] + norms[None, c0:c1] - 2.0 * (
                rows @ data[c0:c1].T
            )
            invalid = (rchr == chr_t[None, c0:c1]) | (d >= SENTINEL_DISTANCE)
            d = torch.where(invalid, torch.inf, d)
            g = torch.arange(c0, c1, device=dev)[None, :]
            excl = excluded_index(g, rstart, rsize)
            merged_v = torch.cat([run_v, d], dim=1)
            merged_i = torch.cat([run_i, excl.expand(b - a, -1)], dim=1)
            order = torch.sort(merged_v, dim=1, stable=True).indices
            order = order[:, :ref_size]
            run_v = merged_v.gather(1, order)
            run_i = merged_i.gather(1, order)
            if run_v.shape[1] < ref_size:  # fewer candidates than k so far
                pad = ref_size - run_v.shape[1]
                run_v = torch.nn.functional.pad(run_v, (0, pad),
                                                value=torch.inf)
                run_i = torch.nn.functional.pad(run_i, (0, pad), value=-1)
        i, v = finish_result(run_v, run_i)
        keep = slice(max(r0, a) - a, min(r1, b) - a)
        out_i.append(i[keep])
        out_v.append(v[keep])
    return torch.cat(out_i), torch.cat(out_v)


def knn_search(data: torch.Tensor, chr_of_bin, masked_chr_starts,
               masked_bins_per_chr, ref_size: int = 300,
               row_range: tuple[int, int] | None = None,
               stats: dict | None = None):
    """Per-bin KNN on the path that suits ``data``'s device: the CUDA
    kernels for a CUDA tensor (ops/knn_cuda.py), the exact plain path for
    a CPU tensor.  Same contract as :func:`knn_search_exact`, except that
    the kernel path returns float32 distances and leaves the order of
    equal distances at the k boundary unspecified."""
    if data.is_cuda:
        from wisecondorx_tpu_torch.ops.knn_cuda import knn_search_cuda

        return knn_search_cuda(
            data, chr_of_bin, masked_chr_starts, masked_bins_per_chr,
            ref_size=ref_size, row_range=row_range, stats=stats,
        )
    return knn_search_exact(
        data, chr_of_bin, masked_chr_starts, masked_bins_per_chr,
        ref_size=ref_size, row_range=row_range,
    )


def compute_null_ratios(data: torch.Tensor, indexes: torch.Tensor,
                        sample_ids, placeholder_rows: int = 0):
    """Null log2 ratios for the chosen reference samples.

    For each chosen sample s and bin b:
    ``r = log2(data[b, s] / median(data[indexes[b], s]))``.  The stored
    indexes are in own-chromosome-excluded space but are applied to the
    full masked-space vector, and index -1 wraps to the last bin (numpy
    negative indexing): both are quirks of the reference kept on purpose.
    Tensor ``%`` is floor-mod, so ``idx % n`` wraps like numpy.

    ``placeholder_rows`` prepends that many all-zero index rows (the
    gonosomal passes' autosome placeholders).  Returns [rows, chosen] on
    ``data.device``.
    """
    n = data.shape[0]
    ids = torch.as_tensor(np.asarray(sample_ids, np.int64), device=data.device)
    sub = data[:, ids]
    if placeholder_rows:
        indexes = torch.cat([
            torch.zeros((placeholder_rows, indexes.shape[1]),
                        dtype=indexes.dtype, device=indexes.device),
            indexes,
        ])
    n_rows, k = indexes.shape
    chosen = max(int(ids.numel()), 1)
    # Row chunks bound the [chunk, k, chosen] gather to ~256 MB.
    chunk = max(1, 2**28 // (k * chosen * data.element_size()))
    out = []
    for s in range(0, n_rows, chunk):
        e = min(s + chunk, n_rows)
        gathered = sub[indexes[s:e].long() % n]  # [c, k, chosen]
        out.append(torch.log2(sub[s:e] / median(gathered, dim=1)))
    return torch.cat(out) if out else sub[:0]


def choose_null_samples(n_samples: int, rng: np.random.Generator):
    """Pick min(n_samples, 100) sample columns for the null-ratio table
    with a seeded Generator (the reference draws them unseeded)."""
    return rng.choice(n_samples, size=min(n_samples, 100), replace=False)
