"""Several processes: the sample axis of ``predict-batch`` and the KNN row
axis of ``newref``.

Counterpart of wisecondorx_tpu/parallel/multihost.py, on
``torch.distributed`` with the gloo backend:

* ``predict-batch`` shards the plate's files over the processes
  (:func:`shard_files`); each scores its own shard, with no traffic
  between them;
* ``newref`` splits each KNN search's target rows over the processes and
  then over each process's devices; the parts meet once, in a host-side
  all-gather at the end of the search (:func:`knn_search_multihost`).

The processes are started the way ``torchrun`` starts them: ``WORLD_SIZE``,
``RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` in the environment.  gloo
exchanges host memory, so two processes may share one card (NCCL refuses
that).  Where the environment names several processes and the process
group cannot start, :func:`maybe_initialize_distributed` raises: a
process never falls back to computing every row on its own.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch
import torch.distributed as dist

from wisecondorx_tpu_torch.parallel.sharded_knn import (
    knn_search_multidevice,
    split_bounds,
)


def maybe_initialize_distributed() -> tuple[int, int]:
    """Start the gloo process group when ``WORLD_SIZE`` > 1.

    Returns (rank, world size); (0, 1) for a single process."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return 0, 1
    try:
        rank = int(os.environ["RANK"])
        addr = os.environ["MASTER_ADDR"]
        port = int(os.environ["MASTER_PORT"])
    except (KeyError, ValueError) as e:
        raise RuntimeError(
            f"WORLD_SIZE={world} needs RANK, MASTER_ADDR and MASTER_PORT: {e}"
        ) from e
    dist.init_process_group(
        "gloo", init_method=f"tcp://{addr}:{port}", world_size=world,
        rank=rank,
    )
    logging.info("torch.distributed (gloo) initialized: process %d of %d",
                 rank, world)
    return rank, world


def process_index_count() -> tuple[int, int]:
    """(rank, world size) of the running process group, or (0, 1)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def all_agree(flag: bool) -> bool:
    """True when ``flag`` holds in every process (a checkpoint stage is
    restored only if every process has it, so all of them skip the same
    collectives)."""
    if process_index_count()[1] <= 1:
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return bool(t.item())


def shard_files(paths: list, process_index: int, process_count: int) -> list:
    """Contiguous per-process shard of an input file list."""
    if process_count <= 1:
        return list(paths)
    bounds = np.linspace(0, len(paths), process_count + 1).astype(int)
    return list(paths[bounds[process_index] : bounds[process_index + 1]])


def knn_search_multihost(data: torch.Tensor, chr_of_bin, masked_chr_starts,
                         masked_bins_per_chr, ref_size: int = 300,
                         row_range: tuple[int, int] | None = None,
                         devices=None, stats: dict | None = None):
    """KNN over every process and, within each, over ``devices``: the
    rows split once over the processes and then per device; one
    all-gather of the parts, padded to the widest, gives every process
    the whole table.  Returns tensors (indexes int64, distances in the
    search's dtype): the gathered table on the host; with one process it
    is :func:`knn_search_multidevice`, on ``data``'s device."""
    rank, world = process_index_count()
    if world <= 1:
        return knn_search_multidevice(
            data, chr_of_bin, masked_chr_starts, masked_bins_per_chr,
            ref_size=ref_size, row_range=row_range, devices=devices,
            stats=stats,
        )
    n = data.shape[0]
    r0, r1 = row_range if row_range is not None else (0, n)
    bounds = split_bounds(r0, r1, world)
    part_stats: dict = {}
    idx, dist_ = knn_search_multidevice(
        data, chr_of_bin, masked_chr_starts, masked_bins_per_chr,
        ref_size=ref_size, row_range=(int(bounds[rank]), int(bounds[rank + 1])),
        devices=devices, stats=part_stats,
    )
    widest = int(np.max(np.diff(bounds)))
    # gloo exchanges host memory.  Indexes travel as int64 and distances
    # in their own type: no float cast of an index.
    send_i = torch.full((widest, ref_size), -1, dtype=torch.int64)
    send_d = torch.zeros((widest, ref_size), dtype=dist_.dtype)
    send_i[: len(idx)] = idx
    send_d[: len(dist_)] = dist_
    got_i = [torch.empty_like(send_i) for _ in range(world)]
    got_d = [torch.empty_like(send_d) for _ in range(world)]
    dist.all_gather(got_i, send_i)
    dist.all_gather(got_d, send_d)
    sizes = np.diff(bounds)
    if stats is not None:
        flagged = torch.tensor([part_stats.get("flagged_rows", 0)])
        dist.all_reduce(flagged)
        stats.update(flagged_rows=int(flagged.item()), n_rows=r1 - r0)
    return (torch.cat([g[:s] for g, s in zip(got_i, sizes)]),
            torch.cat([g[:s] for g, s in zip(got_d, sizes)]))
