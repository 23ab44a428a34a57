"""KNN reference search over several devices of one process.

Counterpart of wisecondorx_tpu/parallel/sharded_knn.py's
``knn_search_multidevice``: the target-row range splits into contiguous
parts (the JAX package's ``np.linspace`` bounds), and one host thread per
device runs the full single-device search (:func:`ops.knn.knn_search`:
K1 + K2 on a CUDA device) on its own copy of the data.  Rows are
independent and every product is computed at a shape that does not
depend on the split (ops/knn.py, ops/knn_cuda.py), so the result equals
the one-device search bit for bit.  The result comes back gathered on
the data's device, where newref's null ratios read the index table; a
caller that wants host arrays copies it there.  The JAX package's GSPMD variant
(``knn_search_sharded``) serves only its mesh dry run and is not ported.
"""

from __future__ import annotations

import contextlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from wisecondorx_tpu_torch.ops.knn import knn_search


def split_bounds(r0: int, r1: int, parts: int) -> np.ndarray:
    """Contiguous part boundaries of rows [r0, r1), as the JAX package
    draws them."""
    return np.linspace(r0, r1, parts + 1).astype(int)


def _indexed(dev) -> torch.device:
    """``dev`` as a torch.device, a CUDA device with its index."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def knn_search_multidevice(data: torch.Tensor, chr_of_bin, masked_chr_starts,
                           masked_bins_per_chr, ref_size: int = 300,
                           row_range: tuple[int, int] | None = None,
                           devices=None, stats: dict | None = None):
    """Row-partitioned KNN over ``devices`` (default: ``data``'s device).

    Same contract as :func:`ops.knn.knn_search`: tensors (indexes int64,
    distances in the search's dtype) gathered on ``data``'s device,
    ordered after the search on the caller's current stream there.  One
    part only when there is one device or fewer than 4 rows per device;
    it runs on the calling thread and its current stream.  Several parts run on one
    thread each, and a part on a CUDA device on a stream of its own that
    first waits for the caller's current stream there (a new thread
    starts on the device's default stream).  ``stats`` receives the
    parts' summed ``flagged_rows`` and ``n_rows``."""
    devices = [_indexed(d) for d in (devices or [data.device])]
    n = data.shape[0]
    r0, r1 = row_range if row_range is not None else (0, n)
    if len(devices) <= 1 or r1 - r0 < 4 * len(devices):
        devices = devices[:1]
    bounds = split_bounds(r0, r1, len(devices))
    copies = {dev: data.to(dev) for dev in devices}  # one per distinct device
    callers = {dev: torch.cuda.current_stream(dev) for dev in copies
               if dev.type == "cuda"}
    threaded = len(devices) > 1

    def run(dev, a, b):
        part_stats: dict = {}
        stream = None
        if threaded and dev.type == "cuda":
            stream = torch.cuda.Stream(dev)
            stream.wait_stream(callers[dev])
            copies[dev].record_stream(stream)  # the caller's, read here
        ctx = (torch.cuda.stream(stream) if stream is not None
               else torch.cuda.device(dev) if dev.type == "cuda"
               else contextlib.nullcontext())
        with ctx:
            idx, dist = knn_search(
                copies[dev], chr_of_bin, masked_chr_starts,
                masked_bins_per_chr, ref_size=ref_size, row_range=(a, b),
                stats=part_stats,
            )
            done = None
            if stream is not None:
                done = torch.cuda.Event()
                done.record(stream)
            return idx, dist, part_stats, done

    jobs = [(dev, int(a), int(b))
            for dev, a, b in zip(devices, bounds[:-1], bounds[1:])]
    if len(jobs) == 1:
        parts = [run(*jobs[0])]
    else:
        with ThreadPoolExecutor(max_workers=len(jobs),
                                thread_name_prefix="wcx-knn-device") as pool:
            parts = list(pool.map(lambda job: run(*job), jobs))
    if stats is not None:
        stats.update(
            flagged_rows=sum(p[2].get("flagged_rows", 0) for p in parts),
            n_rows=r1 - r0,
        )
    gathered = []
    for idx, dist, _, done in parts:
        if done is not None:
            # Made on the part's stream, read on the caller's.
            caller = callers[idx.device]
            caller.wait_event(done)
            idx.record_stream(caller)
            dist.record_stream(caller)
        gathered.append((idx.to(data.device), dist.to(data.device)))
    if len(gathered) == 1:
        return gathered[0]
    return (torch.cat([g[0] for g in gathered]),
            torch.cat([g[1] for g in gathered]))
