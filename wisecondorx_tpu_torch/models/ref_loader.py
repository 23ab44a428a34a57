"""Reference tables for the predict stage, placed on a device.

Counterpart of wisecondorx_tpu/models/ref_loader.py.  A reference -- the
``.npz`` written by either package, or the pass dicts
:func:`wisecondorx_tpu_torch.models.reference.build_reference` (or the
JAX package's) returns -- becomes one :class:`PassTables` per pass: the
neighbour indexes translated to global masked space with the distance
cutoff folded in as -1 sentinels, and the PCA components and mean, all
as tensors on the device; the weights stay host float64.

Two ways in:

* :func:`load_reference` builds the tables of every pass of an in-memory
  reference (the tests' and ``build_reference``'s path);
* :class:`ReferenceLoader` streams what a predict (or a plate's
  predict-batch) needs from a ``.npz`` file: only the autosomal pass and
  the resolved gonosomal pass(es), each big member read once on a thread
  pool, the gonosomal rows from its first target row on, and the ``wcx_*``
  caches in place of the distance tables where they serve.

Both build each pass's tables with :func:`build_pass_tables`, which holds
the cache and cutoff policy.

The translation runs in numpy (the JAX package's fallback path; its
native ``tablekit`` is not used).
"""

from __future__ import annotations

import dataclasses
import logging
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import torch

from wisecondorx_tpu_torch.genome import GenomeLayout, MaskedLayout
from wisecondorx_tpu_torch.io.npz import (
    load_member_rows,
    load_reference_npz,
    load_reference_small,
)
from wisecondorx_tpu_torch.device import work_dtype
from wisecondorx_tpu_torch.ops import normalize as norm_ops
from wisecondorx_tpu_torch.utils.log import stage_timer


@dataclasses.dataclass
class PassTables:
    """One pass's predict tables: ``sentinel_idx`` int64 [target_rows, k]
    and the PCA ``components`` [k, n_masked] / ``mean`` [n_masked] on the
    device; host float64 ``weights`` of the target rows; the pass's masked
    layout ``ml``; ``ct`` its first target row."""

    sentinel_idx: torch.Tensor
    components: torch.Tensor
    mean: torch.Tensor
    weights: np.ndarray
    ml: MaskedLayout
    ct: int


@dataclasses.dataclass
class DeviceReference:
    """A reference ready for predict on one device: the npz-schema pass
    dicts (numpy), the meta scalars, one :class:`PassTables` per pass and
    the distance cutoff they were built with."""

    passes: dict
    meta: dict
    tables: dict
    cutoff: float


def translate_and_mask(idx, dist, ml: MaskedLayout, ct: int, cutoff: float):
    """Neighbour indexes of target rows [ct:] to global masked space, with
    neighbours at distance >= cutoff replaced by -1."""
    gi = ml.neighbour_to_global(idx, row_start=ct)
    return norm_ops.sentinel_indexes(gi, dist, cutoff)


def translate_with_okbits(idx, ok_packed, ml: MaskedLayout, ct: int):
    """Like :func:`translate_and_mask`, with the cutoff decision read from
    the bit-packed ``wcx_distok`` cache (numpy packbits layout)."""
    k = idx.shape[1]
    ok = np.unpackbits(np.asarray(ok_packed), axis=1, count=k).astype(bool)
    gi = ml.neighbour_to_global(idx, row_start=ct)
    return np.where(ok, gi, -1).astype(np.int32)


def pass_ct(ref_pass: dict, gender: str) -> int:
    """First target row of a pass: 0 for "A", the pre-chrX masked bin
    count for the gonosomal passes."""
    if gender == "A":
        return 0
    return int(np.asarray(ref_pass["masked_bins_per_chr_cum"])[21])


def _upload_sentinel(sent: np.ndarray, device: torch.device) -> torch.Tensor:
    """The int64 sentinel table on ``device``; a CUDA copy is staged in
    pinned memory and issued without waiting."""
    table = torch.from_numpy(np.ascontiguousarray(sent, dtype=np.int64))
    if device.type == "cuda":
        return table.pin_memory().to(device, non_blocking=True)
    return table.to(device)


def _okbits_serve(ref_pass: dict, a_pass: dict, cutoff: float) -> bool:
    """Whether the bit-packed ``wcx_distok`` mask gives the cutoff decision:
    it holds only at the cutoff it was built for, the autosomal pass's
    maskrepeats-5 schedule entry."""
    cutoffs = np.atleast_1d(a_pass.get("wcx_cutoffs", []))
    return (len(cutoffs) >= 5 and cutoff == float(cutoffs[4])
            and "wcx_distok" in ref_pass)


def needs_distances(ref_pass: dict, a_pass: dict, cutoff: float) -> bool:
    """Whether :func:`build_pass_tables` reads ``ref_pass``'s distances at
    ``cutoff``: for the cutoff mask, unless the cutoff is infinite or the
    cached bits serve, and for the weights, unless cached."""
    mask_reads = not (np.isinf(cutoff) or _okbits_serve(ref_pass, a_pass, cutoff))
    return mask_reads or "wcx_weights" not in ref_pass


def build_pass_tables(ref_pass: dict, gender: str, cutoff: float,
                      device: torch.device, a_pass: dict,
                      idx: np.ndarray | None = None,
                      dist: np.ndarray | None = None) -> PassTables:
    """PassTables of one pass at ``cutoff``.

    ``a_pass`` is the autosomal pass, whose ``wcx_cutoffs`` schedule says
    where the cached ``wcx_distok`` bits serve the cutoff decision.  An
    infinite cutoff keeps every neighbour.  ``idx`` and ``dist`` are the
    pass's indexes and distances from its first target row on, where the
    caller has read them (the streamed loader reads only those rows); by
    default they are sliced from ``ref_pass``, and the distances only where
    :func:`needs_distances` says so."""
    ct = pass_ct(ref_pass, gender)
    ml = MaskedLayout(
        GenomeLayout(np.asarray(ref_pass["bins_per_chr"])),
        np.asarray(ref_pass["mask"], dtype=bool),
    )
    if idx is None:
        idx = np.asarray(ref_pass["indexes"])[ct:]
    if dist is None and needs_distances(ref_pass, a_pass, cutoff):
        dist = np.asarray(ref_pass["distances"])[ct:]
    with stage_timer(f"predict.load.translate_{gender}"):
        if np.isinf(cutoff):
            sent = ml.neighbour_to_global(idx, row_start=ct)
        elif _okbits_serve(ref_pass, a_pass, cutoff):
            sent = translate_with_okbits(
                idx, np.asarray(ref_pass["wcx_distok"])[ct:], ml, ct
            )
        else:
            sent = translate_and_mask(idx, dist, ml, ct, cutoff)
    if "wcx_weights" in ref_pass:
        weights = np.asarray(ref_pass["wcx_weights"], np.float64)[ct:]
    else:
        weights = norm_ops.get_weights(dist)
    dtype = work_dtype(device)
    with stage_timer(f"predict.load.upload_{gender}"):
        return PassTables(
            sentinel_idx=_upload_sentinel(sent, device),
            components=torch.as_tensor(np.asarray(ref_pass["pca_components"]),
                                       dtype=dtype, device=device),
            mean=torch.as_tensor(np.asarray(ref_pass["pca_mean"]), dtype=dtype,
                                 device=device),
            weights=weights, ml=ml, ct=ct,
        )


def reference_cutoff(a_pass: dict, maskrepeats: int) -> float:
    """The distance cutoff at ``maskrepeats`` iterations: infinite at
    ``maskrepeats <= 0``, else the cached schedule entry where the
    reference caches it, else computed from the autosomal distances (the
    cutoff always derives from the autosomal pass, for the gonosomal passes
    too: a quirk of the reference)."""
    cached = np.atleast_1d(a_pass.get("wcx_cutoffs", []))
    if maskrepeats <= 0:
        return float("inf")
    if maskrepeats <= len(cached):
        return float(cached[maskrepeats - 1])
    return norm_ops.get_optimal_cutoff(np.asarray(a_pass["distances"]),
                                       maskrepeats)


def load_reference(source, device: torch.device,
                   maskrepeats: int = 5) -> DeviceReference:
    """Place every pass of a reference on ``device`` for predict.

    ``source`` is a reference ``.npz`` path (written by either package)
    or a ``(passes, meta)`` pair of numpy pass dicts as ``build_reference``
    returns them.  A predict from a file streams only the passes it needs
    through :class:`ReferenceLoader` instead."""
    if isinstance(source, tuple):
        passes, meta = source
    else:
        passes, meta = load_reference_npz(source)
    a_pass = passes["A"]
    cutoff = reference_cutoff(a_pass, maskrepeats)
    tables = {
        g: build_pass_tables(p, g, cutoff, device, a_pass=a_pass)
        for g, p in passes.items()
    }
    return DeviceReference(passes=passes, meta=meta, tables=tables,
                           cutoff=cutoff)


class ReferenceLoader:
    """Streamed reference loading for predict from a ``.npz`` file.

    Usage::

        with ReferenceLoader(path, device) as loader:  # small members
            ...                                    # decide ref_gender
            loader.start([ref_gender], maskrepeats)  # read, translate, upload
            tables = loader.tables("A")            # waits until ready
            nulls = loader.null_ratios("A")

    ``start`` reads the big members (indexes, distances, null ratios) of
    the autosomal pass and of the named gonosomal passes only (one for a
    predict, those a plate's samples resolve to for predict-batch), each
    once, on a thread pool (zlib releases the interpreter lock); a
    gonosomal pass reads its rows from its first target row on.  The
    tables are built by :func:`build_pass_tables`, and a distance table is
    read only where it needs one (with the ``wcx_*`` caches at the default
    depth, or at an infinite cutoff, none is).  The ``[timing]`` stages of
    the members overlap: they say where the bytes went, not how the wall
    clock adds up."""

    def __init__(self, path, device: torch.device):
        self.path = path
        self.device = torch.device(device)
        self.passes, self.meta = load_reference_small(path)
        self._pool = ThreadPoolExecutor(max_workers=8,
                                        thread_name_prefix="wcx-ref-loader")
        self._futs: dict = {}
        self._started = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self) -> None:
        """Wait for the loads in flight and stop the thread pool."""
        self._pool.shutdown(wait=True)

    def _member(self, gender: str, key: str, row_start: int = 0):
        suffix = "" if gender == "A" else f".{gender}"
        with stage_timer(f"predict.load.{key}{suffix}"):
            return load_member_rows(self.path, f"{key}{suffix}", row_start)

    def _cutoff(self, maskrepeats: int) -> float:
        with stage_timer("predict.load.cutoff"):
            return norm_ops.get_optimal_cutoff(
                self._futs[("dist", "A")].result(), maskrepeats
            )

    def _tables(self, gender: str) -> PassTables:
        dist = self._futs.get(("dist", gender))
        tables = build_pass_tables(
            self.passes[gender], gender, self._futs["cutoff"].result(),
            self.device, self.passes["A"],
            idx=self._futs[("idx", gender)].result(),
            dist=None if dist is None else dist.result(),
        )
        rows, k = tables.sentinel_idx.shape
        logging.info("streamed %s sentinel indexes (%.0f MB) to %s", gender,
                     rows * k * 8 / 2**20, self.device)
        return tables

    def start(self, ref_genders, maskrepeats: int) -> None:
        """Start reading, translating and uploading the autosomal pass and
        the gonosomal passes ``ref_genders`` ("F" and/or "M"; once, later
        calls do nothing)."""
        if self._started:
            return
        self._started = True
        genders = ["A"] + sorted(set(ref_genders) - {"A"})
        sub = self._pool.submit
        a_small = self.passes["A"]
        # The cutoff is known up front unless it must come from the
        # autosomal distances; then every pass reads its own as well.
        known = maskrepeats <= 0 or maskrepeats <= len(
            np.atleast_1d(a_small.get("wcx_cutoffs", []))
        )
        cutoff = reference_cutoff(a_small, maskrepeats) if known else None
        for g in genders:
            ct = pass_ct(self.passes[g], g)
            self._futs[("idx", g)] = sub(self._member, g, "indexes", ct)
            if cutoff is None or needs_distances(self.passes[g], a_small, cutoff):
                self._futs[("dist", g)] = sub(self._member, g, "distances", ct)
        if cutoff is None:
            self._futs["cutoff"] = sub(self._cutoff, maskrepeats)
        else:
            self._futs["cutoff"] = Future()
            self._futs["cutoff"].set_result(cutoff)
        for g in genders:
            self._futs[("tables", g)] = sub(self._tables, g)
            self._futs[("null", g)] = sub(self._member, g, "null_ratios")

    def cutoff(self) -> float:
        return self._futs["cutoff"].result()

    def tables(self, gender: str) -> PassTables:
        return self._futs[("tables", gender)].result()

    def null_ratios(self, gender: str) -> np.ndarray:
        return self._futs[("null", gender)].result()
