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

The translation (``native/tablekit.cpp`` in the JAX package) runs on the
tables' device: the stored int32 indexes and the cutoff's source (the
packed ``wcx_distok`` bits or the distances) are uploaded as they are
stored and translated there by :func:`translate_on_device`, on a CUDA
stream of the loading thread's own.  The numpy :func:`translate_and_mask`
and :func:`translate_with_okbits` stay as its plain version
(:func:`plain_sentinel`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import torch

from wisecondorx_tpu_torch.genome import GenomeLayout, MaskedLayout
from wisecondorx_tpu_torch.io.npz import (
    NpzReader,
    load_reference_npz,
    load_reference_small,
)
from wisecondorx_tpu_torch.device import to_device, work_dtype
from wisecondorx_tpu_torch.ops import normalize as norm_ops
from wisecondorx_tpu_torch.utils.log import carry, stage_timer


#: Bytes of one int64 ``[chunk, k]`` temporary of the translation (the
#: JAX package's 64 MB upload chunk).
TRANSLATE_CHUNK_BYTES = 64 << 20


@dataclasses.dataclass
class PassTables:
    """One pass's predict tables: ``sentinel_idx`` int64 [target_rows, k]
    and the PCA ``components`` [k, n_masked] / ``mean`` [n_masked] on the
    device; host float64 ``weights`` of the target rows; the pass's masked
    layout ``ml``; ``ct`` its first target row.

    ``sentinel_idx`` is int64 (the JAX package's table is int32, with the
    same values): it is the index of ``normalize_repeat``'s gather, which
    takes int64 without a cast in every round.  ``ready``: on a CUDA
    device, the event recorded after the tables' upload and translation
    on the stream that built them (see :meth:`wait`); ``upload_bytes``:
    the bytes of the host arrays they were built from (copied to a CUDA
    device, shared on the CPU)."""

    sentinel_idx: torch.Tensor
    components: torch.Tensor
    mean: torch.Tensor
    weights: np.ndarray
    ml: MaskedLayout
    ct: int
    ready: torch.cuda.Event | None = None
    upload_bytes: int = 0

    def wait(self) -> None:
        """Make the current stream of the tables' device wait for their
        upload and translation, and mark the tensors as used there, so
        the allocator keeps them until its work on them is done."""
        if self.ready is None:
            return
        stream = torch.cuda.current_stream(self.sentinel_idx.device)
        stream.wait_event(self.ready)
        for t in (self.sentinel_idx, self.components, self.mean):
            t.record_stream(stream)


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


def translate_chunk_rows(k: int) -> int:
    """Rows per chunk of :func:`translate_on_device` (64 MB of int64)."""
    return max(1, TRANSLATE_CHUNK_BYTES // max(k * 8, 1))


def translate_on_device(idx: torch.Tensor, row_starts: torch.Tensor,
                        row_sizes: torch.Tensor, keep=None,
                        chunk_rows: int | None = None) -> torch.Tensor:
    """``native/tablekit.cpp``'s translation as torch ops on ``idx``'s
    device: for target row ``r`` and neighbour ``j``

        out[r, j] = keep(r, j) ? idx[r, j] + (idx[r, j] >= row_starts[r]
                                              ? row_sizes[r] : 0) : -1

    (``MaskedLayout.neighbour_to_global`` with the cutoff folded in).
    ``idx`` int32 or int64 [rows, k]; ``row_starts`` / ``row_sizes`` [rows]
    the masked start and size of each target row's chromosome; ``keep`` a
    function ``(a, b) -> bool [b - a, k]`` of rows ``a:b`` (see
    :func:`keep_from_bits`, :func:`keep_below`), None to keep every
    neighbour.  Runs over chunks of ``chunk_rows`` rows (default
    :func:`translate_chunk_rows`), so the temporaries stay bounded.
    Returns int64 [rows, k]."""
    rows, k = idx.shape
    chunk = chunk_rows or translate_chunk_rows(k)
    out = torch.empty((rows, k), dtype=torch.int64, device=idx.device)
    for a in range(0, rows, chunk):
        b = min(a + chunk, rows)
        part = out[a:b]
        part.copy_(idx[a:b])
        part += torch.where(part >= row_starts[a:b, None],
                            row_sizes[a:b, None], 0)
        if keep is not None:
            part.masked_fill_(~keep(a, b), -1)
    return out


def keep_from_bits(ok_packed: torch.Tensor, k: int):
    """The ``keep`` of :func:`translate_on_device` read from the
    ``wcx_distok`` bits: uint8 [rows, ceil(k / 8)] in numpy's ``packbits``
    layout (big-endian within each byte; bits past ``k`` ignored)."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=ok_packed.device)

    def keep(a, b):
        bits = (ok_packed[a:b, :, None] >> shifts) & 1
        return bits.reshape(b - a, -1)[:, :k].bool()

    return keep


def keep_below(dist: torch.Tensor, cutoff: float):
    """The ``keep`` of :func:`translate_on_device` for ``dist < cutoff``,
    compared in float64 as the JAX package compares it: a float32 compare
    would flip a distance that rounds to the cutoff.  NaN keeps nothing."""
    return lambda a, b: dist[a:b].double() < cutoff


def _cutoff_source(ref_pass: dict, a_pass: dict, cutoff: float, ct: int,
                   dist: np.ndarray | None):
    """Where the cutoff decision of a pass's target rows comes from:
    ("all", None) at an infinite cutoff, ("bits", packed wcx_distok rows)
    where :func:`_okbits_serve` says so, else ("dist", distances)."""
    if np.isinf(cutoff):
        return "all", None
    if _okbits_serve(ref_pass, a_pass, cutoff):
        return "bits", np.asarray(ref_pass["wcx_distok"])[ct:]
    return "dist", dist


def plain_sentinel(ref_pass: dict, gender: str, cutoff: float, a_pass: dict,
                   idx: np.ndarray | None = None,
                   dist: np.ndarray | None = None) -> np.ndarray:
    """The plain (host numpy) version of the sentinel table that
    :func:`build_pass_tables` builds on the device, from the same inputs:
    int32, the JAX package's numpy route."""
    ct = pass_ct(ref_pass, gender)
    ml = _masked_layout(ref_pass)
    if idx is None:
        idx = np.asarray(ref_pass["indexes"])[ct:]
    if dist is None and needs_distances(ref_pass, a_pass, cutoff):
        dist = np.asarray(ref_pass["distances"])[ct:]
    kind, src = _cutoff_source(ref_pass, a_pass, cutoff, ct, dist)
    if kind == "all":
        return ml.neighbour_to_global(idx, row_start=ct)
    if kind == "bits":
        return translate_with_okbits(idx, src, ml, ct)
    return translate_and_mask(idx, src, ml, ct, cutoff)


def _masked_layout(ref_pass: dict) -> MaskedLayout:
    return MaskedLayout(
        GenomeLayout(np.asarray(ref_pass["bins_per_chr"])),
        np.asarray(ref_pass["mask"], dtype=bool),
    )


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
    :func:`needs_distances` says so.

    The stored indexes and the cutoff's source (bits or distances) are
    uploaded as stored and translated on ``device``
    (:func:`translate_on_device`).  On a CUDA device the upload (through
    pinned memory) and the translation run on a stream of their own; the
    tables' ``ready`` event marks their end, and each stage waits for its
    own work, so its seconds are the device's."""
    ct = pass_ct(ref_pass, gender)
    ml = _masked_layout(ref_pass)
    if idx is None:
        idx = np.asarray(ref_pass["indexes"])[ct:]
    if dist is None and needs_distances(ref_pass, a_pass, cutoff):
        dist = np.asarray(ref_pass["distances"])[ct:]
    if "wcx_weights" in ref_pass:
        weights = np.asarray(ref_pass["wcx_weights"], np.float64)[ct:]
    else:
        with stage_timer(f"predict.load.weights_{gender}"):
            weights = norm_ops.get_weights(dist)
    kind, src = _cutoff_source(ref_pass, a_pass, cutoff, ct, dist)
    chr_rows = ml.chr_of_masked_bin[ct : ct + len(idx)]
    host = {
        "idx": np.asarray(idx),
        "starts": np.asarray(ml.masked_chr_starts, np.int64)[chr_rows],
        "sizes": np.asarray(ml.masked_bins_per_chr, np.int64)[chr_rows],
    }
    if src is not None:
        host[kind] = np.asarray(src)
    dtype = work_dtype(device)
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    with (torch.cuda.stream(stream) if stream is not None
          else contextlib.nullcontext()):
        with stage_timer(f"predict.load.upload_{gender}"):
            dev = {key: to_device(a, device) for key, a in host.items()}
            components = to_device(ref_pass["pca_components"], device, dtype)
            mean = to_device(ref_pass["pca_mean"], device, dtype)
            _wait(stream)
        with stage_timer(f"predict.load.translate_{gender}"):
            keep = None
            if kind == "bits":
                keep = keep_from_bits(dev["bits"], idx.shape[1])
            elif kind == "dist":
                keep = keep_below(dev["dist"], cutoff)
            sent = translate_on_device(dev["idx"], dev["starts"],
                                       dev["sizes"], keep)
            ready = _wait(stream)
    return PassTables(
        sentinel_idx=sent, components=components, mean=mean,
        weights=weights, ml=ml, ct=ct, ready=ready,
        upload_bytes=sum(t.nbytes for t in (*dev.values(), components, mean)),
    )


def _pinned(nbytes: int) -> np.ndarray:
    """A uint8 array of ``nbytes`` in pinned host memory."""
    return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True).numpy()


def _wait(stream) -> torch.cuda.Event | None:
    """Record an event on ``stream`` and wait for it on the host; None
    without a stream (the CPU)."""
    if stream is None:
        return None
    event = torch.cuda.Event()
    event.record(stream)
    event.synchronize()
    return event


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
            loader.start([ref_gender], maskrepeats)  # read, upload, translate
            tables = loader.tables("A")            # waits until ready
            nulls = loader.null_ratios("A")

    ``start`` reads the big members (indexes, distances, null ratios) of
    the autosomal pass and of the named gonosomal passes only (one for a
    predict, those a plate's samples resolve to for predict-batch), each
    once, on a thread pool, through one :class:`NpzReader` (whose own pool
    reads a stored member's slices and inflates a deflated member's
    pieces); a gonosomal pass reads its rows from its first target row
    on.  On a CUDA device whose context exists, indexes and distances are
    read straight into pinned memory, which the upload then copies from
    without staging.  The
    tables are built by :func:`build_pass_tables`, and a distance table is
    read only where it needs one (with the ``wcx_*`` caches at the default
    depth, or at an infinite cutoff, none is).  The ``[timing]`` stages of
    the members overlap: they say where the bytes went, not how the wall
    clock adds up.

    ``warmup`` (a ``utils.warmup.Warmup``, or None) is joined before the
    first upload, and its error raised there.

    The caller's own time in the loader is ``ref_loader.open`` (the
    archive's directory and the small members, read on the caller's
    thread) and ``ref_loader.wait`` (each wait for the pool, its span
    attribute ``on`` naming what for: ``tables.<pass>``, ``null.<pass>``,
    ``cutoff`` or ``close``).  Each member's span ``predict.load.<member>``
    carries what :meth:`NpzReader.read` reports: ``bytes``, ``route``,
    ``pieces`` and ``serial_bytes``."""

    def __init__(self, path, device: torch.device, warmup=None):
        self.path = path
        self.device = torch.device(device)
        self._warmup = warmup
        with stage_timer("ref_loader.open"):
            self._reader = NpzReader(path)
            try:
                self.passes, self.meta = load_reference_small(self._reader)
            except BaseException:
                self._reader.close()
                raise
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
        with stage_timer("ref_loader.wait") as span:
            span.add("on", "close")
            self._pool.shutdown(wait=True)
            self._reader.close()

    def _result(self, key, on: str):
        """The result of the pool's future ``key``, the wait timed."""
        with stage_timer("ref_loader.wait") as span:
            span.add("on", on)
            return self._futs[key].result()

    def _member(self, gender: str, key: str, row_start: int = 0):
        suffix = "" if gender == "A" else f".{gender}"
        # What the device reads goes straight into pinned memory; pinning
        # before the context exists would wait for it (the warm-up makes
        # it), so until then the upload stages it as before.
        pinned = (key != "null_ratios" and self.device.type == "cuda"
                  and torch.cuda.is_initialized())
        with stage_timer(f"predict.load.{key}{suffix}") as span:
            read: dict = {}
            rows = self._reader.read(f"{key}{suffix}", row_start, stats=read,
                                     alloc=_pinned if pinned else None)
            for name in ("bytes", "route", "pieces", "serial_bytes"):
                span.add(name, read[name])
            return rows

    def _cutoff(self, maskrepeats: int) -> float:
        with stage_timer("predict.load.cutoff"):
            return norm_ops.get_optimal_cutoff(
                self._futs[("dist", "A")].result(), maskrepeats
            )

    def _tables(self, gender: str) -> PassTables:
        dist = self._futs.get(("dist", gender))
        if self._warmup is not None:
            self._warmup.result()
        tables = build_pass_tables(
            self.passes[gender], gender, self._futs["cutoff"].result(),
            self.device, self.passes["A"],
            idx=self._futs[("idx", gender)].result(),
            dist=None if dist is None else dist.result(),
        )
        logging.info("streamed pass %s's tables (%.1f MB) to %s", gender,
                     tables.upload_bytes / 2**20, self.device)
        return tables

    def start(self, ref_genders, maskrepeats: int) -> None:
        """Start reading, translating and uploading the autosomal pass and
        the gonosomal passes ``ref_genders`` ("F" and/or "M"; once, later
        calls do nothing)."""
        if self._started:
            return
        self._started = True
        genders = ["A"] + sorted(set(ref_genders) - {"A"})

        def sub(fn, *args):
            return self._pool.submit(carry(fn), *args)

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
        return self._result("cutoff", "cutoff")

    def tables(self, gender: str) -> PassTables:
        return self._result(("tables", gender), f"tables.{gender}")

    def null_ratios(self, gender: str) -> np.ndarray:
        return self._result(("null", gender), f"null.{gender}")
