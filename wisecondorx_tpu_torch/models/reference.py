"""Reference construction (the ``newref`` stage) on a device.

Counterpart of wisecondorx_tpu/models/reference.py: rescale, sex model,
gender correction, usability mask, then per pass (A / F / M) depth
normalization, PCA residual, PCA-distance bin filter, KNN neighbour search
and null ratios, and finally the predict-side ``wcx_*`` caches.  The
cohort is placed on the device once; every pass works on a row prefix and
column subset of it.

Quirk kept (SURVEY.md 2.9): the PCA-distance filter mutates the *shared*
total mask through a slice view, so bins the A pass drops are absent from
the later F/M passes too.

Every build pipelines its passes through one loop.  A pass splits into
a *prep* (normalization, PCA and the filter; the filter mutates the
shared mask, so the preps run one after another on the calling thread)
and a *search* (KNN, null ratios, the tables' download), which reads
only the pass's own snapshot.  In one process the search runs on a
daemon thread ``wcx-search-<pass>`` while the next pass preps.  In a
multi-process run (``torchrun``-style) the KNN rows split over every
process and each process's devices and meet in one all-gather
(parallel/multihost.py), which every process must reach in the same
order: there the searches run on the calling thread, in plan order.  On
a CUDA device the search runs on a stream of its own, after an event
recorded when its prep finished; the index table stays on the device for
the null ratios, and the tables come back into pinned host memory on a
copy stream while the null ratios compute.  Each finished pass's predict
caches (host float64) run on a two-worker pool.  Stages:
``newref.pass_<g>.prep`` (holding ``.pca``), ``.search`` (the wait for
the search), ``.knn`` and ``.nulls`` (timed where the search runs and
never traced: its kernels land in whatever stage the calling thread
traces), ``newref.predict_cache`` (the wait for the caches) and
``newref.distok_cache``.  Inside ``.knn`` the spans (not stages:
``utils.log.span``) ``knn.search`` (the search itself), ``knn.nulls``
(queuing the null ratios) and ``knn.download`` (the tables' download)
tell its parts apart, each with the attribute ``pass``.

With a checkpoint directory (utils/checkpoint.py) each pass's PCA, each
row chunk of its search and each finished pass are saved as they
complete, from whichever thread made them, so a crashed build re-run
with the same inputs resumes after its last saved stage.  Every build,
checkpointed, resumed or multi-process, equals the one-process build
bit for bit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import logging
import os
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from wisecondorx_tpu_torch.errors import UserInputError
from wisecondorx_tpu_torch.genome import LAST_CHR, MaskedLayout, samples_to_matrix
from wisecondorx_tpu_torch.io.npz import gender_correct, scale_sample
from wisecondorx_tpu_torch.ops import mask as mask_ops
from wisecondorx_tpu_torch.device import work_dtype
from wisecondorx_tpu_torch.ops import knn as knn_ops
from wisecondorx_tpu_torch.ops import normalize as norm_ops
from wisecondorx_tpu_torch.ops import pca as pca_ops
from wisecondorx_tpu_torch.ops.common import median
from wisecondorx_tpu_torch.ops.gmm import train_gender_model
from wisecondorx_tpu_torch.parallel.multihost import (
    all_agree,
    knn_search_multihost,
    process_index_count,
)
from wisecondorx_tpu_torch.parallel.sharded_knn import knn_search_multidevice
from wisecondorx_tpu_torch.utils.checkpoint import NewrefCheckpoint, fingerprint
from wisecondorx_tpu_torch.utils.log import carry, span, stage_timer
from wisecondorx_tpu_torch.utils.threads import DaemonFuture as _DaemonFuture


class NewrefError(RuntimeError, UserInputError):
    """Raised when a reference cannot be built (e.g. too few samples)."""


@dataclasses.dataclass
class NewrefConfig:
    binsize: int = int(1e5)
    refsize: int = 300
    nipt: bool = False
    yfrac: float | None = None
    #: Seed of the null-ratio sample draw and of the sex model's k-means
    #: start (the reference is unseeded).
    seed: int | None = 0
    pca_components: int = 5
    #: Directory for crash-recovery artifacts (None = off).  A killed build
    #: re-run with the same inputs and directory resumes after the last
    #: completed stage; see utils/checkpoint.py.
    checkpoint_dir: str | None = None
    #: KNN rows per checkpoint artifact when checkpointing is on.
    knn_checkpoint_rows: int = 32768


#: The interpreter's thread switch interval (s) while the passes are
#: pipelined.  The search threads give up and take back the interpreter
#: lock around every device call; at Python's default of 5 ms a thread
#: returning from one can wait that long while another thread runs
#: Python.  In a cold process, whose kernels load lazily on first launch,
#: that made the pipelined newref slower than the serial one on an H100
#: (torch_newref_ab.py compares two checkouts' newref cold).
PIPELINE_SWITCH_INTERVAL = 2e-4

#: Keys of a finished pass dict (checkpoint round-trip) and the predict
#: caches saved with it.
_PASS_KEYS = (
    "binsize", "mask", "bins_per_chr", "masked_bins_per_chr",
    "masked_bins_per_chr_cum", "pca_components", "pca_mean",
    "indexes", "distances", "null_ratios", "wcx_weights", "wcx_cutoffs",
)


def build_reference(samples_with_binsize: list[tuple[dict, int]],
                    config: NewrefConfig, device: torch.device,
                    _null_chooser=None, devices=None, warmup=None):
    """Build a normalization reference from negative-control samples.

    ``samples_with_binsize``: (sample dict, binsize) pairs as loaded from
    convert npz files.  ``device`` holds the cohort and runs the PCA;
    ``devices`` (default ``[device]``) share each KNN search's rows, and
    in a multi-process run each process searches its share on its own
    ``devices``.  ``_null_chooser(gender, n_samples)`` overrides the
    seeded null-ratio sample draw (parity tests).  ``warmup`` (a
    ``utils.warmup.Warmup``, or None) is joined just before the first
    device use, the cohort's upload, and its error raised there.

    Returns (passes dict of numpy arrays in the npz schema, meta dict).
    """
    cfg = config
    if _null_chooser is None:
        # Per-pass generator from (seed, pass): pass X's draw does not
        # depend on which passes ran, or finished, before it.
        def _null_chooser(gender, n):
            rng = (
                np.random.default_rng()
                if cfg.seed is None
                else np.random.default_rng([cfg.seed, ord(gender)])
            )
            return knn_ops.choose_null_samples(n, rng)

    matrix, layout, genders, trained_cutoff, nipt = cohort_matrix(
        samples_with_binsize, cfg
    )
    genders_arr = np.array(genders, dtype=object)
    with stage_timer("newref.mask"):
        subsets = [None]
        if genders.count("F") > 4:
            subsets.append(genders_arr == "F")
        if genders.count("M") > 4 and not nipt:
            subsets.append(genders_arr == "M")
        masks = mask_ops.get_masks(matrix, subsets)
        total_mask = np.array(masks[0])  # mutated by the PCA-distance filter
        for m in masks[1:]:
            total_mask &= np.asarray(m)

    plan = [("A", np.ones(len(genders), dtype=bool))]
    if genders.count("F") > 4:
        plan.append(("F", genders_arr == "F"))
    else:
        logging.warning(
            "Provide at least 5 female samples to enable normalization of "
            "female gonosomes."
        )
    if not nipt:
        if genders.count("M") > 4:
            plan.append(("M", genders_arr == "M"))
        else:
            logging.warning(
                "Provide at least 5 male samples to enable normalization of "
                "male gonosomes."
            )

    ckpt = _open_checkpoint(cfg, matrix)
    device = torch.device(device)
    if warmup is not None:
        warmup.result()
    # Timed where it copies, as the JAX package times its device upload.
    with (stage_timer("newref.cohort_upload") if device.type != "cpu"
          else contextlib.nullcontext()):
        cohort = torch.as_tensor(matrix, dtype=work_dtype(device),
                                 device=device)
    passes = _build_passes(plan, cohort, layout, total_mask, cfg,
                           _null_chooser, devices or [device], ckpt)

    # Bit-packed distance < cutoff masks at the default --maskrepeats 5.
    cutoffs = passes["A"]["wcx_cutoffs"]
    if len(cutoffs) >= 5:
        with stage_timer("newref.distok_cache"):
            c5 = float(cutoffs[4])
            for p in passes.values():
                ok = np.asarray(p["distances"], np.float64) < c5
                p["wcx_distok"] = np.packbits(ok, axis=1)

    meta = {
        "is_nipt": nipt,
        "trained_cutoff": trained_cutoff,
        "has_female": "F" in passes,
        "has_male": "M" in passes,
    }
    ckpt.done()
    if ckpt.enabled and ckpt.dir != cfg.checkpoint_dir:
        try:  # the per-process directories' parent, once all are gone
            os.rmdir(cfg.checkpoint_dir)
        except OSError:
            pass
    return passes, meta


def _build_passes(plan, cohort, layout, total_mask, cfg, null_chooser,
                  devices, ckpt):
    """Every pass's prep on this thread, one after another; each pass's
    search started as soon as its prep is done, on its own daemon thread
    (several processes: on this thread when its result is collected, in
    plan order); each pass's predict caches on a two-worker pool,
    submitted as its search finishes.  A pass the checkpoint holds whole
    is restored instead, and with a checkpoint every other pass is saved
    with its caches as soon as it is complete.  On an error anywhere the
    running searches stop at their next step and are joined, and the
    error is raised."""
    passes, searches, caches = {}, {}, {}
    stop = threading.Event()
    inline = process_index_count()[1] > 1
    pool = ThreadPoolExecutor(max_workers=2,
                              thread_name_prefix="wcx-predict-cache")
    switch_interval = sys.getswitchinterval()
    sys.setswitchinterval(PIPELINE_SWITCH_INTERVAL)

    def search_then_cache(prepped, ready):
        built = _search(prepped, cfg, devices, ckpt, ready, stop)
        return built, pool.submit(carry(_predict_cache), prepped.gender,
                                  built["distances"])

    try:
        for gender, cols in plan:
            saved = _restore(ckpt, f"pass_{gender}")
            if saved is not None:
                logging.info("Pass %s restored from checkpoint", gender)
                # The PCA-distance filter mutated the shared mask during
                # this pass; replay that mutation for the later passes.
                after = saved["total_mask_after"]
                total_mask[: len(after)] &= after
                passes[gender] = {k: saved[k] for k in _PASS_KEYS if k in saved}
                passes[gender]["binsize"] = int(saved["binsize"])
                continue
            with stage_timer(f"newref.pass_{gender}.prep"):
                prepped = _prep_pass(gender, cohort, cols, layout,
                                     total_mask, cfg, null_chooser, ckpt)
                ready = _record_event(prepped.corrected)
            run = functools.partial(search_then_cache, prepped, ready)
            searches[gender] = (_Inline(run) if inline else _DaemonFuture(
                run, name=f"wcx-search-{gender}"))
            del prepped, ready, run  # the search holds the pass now
        for gender, fut in searches.items():
            with stage_timer(f"newref.pass_{gender}.search"):
                passes[gender], caches[gender] = fut.result()
            if ckpt.enabled:
                with stage_timer("newref.predict_cache"):
                    passes[gender].update(caches.pop(gender).result())
                # The pass's own mask: the later passes' preps may have
                # mutated the shared one since.
                ckpt.save(f"pass_{gender}",
                          total_mask_after=passes[gender]["mask"],
                          **passes[gender])
        with stage_timer("newref.predict_cache"):
            for gender, fut in caches.items():
                passes[gender].update(fut.result())
    except BaseException:
        stop.set()
        for fut in searches.values():
            fut.wait()
        raise
    finally:
        pool.shutdown(cancel_futures=True)
        sys.setswitchinterval(switch_interval)
    # In plan order, whichever passes were restored: the writer keeps it.
    return {gender: passes[gender] for gender, _ in plan}


class _Inline:
    """A search of a multi-process run: it runs on the calling thread
    when its result is asked for, so every process reaches the search's
    collectives in the same order."""

    def __init__(self, fn):
        self._fn = fn

    def result(self):
        return self._fn()

    def wait(self):
        pass


class _Stopped(Exception):
    """A search stopped because the build failed elsewhere."""


def _open_checkpoint(cfg, matrix) -> NewrefCheckpoint:
    """The build's checkpoint store (disabled without a directory).  Each
    process of a multi-process run keeps its own subdirectory, so no two
    processes write one file."""
    if not cfg.checkpoint_dir:
        return NewrefCheckpoint(None)
    rank, world = process_index_count()
    directory = cfg.checkpoint_dir
    if world > 1:
        directory = os.path.join(directory, f"rank{rank}")
    return NewrefCheckpoint(directory, fingerprint(matrix, cfg))


def _restore(ckpt: NewrefCheckpoint, name: str):
    """A saved stage, or None.  In a multi-process run a stage is restored
    only where every process has it, so all skip the same searches and
    their all-gathers."""
    if not ckpt.enabled:
        return None
    saved = ckpt.load(name)
    return saved if all_agree(saved is not None) else None


def cohort_matrix(samples_with_binsize: list[tuple[dict, int]],
                  config: NewrefConfig):
    """newref's cohort before the mask: samples rescaled to the reference
    bin size, sexed by the gender model, gender-corrected (unless NIPT)
    and stacked.

    Returns (matrix [bins, samples] float64, GenomeLayout, genders,
    trained_cutoff, nipt) where ``nipt`` is ``config.nipt`` after the
    too-few-females check."""
    cfg = config
    if cfg.yfrac is not None and not (0 <= cfg.yfrac <= 1):
        raise NewrefError(
            "Parameter --yfrac should be a positive number lower than or "
            "equal to 1"
        )

    with stage_timer("newref.scale"):
        samples = [
            scale_sample(s, bs, cfg.binsize) for s, bs in samples_with_binsize
        ]
    with stage_timer("newref.gender_model"):
        genders, trained_cutoff, _ = train_gender_model(
            samples, yfrac_override=cfg.yfrac, random_state=cfg.seed
        )

    nipt = cfg.nipt
    if genders.count("F") < 5 and nipt:
        logging.warning(
            "A NIPT reference should have at least 5 female feti samples. "
            "Removing --nipt flag."
        )
        nipt = False
    if not nipt:
        samples = [gender_correct(s, g) for s, g in zip(samples, genders)]
    if len(genders) <= 9:
        raise NewrefError(
            "Provide at least 10 samples to enable the generation of a "
            "reference."
        )
    # The JAX package stacks the samples inside its mask stage.
    with stage_timer("newref.mask"):
        matrix, layout = samples_to_matrix(samples)
    return matrix, layout, genders, trained_cutoff, nipt


@dataclasses.dataclass
class _Prepped:
    """A pass after its prep: what its search reads, and nothing shared."""

    gender: str
    corrected: torch.Tensor
    components: np.ndarray
    mean: np.ndarray
    ml: MaskedLayout  # holds a copy of the pass mask
    chosen: np.ndarray  # the null-ratio samples

    @property
    def first_row(self) -> int:
        """Gonosomal passes search only their chrX/chrY rows; autosome
        rows get the reference's 0-index / 1.0-distance placeholders."""
        return 0 if self.gender == "A" else int(self.ml.masked_chr_starts[22])


def _prep_pass(gender, cohort, cols, layout, total_mask, cfg, null_chooser,
               ckpt):
    """The serial part of a pass: its PCA (restored from ``ckpt`` when
    saved there) and the PCA-distance filter, which mutates
    ``total_mask`` in place through the ``pass_mask`` view."""
    tl = layout.truncated(LAST_CHR[gender])
    pass_mask = total_mask[: tl.total_bins]  # view: the aliasing is intended

    prep = _restore(ckpt, f"prep_{gender}")
    if prep is not None:
        logging.info("Pass %s: PCA restored from checkpoint", gender)
        pass_mask &= prep["mask_after"]  # replay the filter's mutation
        corrected = torch.as_tensor(prep["corrected"], device=cohort.device)
        components, mean = prep["components"], prep["mean"]
    else:
        corrected, components, mean = _pass_pca(gender, cohort, cols, tl,
                                                pass_mask, cfg)
        if ckpt.enabled:
            ckpt.save(f"prep_{gender}", corrected=corrected.cpu().numpy(),
                      components=components, mean=mean, mask_after=pass_mask)
    return _Prepped(gender, corrected, components, mean,
                    MaskedLayout(tl, pass_mask.copy()),
                    np.asarray(null_chooser(gender, corrected.shape[1])))


def _search(p: _Prepped, cfg, devices, ckpt, ready, stop):
    """A pass's search: the KNN tables on the pass's device, the null
    ratios computed from the device index table, and the tables' download
    beside them.  On a CUDA device all of it runs on a stream of this
    thread's own, which first waits for ``ready`` (recorded after the
    prep produced ``corrected`` on the prep's stream).  ``stop`` set:
    raise before the next step."""
    dev = p.corrected.device
    ml, r0 = p.ml, p.first_row
    n_masked = ml.n_masked
    stream = None
    if dev.type == "cuda":
        # A new thread starts on the device's default stream, where its
        # kernels would queue behind the next pass's prep.
        stream = torch.cuda.Stream(dev)
        stream.wait_event(ready)
        p.corrected.record_stream(stream)
    with (torch.cuda.stream(stream) if stream is not None
          else contextlib.nullcontext()):
        _check(stop)
        with stage_timer(f"newref.pass_{p.gender}.knn", trace=False):
            with span("knn.search") as part:
                part.add("pass", p.gender)
                idx, dist = _knn_rows(p, cfg, devices, ckpt, stop)
                idx32 = idx.to(torch.int32)
                searched = _record_event(idx32)
            _check(stop)
            # The null-ratio chunks are queued first, the tables' download
            # after them on its own stream, so the two overlap.
            with span("knn.nulls") as part:
                part.add("pass", p.gender)
                nulls = knn_ops.compute_null_ratios(
                    p.corrected, idx, p.chosen, placeholder_rows=r0)
                del idx
            with span("knn.download") as part:
                part.add("pass", p.gender)
                indexes, distances, tables_done = _download_tables(
                    idx32, dist, searched, n_masked, r0, cfg.refsize
                )
                del idx32, dist
                nulls_host, nulls_done = _download(nulls)
                del nulls
                if tables_done is not None:
                    tables_done.synchronize()
        with stage_timer(f"newref.pass_{p.gender}.nulls", trace=False):
            if nulls_done is not None:
                nulls_done.synchronize()
            null_ratios = nulls_host.numpy()
    return _pass_dict(p, cfg, indexes, distances, null_ratios)


def _knn_rows(p: _Prepped, cfg, devices, ckpt, stop):
    """Rows ``first_row:`` of the pass's KNN tables (indexes int64),
    gathered on its device.  In one process without a checkpoint, one
    search over the process's devices.  Otherwise the rows come to the
    host: in row chunks, each restored or searched and then saved as an
    artifact, with a checkpoint; through every process's all-gather in a
    multi-process run (chunk by chunk with a checkpoint).  The host rows
    are placed on the device once."""
    ml, r0, n_masked = p.ml, p.first_row, p.ml.n_masked
    multi = process_index_count()[1] > 1

    def search(a, b, rows):
        stats: dict = {}
        idx, dist = rows(
            p.corrected, ml.chr_of_masked_bin, ml.masked_chr_starts,
            ml.masked_bins_per_chr, ref_size=cfg.refsize, row_range=(a, b),
            devices=devices, stats=stats,
        )
        _log_reruns(p.gender, stats)
        return idx, dist

    if not (multi or ckpt.enabled) or r0 == n_masked:
        # A pass without rows to search has no chunk and no all-gather.
        return search(r0, n_masked, knn_search_multidevice)
    # Row chunks of one artifact each: a killed build loses at most one
    # chunk of search.
    step = (max(1024, cfg.knn_checkpoint_rows) if ckpt.enabled
            else n_masked - r0)
    chunks = []
    for a in range(r0, n_masked, step):
        _check(stop)
        b = min(a + step, n_masked)
        part = _restore(ckpt, f"knn_{p.gender}_{a}_{b}")
        if part is None:
            idx, dist = search(a, b, knn_search_multihost)
            part = {"idx": idx.cpu().numpy(), "dist": dist.cpu().numpy()}
            ckpt.save(f"knn_{p.gender}_{a}_{b}", **part)
        chunks.append((part["idx"], part["dist"]))
    dev = p.corrected.device
    return tuple(torch.as_tensor(np.concatenate(c), device=dev)
                 for c in zip(*chunks))


def _check(stop):
    if stop.is_set():
        raise _Stopped("the build failed elsewhere")


def _record_event(t: torch.Tensor):
    """An event on the current stream of ``t``'s CUDA device, or None on
    the CPU."""
    if not t.is_cuda:
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(t.device))
    return event


def _download(t: torch.Tensor):
    """Start copying ``t`` to the host on the current stream.  Returns
    (host tensor, event marking the copy's end, or None on the CPU)."""
    if not t.is_cuda:
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host, _record_event(t)


def _download_tables(idx32, dist, searched, n_masked, r0, refsize):
    """The pass's host tables of ``n_masked`` rows: rows ``r0:`` from the
    searched ``idx32``/``dist``, the first ``r0`` rows the placeholders
    (index 0, distance 1.0).  On a CUDA device the copy runs on a stream
    of its own after the event ``searched`` into pinned memory; the
    returned event marks its end and the tables are complete once it has
    completed.  Returns (indexes, distances, event or None) with numpy
    tables."""
    pin = idx32.is_cuda
    indexes = torch.empty((n_masked, refsize), dtype=torch.int32,
                          pin_memory=pin)
    distances = torch.empty((n_masked, refsize), dtype=dist.dtype,
                            pin_memory=pin)
    indexes[:r0] = 0
    distances[:r0] = 1.0
    done = None
    if pin:
        copy = torch.cuda.Stream(idx32.device)
        copy.wait_event(searched)
        with torch.cuda.stream(copy):
            indexes[r0:].copy_(idx32, non_blocking=True)
            distances[r0:].copy_(dist, non_blocking=True)
            done = _record_event(idx32)
        # Allocated on the search stream, read on the copy stream.
        idx32.record_stream(copy)
        dist.record_stream(copy)
    else:
        indexes[r0:] = idx32
        distances[r0:] = dist
    return indexes.numpy(), distances.numpy(), done


def _log_reruns(gender, stats):
    if stats.get("flagged_rows"):
        logging.info("KNN pass %s: %d of %d rows rerun exactly", gender,
                     stats["flagged_rows"], stats["n_rows"])


def _pass_dict(p: _Prepped, cfg, indexes, distances, null_ratios):
    return {
        "binsize": cfg.binsize,
        "mask": p.ml.mask,
        "bins_per_chr": np.asarray(p.ml.layout.bins_per_chr),
        "masked_bins_per_chr": p.ml.masked_bins_per_chr,
        "masked_bins_per_chr_cum": p.ml.masked_bins_per_chr_cum,
        "pca_components": p.components,
        "pca_mean": p.mean,
        "indexes": indexes,
        "distances": distances,
        "null_ratios": null_ratios,
    }


def _pass_pca(gender, cohort, cols, tl, pass_mask, cfg):
    """The pass's depth normalization and PCA, with the PCA-distance bin
    filter, which drops bins far from the median profile from
    ``pass_mask`` (and so from the shared total mask) and fits again.
    Returns (corrected, components, mean)."""
    sub = cohort[: tl.total_bins]
    if not np.all(cols):
        sub = sub[:, torch.as_tensor(np.nonzero(cols)[0], device=cohort.device)]
    with stage_timer(f"newref.pass_{gender}.pca"):
        corrected, components, mean = _normalize_and_pca(sub, pass_mask, cfg)
        dist_to_med = _pca_distance(corrected).cpu().numpy().astype(np.float64)
        mad = np.median(np.abs(dist_to_med - np.median(dist_to_med)))
        cutoff = max(np.median(dist_to_med) + 10 * mad, 5.0)
        bad_bins = dist_to_med > cutoff
        if np.any(bad_bins):
            logging.info(
                "Removing %d anomalous bins based on PCA distance "
                "(cutoff=%.4f)", int(bad_bins.sum()), cutoff,
            )
            masked_indices = np.where(pass_mask)[0]
            pass_mask[masked_indices[bad_bins]] = False  # mutates total_mask
            corrected, components, mean = _normalize_and_pca(
                sub, pass_mask, cfg
            )
    return corrected, components, mean


def _predict_cache(gender: str, distances: np.ndarray) -> dict:
    """Predict-side caches stored as extra ``wcx_*`` npz members: the
    per-bin weights, and for the A pass the optimal-cutoff schedule for
    maskrepeats 1..10.  Pure float64 functions of the distance table."""
    out = {"wcx_weights": norm_ops.get_weights(distances)}
    if gender == "A":
        out["wcx_cutoffs"] = norm_ops.optimal_cutoff_schedule(distances)
    return out


def _normalize_and_pca(sub, pass_mask, cfg):
    """Depth-normalize over the pass's chromosome range (per-sample totals
    over chromosomes 1..last_chr), keep the masked bins, PCA-correct."""
    keep = torch.as_tensor(np.nonzero(pass_mask)[0], device=sub.device)
    masked = sub[keep] / sub.sum(dim=0)
    return pca_ops.train_pca(masked, cfg.pca_components)


def _pca_distance(corrected: torch.Tensor) -> torch.Tensor:
    """Squared distance of every bin profile to the median profile (the
    median averages the two middles, as numpy's does)."""
    return ((corrected - median(corrected, dim=0)) ** 2).sum(dim=1)
