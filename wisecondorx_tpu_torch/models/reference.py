"""Reference construction (the ``newref`` stage) on a device.

Counterpart of wisecondorx_tpu/models/reference.py: rescale, sex model,
gender correction, usability mask, then per pass (A / F / M) depth
normalization, PCA residual, PCA-distance bin filter, KNN neighbour search
and null ratios, and finally the predict-side ``wcx_*`` caches.  The
cohort is placed on the device once; every pass works on a row prefix and
column subset of it.  Passes run one after the other.

Quirk kept (SURVEY.md 2.9): the PCA-distance filter mutates the *shared*
total mask through a slice view, so bins the A pass drops are absent from
the later F/M passes too.

The KNN search splits its rows over every process of a ``torchrun``-style
run and over each process's devices (parallel/multihost.py), and with a
checkpoint directory runs in row chunks whose results, like each pass's
PCA and each finished pass, are saved as they complete
(utils/checkpoint.py): a crashed build re-run with the same inputs
resumes after its last saved stage and equals the uninterrupted build.
"""

from __future__ import annotations

import dataclasses
import logging
import os

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
from wisecondorx_tpu_torch.utils.checkpoint import NewrefCheckpoint, fingerprint
from wisecondorx_tpu_torch.utils.log import stage_timer


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


#: Keys of a finished pass dict (checkpoint round-trip) and the predict
#: caches saved with it.
_PASS_KEYS = (
    "binsize", "mask", "bins_per_chr", "masked_bins_per_chr",
    "masked_bins_per_chr_cum", "pca_components", "pca_mean",
    "indexes", "distances", "null_ratios", "wcx_weights", "wcx_cutoffs",
)


def build_reference(samples_with_binsize: list[tuple[dict, int]],
                    config: NewrefConfig, device: torch.device,
                    _null_chooser=None, devices=None):
    """Build a normalization reference from negative-control samples.

    ``samples_with_binsize``: (sample dict, binsize) pairs as loaded from
    convert npz files.  ``device`` holds the cohort and runs the PCA;
    ``devices`` (default ``[device]``) share each KNN search's rows, and
    in a multi-process run each process searches its share on its own
    ``devices``.  ``_null_chooser(gender, n_samples)`` overrides the
    seeded null-ratio sample draw (parity tests).

    Returns (passes dict of numpy arrays in the npz schema, meta dict).
    """
    cfg = config
    if _null_chooser is None:
        # Per-pass generator from (seed, pass): pass X's draw does not
        # depend on which passes ran before it.
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
    with stage_timer("newref.cohort_upload"):
        cohort = torch.as_tensor(matrix, dtype=work_dtype(device),
                                 device=device)
    passes = {}
    for gender, cols in plan:
        saved = _restore(ckpt, f"pass_{gender}")
        if saved is not None:
            logging.info("Pass %s restored from checkpoint", gender)
            # The PCA-distance filter mutated the shared mask during this
            # pass; replay that mutation for the later passes.
            after = saved["total_mask_after"]
            total_mask[: len(after)] &= after
            passes[gender] = {k: saved[k] for k in _PASS_KEYS if k in saved}
            passes[gender]["binsize"] = int(saved["binsize"])
            continue
        with stage_timer(f"newref.pass_{gender}"):
            passes[gender] = _build_pass(
                gender, cohort, cols, layout, total_mask, cfg, _null_chooser,
                ckpt, devices or [device],
            )
        with stage_timer(f"newref.pass_{gender}.predict_cache"):
            passes[gender].update(
                _predict_cache(gender, passes[gender]["distances"])
            )
        pass_bins = layout.truncated(LAST_CHR[gender]).total_bins
        ckpt.save(f"pass_{gender}", total_mask_after=total_mask[:pass_bins],
                  **passes[gender])

    # Bit-packed distance < cutoff masks at the default --maskrepeats 5.
    cutoffs = passes["A"]["wcx_cutoffs"]
    if len(cutoffs) >= 5:
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
    with stage_timer("newref.matrix"):
        matrix, layout = samples_to_matrix(samples)
    return matrix, layout, genders, trained_cutoff, nipt


def _build_pass(gender, cohort, cols, layout, total_mask, cfg, null_chooser,
                ckpt, devices):
    """One reference pass.  ``total_mask`` is mutated in place by the
    PCA-distance filter through the ``pass_mask`` view."""
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

    ml = MaskedLayout(tl, pass_mask.copy())
    n_masked = ml.n_masked
    # Gonosomal passes search only their chrX/chrY rows; autosome rows get
    # the reference's 0-index / 1.0-distance placeholders.
    r0 = 0 if gender == "A" else int(ml.masked_chr_starts[22])
    chosen = np.asarray(null_chooser(gender, corrected.shape[1]))

    with stage_timer(f"newref.pass_{gender}.knn"):
        indexes = np.zeros((n_masked, cfg.refsize), dtype=np.int32)
        # The kernel path returns float32 distances, the exact path the
        # data's type.
        np_dtype = (np.float32 if corrected.is_cuda
                    or corrected.dtype == torch.float32 else np.float64)
        distances = np.ones((n_masked, cfg.refsize), dtype=np_dtype)
        # With a checkpoint, row chunks of one artifact each: a killed
        # build loses at most one chunk of search.
        step = (max(1024, cfg.knn_checkpoint_rows) if ckpt.enabled
                else max(n_masked - r0, 1))
        for a in range(r0, n_masked, step):
            b = min(a + step, n_masked)
            part = _restore(ckpt, f"knn_{gender}_{a}_{b}")
            if part is None:
                stats: dict = {}
                idx, dist = knn_search_multihost(
                    corrected, ml.chr_of_masked_bin, ml.masked_chr_starts,
                    ml.masked_bins_per_chr, ref_size=cfg.refsize,
                    row_range=(a, b), devices=devices, stats=stats,
                )
                if stats.get("flagged_rows"):
                    logging.info(
                        "KNN pass %s: %d of %d rows rerun exactly", gender,
                        stats["flagged_rows"], stats["n_rows"],
                    )
                ckpt.save(f"knn_{gender}_{a}_{b}", idx=idx, dist=dist)
            else:
                idx, dist = part["idx"], part["dist"]
            indexes[a:b] = idx
            distances[a:b] = dist

    with stage_timer(f"newref.pass_{gender}.nulls"):
        # From the whole index table, after every part has been gathered.
        null_ratios = knn_ops.compute_null_ratios(
            corrected, torch.as_tensor(indexes[r0:], device=corrected.device),
            chosen, placeholder_rows=r0,
        ).cpu().numpy()

    return {
        "binsize": cfg.binsize,
        "mask": ml.mask,
        "bins_per_chr": np.asarray(tl.bins_per_chr),
        "masked_bins_per_chr": ml.masked_bins_per_chr,
        "masked_bins_per_chr_cum": ml.masked_bins_per_chr_cum,
        "pca_components": components,
        "pca_mean": mean,
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
