"""Batched prediction of a plate of samples on one or several devices.

Counterpart of wisecondorx_tpu/parallel/batch.py without the device mesh:
a :class:`ReferenceLoader` streams the autosomal pass and the gonosomal
passes the plate's samples resolve to, once for the plate, and the PCA
projection and the three-round normalization run over chunks of samples
stacked on a leading axis.  Every chunk is padded to ``chunk`` samples,
so a sample's products have one shape wherever the plate was split.  With
several devices the plate splits into contiguous parts, each on its own
device, with its own loader and host thread.  Host pre- and
post-processing stay per sample.
"""

from __future__ import annotations

import logging
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from wisecondorx_tpu_torch.models.predictor import (
    BinResults,
    PredictConfig,
    assemble_results,
    prepare_sample,
)
from wisecondorx_tpu_torch.models.ref_loader import PassTables, ReferenceLoader
from wisecondorx_tpu_torch.ops import normalize as norm_ops
from wisecondorx_tpu_torch.ops import pca as pca_ops
from wisecondorx_tpu_torch.utils.log import carry, stage_timer


def _run_pass_batched(samples, ref_pass, tables: PassTables, chunk: int):
    """One normalization pass over prepared samples, ``chunk`` at a time.
    Returns per-sample (z, r, weights, ref_sizes, m_lr, m_z)."""
    bins_per_chr = np.asarray(ref_pass["bins_per_chr"])
    mask = np.asarray(ref_pass["mask"], dtype=bool)
    dev = tables.sentinel_idx.device
    tables.wait()
    out = []
    for s0 in range(0, len(samples), chunk):
        block = np.stack([
            norm_ops.coverage_normalize_and_mask(s, bins_per_chr, mask)
            for s in samples[s0 : s0 + chunk]
        ])
        n_real = len(block)
        if n_real < chunk:  # the last chunk: pad with its last sample
            block = np.concatenate([block, block[-1:].repeat(chunk - n_real, 0)])
        projected = pca_ops.project_sample(
            torch.as_tensor(block, dtype=tables.mean.dtype, device=dev),
            tables.components, tables.mean,
        )
        z, r, sizes, m_lr, m_z = (
            t.cpu().numpy() for t in norm_ops.normalize_repeat(
                projected, tables.sentinel_idx, ct=tables.ct
            )
        )
        out.extend(
            (z[i], r[i], tables.weights, sizes[i].astype(np.float64),
             float(m_lr[i]), float(m_z[i]))
            for i in range(n_real)
        )
    return out


def predict_batch(samples_with_binsize, reference: str, cfg: PredictConfig,
                  devices, chunk: int = 8, skip_errors: bool = False,
                  warmup=None) -> list[BinResults | None]:
    """Per-bin results of a plate of samples against the reference
    ``.npz`` at ``reference``, in the plate's order.

    The plate splits into contiguous parts over ``devices``, each run on
    its own thread with its own :class:`ReferenceLoader`; the results
    equal one device's bit for bit.

    ``skip_errors``: a sample that fails preparation (for example one
    missing chromosomes) is logged and left as ``None`` instead of
    aborting the plate.

    ``warmup`` (a ``utils.warmup.Warmup``, or None) is joined by each
    device's ``ReferenceLoader`` before its first upload."""
    cfg.validate()
    devices = [torch.device(d) for d in devices]
    bounds = np.linspace(0, len(samples_with_binsize),
                         len(devices) + 1).astype(int)

    def run(dev, a, b):
        with ReferenceLoader(reference, dev, warmup=warmup) as loader:
            return _predict_part(samples_with_binsize[a:b], loader, cfg,
                                 chunk, skip_errors, first=a)

    jobs = [(dev, int(a), int(b))
            for dev, a, b in zip(devices, bounds[:-1], bounds[1:]) if b > a]
    if len(jobs) <= 1:
        parts = [run(*job) for job in jobs]
    else:
        with ThreadPoolExecutor(max_workers=len(jobs),
                                thread_name_prefix="wcx-batch-device") as pool:
            parts = list(pool.map(carry(lambda job: run(*job)), jobs))
    return [r for part in parts for r in part]


def _predict_part(samples_with_binsize, loader: ReferenceLoader,
                  cfg: PredictConfig, chunk: int, skip_errors: bool,
                  first: int = 0) -> list[BinResults | None]:
    """:func:`predict_batch` of a contiguous part of the plate that starts
    at sample ``first``, on ``loader``'s device."""
    prepped, ok_idx = [], []
    for i, (sample, binsize) in enumerate(samples_with_binsize):
        try:
            prepped.append(
                prepare_sample(sample, binsize, loader.passes, loader.meta, cfg)
            )
            ok_idx.append(i)
        except Exception as e:
            if not skip_errors:
                raise
            logging.error("Skipping sample %d of the plate: %s",
                          first + i + 1, e)
    results: list = [None] * len(samples_with_binsize)
    if not prepped:
        return results

    genders = sorted({p[2] for p in prepped})
    loader.start(genders, cfg.maskrepeats)
    a_pass, tables_a = loader.passes["A"], loader.tables("A")
    with stage_timer("predict_batch.normalize_autosomes"):
        a_out = _run_pass_batched([p[0] for p in prepped], a_pass, tables_a,
                                  chunk)
    for gender in genders:
        idxs = [i for i, p in enumerate(prepped) if p[2] == gender]
        g_pass, tables_g = loader.passes[gender], loader.tables(gender)
        with stage_timer("predict_batch.normalize_gonosomes"):
            g_out = _run_pass_batched([prepped[i][0] for i in idxs], g_pass,
                                      tables_g, chunk)
        null_tables = (loader.null_ratios("A"), loader.null_ratios(gender))
        for j, i in enumerate(idxs):
            results[ok_idx[i]] = assemble_results(
                a_out[i], g_out[j][:4], tables_g.ml, a_pass, g_pass, cfg,
                ref_gender=gender, gender=prepped[i][1],
                n_reads=prepped[i][3], null_tables=null_tables,
            )
    return results
