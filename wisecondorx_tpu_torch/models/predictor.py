"""CNA prediction (the ``predict`` stage) on a device.

Counterpart of wisecondorx_tpu/models/predictor.py: coverage-normalize ->
PCA-project -> three-round z-masked normalization, once for the autosomes
and once for the applicable gonosomal pass, then combined, post-processed
and log2-transformed on the host, and segmented by CBS (ops/cbs.py).  The
reference tables come from an in-memory :class:`DeviceReference` or are
streamed by a :class:`ReferenceLoader`.
"""

from __future__ import annotations

import dataclasses
import logging
import warnings

import numpy as np
import torch

from wisecondorx_tpu_torch.device import to_device
from wisecondorx_tpu_torch.errors import UserInputError
from wisecondorx_tpu_torch.genome import GenomeLayout, MaskedLayout
from wisecondorx_tpu_torch.io.npz import gender_correct, scale_sample
from wisecondorx_tpu_torch.models.ref_loader import (
    DeviceReference,
    PassTables,
    ReferenceLoader,
)
from wisecondorx_tpu_torch.ops import normalize as norm_ops
from wisecondorx_tpu_torch.ops import pca as pca_ops
from wisecondorx_tpu_torch.ops.gmm import predict_gender
from wisecondorx_tpu_torch.utils.log import stage_timer


class PredictError(RuntimeError, UserInputError):
    pass


@dataclasses.dataclass
class PredictConfig:
    minrefbins: int = 150
    maskrepeats: int = 5
    alpha: float = 1e-4
    zscore: float = 5.0
    beta: float | None = None
    blacklist: str | None = None
    gender: str | None = None  # force "F"/"M"
    seed: int | None = None

    def validate(self):
        if self.zscore <= 0:
            raise PredictError(
                "Parameter --zscore should be a strictly positive number"
            )
        if self.beta is not None and not (0 < self.beta <= 1):
            raise PredictError(
                "Parameter --beta should be a strictly positive number "
                "lower than or equal to 1"
            )
        if not (0 < self.alpha <= 1):
            raise PredictError(
                "Parameter --alpha should be a strictly positive number "
                "lower than or equal to 1"
            )


@dataclasses.dataclass
class BinResults:
    """Per-bin results on the full bin axis, split per chromosome (the
    layout the ``output.tables`` writers read)."""

    results_r: list
    results_z: list
    results_w: list
    results_nr: list
    ref_gender: str
    gender: str
    binsize: int
    n_reads: int
    layout: GenomeLayout
    masked_layout: MaskedLayout


def _pass_normalize_dispatch(sample, ref_pass, tables: PassTables):
    """Queue one normalization pass on the tables' device and return its
    results unfetched, so that the autosomal and the gonosomal pass run
    back to back on the device.  Nothing here waits for the device: the
    sample goes up through pinned memory, and the current stream waits
    for the tables' own stream on the device."""
    dev = tables.sentinel_idx.device
    masked = norm_ops.coverage_normalize_and_mask(
        sample, np.asarray(ref_pass["bins_per_chr"]),
        np.asarray(ref_pass["mask"], dtype=bool),
    )
    tables.wait()
    projected = pca_ops.project_sample(
        to_device(masked, dev, tables.mean.dtype),
        tables.components, tables.mean,
    )
    return norm_ops.normalize_repeat(projected, tables.sentinel_idx,
                                     ct=tables.ct)


def _pass_fetch(dev_results, tables: PassTables):
    """Host results of a dispatched pass: (z, r, weights, ref_sizes, m_lr,
    m_z)."""
    z, r, sizes, m_lr, m_z = dev_results
    return (
        z.cpu().numpy(), r.cpu().numpy(), tables.weights,
        sizes.cpu().numpy().astype(np.float64), float(m_lr), float(m_z),
    )


def _pass_normalize(sample, ref_pass, tables: PassTables):
    """One normalization pass on the tables' device; host results."""
    return _pass_fetch(_pass_normalize_dispatch(sample, ref_pass, tables),
                       tables)


def prepare_sample(sample, sample_binsize, ref_passes, ref_meta, cfg):
    """Rescale, sex-call, gender-correct and resolve the gonosomal pass.

    Returns (sample, gender, ref_gender, n_reads)."""
    missing = [str(c) for c in range(1, 25) if sample.get(str(c)) is None]
    if missing:
        raise PredictError(
            f"Sample is missing chromosome(s) {', '.join(missing)} — "
            "not a convert-stage npz, or aligned to an incomplete "
            "reference?"
        )
    n_reads = int(np.sum([np.sum(v) for v in sample.values() if v is not None]))
    ref_binsize = int(np.atleast_1d(ref_passes["A"]["binsize"])[0])
    sample = scale_sample(sample, sample_binsize, ref_binsize)

    gender = predict_gender(sample, ref_meta["trained_cutoff"])
    if cfg.gender:
        gender = cfg.gender
    if not ref_meta["is_nipt"]:
        sample = gender_correct(sample, gender)
        ref_gender = gender
        if not ref_meta["has_male"] and gender == "M":
            logging.warning(
                "This sample is male, whilst the reference is created with "
                "fewer than 5 males. The female gonosomal reference will be "
                "used for X predictions. Note that these might not be "
                "accurate. If the latter is desired, create a new reference "
                "and include more male samples."
            )
            ref_gender = "F"
        elif not ref_meta["has_female"] and gender == "F":
            logging.warning(
                "This sample is female, whilst the reference is created "
                "with fewer than 5 females. The male gonosomal reference "
                "will be used for XY predictions. Note that these might not "
                "be accurate. If the latter is desired, create a new "
                "reference and include more female samples."
            )
            ref_gender = "M"
    else:
        ref_gender = "F"

    if ref_gender not in ref_passes:
        raise PredictError(
            f"Reference lacks the {ref_gender!r} gonosomal pass required "
            "for this sample."
        )
    return sample, gender, ref_gender, n_reads


def predict_bins(sample: dict, sample_binsize: int,
                 ref: DeviceReference | None,
                 cfg: PredictConfig = PredictConfig(),
                 loader: ReferenceLoader | None = None) -> BinResults:
    """Combined per-bin r/z/w/null-ratio results for one test sample.

    The tables come from ``ref`` or, when ``loader`` is given (and ``ref``
    is None), are streamed by it: only the autosomal pass and the pass the
    sample's gender resolves to are read."""
    cfg.validate()
    src = loader if loader is not None else ref
    sample, gender, ref_gender, n_reads = prepare_sample(
        sample, sample_binsize, src.passes, src.meta, cfg
    )
    a_pass, g_pass = src.passes["A"], src.passes[ref_gender]
    null_tables = None
    if loader is not None:
        loader.start([ref_gender], cfg.maskrepeats)
        tables_a, tables_g = loader.tables("A"), loader.tables(ref_gender)
        null_tables = (loader.null_ratios("A"), loader.null_ratios(ref_gender))
    else:
        tables_a, tables_g = ref.tables["A"], ref.tables[ref_gender]
    # Both passes are queued before either is fetched: the device runs
    # them back to back while the host waits once.
    with stage_timer("predict.normalize_autosomes"):
        dev_a = _pass_normalize_dispatch(sample, a_pass, tables_a)
        dev_g = _pass_normalize_dispatch(sample, g_pass, tables_g)
        z_a, r_a, w_a, sizes_a, m_lr, m_z = _pass_fetch(dev_a, tables_a)
    with stage_timer("predict.normalize_gonosomes"):
        z_g, r_g, w_g, sizes_g, _, _ = _pass_fetch(dev_g, tables_g)
    return assemble_results(
        (z_a, r_a, w_a, sizes_a, m_lr, m_z),
        (z_g, r_g, w_g, sizes_g),
        tables_g.ml, a_pass, g_pass, cfg,
        ref_gender=ref_gender, gender=gender, n_reads=n_reads,
        null_tables=null_tables,
    )


def assemble_results(a_results, g_results, g_ml, a_pass, g_pass, cfg, *,
                     ref_gender, gender, n_reads,
                     null_tables=None) -> BinResults:
    """Combine the two passes' outputs into per-chromosome BinResults.

    ``null_tables`` gives the (autosomal, gonosomal) null ratios where the
    pass dicts hold only the small members (the streamed path)."""
    z_a, r_a, w_a, sizes_a, m_lr, m_z = a_results
    z_g, r_g, w_g, sizes_g = g_results
    if null_tables is None:
        null_tables = (a_pass["null_ratios"], g_pass["null_ratios"])
    ref_binsize = int(np.atleast_1d(a_pass["binsize"])[0])

    results_r = np.concatenate([r_a, r_g])
    results_z = np.concatenate([z_a, z_g]) - m_z
    # Degenerate tiny references give empty or all-NaN weights; the
    # logged unweighted-CBS warning below is the one signal for that.
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        results_w = np.concatenate(
            [w_a * np.nanmean(w_g), w_g * np.nanmean(w_a)]
        )
        results_w = results_w / np.nanmean(results_w)
    if np.isnan(results_w).any() or np.isinf(results_w).any():
        logging.warning(
            "Non-numeric values found in weights -- reference too small. "
            "Circular binary segmentation and z-scoring will be unweighted"
        )
        results_w = np.ones(len(results_w))
    ref_sizes = np.concatenate([sizes_a, sizes_g])

    null_aut = np.asarray(null_tables[0], dtype=np.float64)
    null_gon = np.asarray(null_tables[1], dtype=np.float64)[len(null_aut):]

    if len(results_r) != g_ml.n_masked:
        raise PredictError(
            f"Autosomal/gonosomal mask misalignment: combined results have "
            f"{len(results_r)} bins but the {ref_gender} mask holds "
            f"{g_ml.n_masked}. Rebuild the reference."
        )

    with stage_timer("predict.postprocess"):
        insufficient = ref_sizes < cfg.minrefbins

        def post(values):
            values = np.array(values)
            values[insufficient] = 0
            return g_ml.split_by_chr(g_ml.inflate(values))

        per_chr_r = post(results_r)
        per_chr_z = post(results_z)
        per_chr_w = post(results_w)
        if null_aut.shape[1] != null_gon.shape[1]:
            # Per-pass widths never mix downstream; NaN columns are masked
            # out of the segment z-score, so padding leaves it unchanged.
            width = max(null_aut.shape[1], null_gon.shape[1])

            def pad(a):
                out = np.full((a.shape[0], width), np.nan)
                out[:, : a.shape[1]] = a
                return out

            null_aut, null_gon = pad(null_aut), pad(null_gon)
        per_chr_nr = post(np.concatenate([null_aut, null_gon]))
        results = _log_trans(per_chr_r, per_chr_z, per_chr_w, per_chr_nr, m_lr)

    if cfg.blacklist:
        logging.info("Applying blacklist ...")
        _apply_blacklist(results, cfg.blacklist, ref_binsize)

    return BinResults(
        results_r=results[0], results_z=results[1], results_w=results[2],
        results_nr=results[3], ref_gender=ref_gender, gender=gender,
        binsize=ref_binsize, n_reads=n_reads, layout=g_ml.layout,
        masked_layout=g_ml,
    )


def segment_bins(bins: BinResults, cfg: PredictConfig, device: torch.device,
                 _device_stream: bool | None = None):
    """CBS segmentation + between-sample segment z-scores.  Returns rows
    ``[chr0, start, end, segment_z, ratio]``."""
    return segment_bins_batch([bins], cfg, device, _device_stream)[0]


def segment_bins_batch(all_bins: list, cfg: PredictConfig,
                       device: torch.device,
                       _device_stream: bool | None = None) -> list:
    """CBS and segment z-scores for a plate of samples: every pending
    segment of every sample joins the same permutation rounds.  Returns one
    :func:`segment_bins` row list per sample.  ``_device_stream`` overrides
    the permutation stream the device picks (see ``ops.cbs``)."""
    from wisecondorx_tpu_torch.ops import stats as stats_ops
    from wisecondorx_tpu_torch.ops import cbs as cbs_ops

    with stage_timer("predict.cbs"):
        cbs_cfg = cbs_ops.CBSConfig(
            alpha=cfg.alpha, seed=cfg.seed if cfg.seed is not None else 0
        )
        per_sample_c = cbs_ops.exec_cbs_batch(
            [(b.results_r, b.results_w, b.ref_gender, b.binsize)
             for b in all_bins],
            cbs_cfg, device=device, _device_stream=_device_stream,
        )
    out = []
    with stage_timer("predict.segment_z"):
        for bins, results_c in zip(all_bins, per_sample_c):
            segment_z = stats_ops.get_z_score(
                results_c, bins.results_r, bins.results_w, bins.results_nr
            )
            out.append([[row[0], row[1], row[2], segment_z[i], row[3]]
                        for i, row in enumerate(results_c)])
    return out


def predict(sample: dict, sample_binsize: int, ref: DeviceReference | None,
            cfg: PredictConfig = PredictConfig(),
            loader: ReferenceLoader | None = None):
    """Full prediction: (BinResults, segment rows).  ``ref`` or ``loader``
    supplies the tables, as in :func:`predict_bins`."""
    bins = predict_bins(sample, sample_binsize, ref, cfg, loader=loader)
    device = (loader.device if loader is not None
              else ref.tables["A"].sentinel_idx.device)
    return bins, segment_bins(bins, cfg, device)


def _log_trans(per_chr_r, per_chr_z, per_chr_w, per_chr_nr, m_lr):
    """log2-transform ratios, blank non-finite bins, recentre by m_lr."""
    out_r, out_z, out_w = [], [], []
    for r, z, w in zip(per_chr_r, per_chr_z, per_chr_w):
        with np.errstate(divide="ignore", invalid="ignore"):
            lr = np.log2(r)
        bad = ~np.isfinite(lr)
        lr[bad] = 0.0
        z = np.array(z)
        w = np.array(w)
        z[bad] = 0.0
        w[bad] = 0.0
        nonzero = lr != 0
        lr[nonzero] -= m_lr
        out_r.append(lr)
        out_z.append(z)
        out_w.append(w)
    return out_r, out_z, out_w, per_chr_nr


def _apply_blacklist(results, blacklist_path, binsize):
    """Zero r/z/w over blacklisted regions; malformed rows raise
    BedParseError with file:line."""
    from wisecondorx_tpu_torch.errors import BedParseError

    out_r, out_z, out_w, _ = results
    for lineno, line in enumerate(open(blacklist_path), 1):
        line = line.strip()
        if not line:
            continue
        fields = line.split("\t")
        if len(fields) < 3:
            raise BedParseError(
                f"{blacklist_path}:{lineno}: blacklist rows need 3 "
                f"tab-separated columns (chr, start, end); got {len(fields)}"
            )
        chr_name, s, e = fields[:3]
        if chr_name[:3].lower() == "chr":
            chr_name = chr_name[3:]
        chr_name = {"X": "23", "Y": "24"}.get(chr_name, chr_name)
        try:
            chrom = int(chr_name) - 1
            s, e = int(s), int(e)
        except ValueError:
            raise BedParseError(
                f"{blacklist_path}:{lineno}: cannot parse blacklist row "
                f"'{line}' (chr must be 1-22/X/Y, start/end integers)"
            ) from None
        if chrom >= len(out_r):
            continue
        for pos in range(int(s / binsize), int(e / binsize) + 1):
            if 0 <= pos < len(out_r[chrom]):
                out_r[chrom][pos] = 0
                out_z[chrom][pos] = 0
                out_w[chrom][pos] = 0
