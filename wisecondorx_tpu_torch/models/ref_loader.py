"""Reference tables for the predict stage, placed on a device.

Counterpart of wisecondorx_tpu/models/ref_loader.py, in-memory path only.
A reference -- the ``.npz`` written by either package, or the pass dicts
:func:`wisecondorx_tpu_torch.models.reference.build_reference` (or the
JAX package's) returns -- becomes one :class:`PassTables` per pass: the
neighbour indexes translated to global masked space with the distance
cutoff folded in as -1 sentinels, and the PCA components and mean, all
as tensors on the device; the weights stay host float64.

The translation runs in numpy (the JAX package's fallback path; its
native ``tablekit`` is not used).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from wisecondorx_tpu.genome import GenomeLayout, MaskedLayout
from wisecondorx_tpu.io.npz import load_reference_npz
from wisecondorx_tpu_torch.device import work_dtype
from wisecondorx_tpu_torch.ops import normalize as norm_ops


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


def build_pass_tables(ref_pass: dict, gender: str, cutoff: float,
                      device: torch.device,
                      a_pass: dict | None = None) -> PassTables:
    """PassTables of one in-memory pass dict.

    When ``a_pass`` (the autosomal pass, whose distances set the cutoff)
    caches the cutoff schedule and ``cutoff`` is its maskrepeats-5 value,
    the ``wcx_distok`` bits serve the cutoff decision; the
    cutoff-independent ``wcx_weights`` serve at every depth."""
    ct = pass_ct(ref_pass, gender)
    ml = MaskedLayout(
        GenomeLayout(np.asarray(ref_pass["bins_per_chr"])),
        np.asarray(ref_pass["mask"], dtype=bool),
    )
    idx = np.asarray(ref_pass["indexes"])[ct:]
    cutoffs = np.atleast_1d(
        a_pass.get("wcx_cutoffs", []) if a_pass is not None else []
    )
    dist = None
    if len(cutoffs) >= 5 and cutoff == float(cutoffs[4]) and "wcx_distok" in ref_pass:
        sent = translate_with_okbits(
            idx, np.asarray(ref_pass["wcx_distok"])[ct:], ml, ct
        )
    else:
        dist = np.asarray(ref_pass["distances"])[ct:]
        sent = translate_and_mask(idx, dist, ml, ct, cutoff)
    if "wcx_weights" in ref_pass:
        weights = np.asarray(ref_pass["wcx_weights"], np.float64)[ct:]
    else:
        if dist is None:
            dist = np.asarray(ref_pass["distances"])[ct:]
        weights = norm_ops.get_weights(dist)
    dtype = work_dtype(device)
    return PassTables(
        sentinel_idx=torch.as_tensor(sent.astype(np.int64), device=device),
        components=torch.as_tensor(
            np.asarray(ref_pass["pca_components"]), dtype=dtype, device=device
        ),
        mean=torch.as_tensor(
            np.asarray(ref_pass["pca_mean"]), dtype=dtype, device=device
        ),
        weights=weights,
        ml=ml,
        ct=ct,
    )


def load_reference(source, device: torch.device,
                   maskrepeats: int = 5) -> DeviceReference:
    """Place a reference on ``device`` for predict.

    ``source`` is a reference ``.npz`` path (written by either package)
    or a ``(passes, meta)`` pair of numpy pass dicts as ``build_reference``
    returns them.  The distance cutoff always derives from the autosomal
    pass, for the gonosomal passes too (a quirk of the reference)."""
    if isinstance(source, tuple):
        passes, meta = source
    else:
        passes, meta = load_reference_npz(source)
    a_pass = passes["A"]
    cached = np.atleast_1d(a_pass.get("wcx_cutoffs", []))
    if maskrepeats <= 0:
        cutoff = float("inf")
    elif maskrepeats <= len(cached):
        cutoff = float(cached[maskrepeats - 1])
    else:
        cutoff = norm_ops.get_optimal_cutoff(
            np.asarray(a_pass["distances"]), maskrepeats
        )
    tables = {
        g: build_pass_tables(p, g, cutoff, device, a_pass=a_pass)
        for g, p in passes.items()
    }
    return DeviceReference(passes=passes, meta=meta, tables=tables,
                           cutoff=cutoff)
