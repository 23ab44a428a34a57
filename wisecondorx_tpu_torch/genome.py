"""Genome bin layout tables.

Copy of wisecondorx_tpu/genome.py (the port imports nothing of that
package); the two must agree, which tests/test_torch_host.py checks.

The reference tool threads ``bins_per_chr`` / ``masked_bins_per_chr`` /
``masked_bins_per_chr_cum`` lists through every stage and re-derives slices
with ad-hoc cumsum arithmetic (e.g. reference predict_control.py:22-29,
newref_control.py:60-66).  Here the layout is a single immutable struct with
the derived tables precomputed, so kernels receive plain integer arrays.

Chromosome convention (matches reference convert_tools.py:53-71): autosomes
"1".."22", X -> "23", Y -> "24"; internally chromosomes are 0-indexed arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np

#: Number of chromosomes tracked (1..22, X=23, Y=24).
NUM_CHROMOSOMES = 24

#: Last chromosome (1-based count) per reference-pass gender.
#: "A" = autosomes only, "F" = + chrX, "M" = + chrX + chrY
#: (reference newref_control.py:24-33).
LAST_CHR = {"A": 22, "F": 23, "M": 24}


@dataclasses.dataclass(frozen=True)
class GenomeLayout:
    """Unmasked bin layout: how many bins each chromosome spans.

    ``bins_per_chr[c]`` is the bin count of 0-indexed chromosome ``c``.
    """

    bins_per_chr: np.ndarray  # int64[n_chr]

    def __post_init__(self):
        object.__setattr__(
            self, "bins_per_chr", np.asarray(self.bins_per_chr, dtype=np.int64)
        )

    @property
    def n_chr(self) -> int:
        return len(self.bins_per_chr)

    @property
    def total_bins(self) -> int:
        return int(self.bins_per_chr.sum())

    @property
    def chr_starts(self) -> np.ndarray:
        """int64[n_chr] — global bin index where each chromosome starts."""
        return np.concatenate([[0], np.cumsum(self.bins_per_chr)[:-1]])

    @property
    def chr_ends(self) -> np.ndarray:
        """int64[n_chr] — exclusive global end index of each chromosome."""
        return np.cumsum(self.bins_per_chr)

    def chr_of_bin(self) -> np.ndarray:
        """int32[total_bins] — 0-indexed chromosome id of each global bin."""
        return np.repeat(
            np.arange(self.n_chr, dtype=np.int32), self.bins_per_chr
        )

    def truncated(self, last_chr: int) -> "GenomeLayout":
        """Layout restricted to the first ``last_chr`` chromosomes."""
        return GenomeLayout(self.bins_per_chr[:last_chr])


@dataclasses.dataclass(frozen=True)
class MaskedLayout:
    """Layout after the usability mask has been applied.

    Mirrors the reference npz keys ``mask`` / ``masked_bins_per_chr`` /
    ``masked_bins_per_chr_cum`` (reference newref_control.py:60-80) but also
    precomputes the per-masked-bin chromosome id and the translation from the
    reference's "own-chromosome-excluded" neighbour index space to global
    masked indices (see :meth:`neighbour_to_global`).
    """

    layout: GenomeLayout
    mask: np.ndarray  # bool[layout.total_bins]

    def __post_init__(self):
        mask = np.asarray(self.mask, dtype=bool)
        if mask.shape != (self.layout.total_bins,):
            raise ValueError(
                f"mask shape {mask.shape} != ({self.layout.total_bins},)"
            )
        object.__setattr__(self, "mask", mask)

    # -- derived tables ---------------------------------------------------

    @property
    def masked_bins_per_chr(self) -> np.ndarray:
        """int64[n_chr] — surviving bin count per chromosome."""
        ids = self.layout.chr_of_bin()
        return np.bincount(ids[self.mask], minlength=self.layout.n_chr).astype(
            np.int64
        )

    @property
    def masked_bins_per_chr_cum(self) -> np.ndarray:
        """int64[n_chr] — inclusive cumulative sum of masked bins."""
        return np.cumsum(self.masked_bins_per_chr)

    @property
    def n_masked(self) -> int:
        return int(self.mask.sum())

    @property
    def chr_of_masked_bin(self) -> np.ndarray:
        """int32[n_masked] — chromosome id of each masked (surviving) bin."""
        return self.layout.chr_of_bin()[self.mask]

    @property
    def masked_chr_starts(self) -> np.ndarray:
        """int64[n_chr] — first masked-space index of each chromosome."""
        cum = self.masked_bins_per_chr_cum
        return cum - self.masked_bins_per_chr

    # -- index space translation ------------------------------------------

    def neighbour_to_global(
        self, neighbour_idx: np.ndarray, row_start: int = 0
    ) -> np.ndarray:
        """Convert own-chromosome-excluded neighbour indexes to global ones.

        The reference searches neighbours in ``chr_data`` formed by
        concatenating all masked bins *before* and *after* the target bin's
        chromosome (reference newref_tools.py:192-199), so a stored index
        ``j`` for a target on chromosome ``c`` means global masked index
        ``j`` if ``j < start(c)`` else ``j + masked_bins_per_chr[c]``.

        Parameters
        ----------
        neighbour_idx : int[rows, k]
            Per-target-bin neighbour indexes in excluded space.  ``rows``
            is ``n_masked`` for a full table, or a tail slice starting at
            masked row ``row_start`` (the gonosomal passes only translate
            their chrX/chrY target rows).

        Returns
        -------
        int32[rows, k] global masked indexes.
        """
        neighbour_idx = np.asarray(neighbour_idx)
        rows = slice(row_start, row_start + len(neighbour_idx))
        starts = self.masked_chr_starts[self.chr_of_masked_bin[rows]]
        sizes = self.masked_bins_per_chr[self.chr_of_masked_bin[rows]]
        shift = (neighbour_idx >= starts[:, None]).astype(np.int8)
        return (
            neighbour_idx + shift * sizes[:, None]
        ).astype(np.int32)

    def inflate(self, values: np.ndarray, fill=0) -> np.ndarray:
        """Scatter masked-space values back onto the full bin axis.

        Equivalent of reference predict_tools.py:163-170 (``inflate_results``).
        """
        values = np.asarray(values)
        out = np.full(
            (self.layout.total_bins,) + values.shape[1:],
            fill,
            dtype=values.dtype if values.dtype.kind == "f" else float,
        )
        out[self.mask] = values
        return out

    def split_by_chr(self, full_values: np.ndarray) -> list:
        """Split a full-bin-axis array into per-chromosome arrays."""
        ends = self.layout.chr_ends
        return [
            full_values[s:e]
            for s, e in zip(self.layout.chr_starts, ends)
        ]


def samples_to_matrix(samples: list[dict], n_chr: int = NUM_CHROMOSOMES):
    """Stack per-chromosome count dicts into a dense [total_bins, n_samples].

    Chromosome lengths may differ between samples (the reference zero-pads to
    the longest, newref_tools.py:82-90); we do the same.

    Returns (matrix float64[total_bins, n_samples], GenomeLayout).
    """
    bins_per_chr = np.array(
        [
            max(len(s[str(c)]) for s in samples)
            for c in range(1, n_chr + 1)
        ],
        dtype=np.int64,
    )
    layout = GenomeLayout(bins_per_chr)
    mat = np.zeros((layout.total_bins, len(samples)), dtype=np.float64)
    starts = layout.chr_starts
    for si, s in enumerate(samples):
        for c in range(n_chr):
            arr = np.asarray(s[str(c + 1)])
            mat[starts[c] : starts[c] + len(arr), si] = arr
    return mat, layout
