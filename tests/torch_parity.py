"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Importing this module caps torch at one thread: the suite runs under
pytest-xdist with several workers, and each worker's torch would
otherwise start one thread per core."""

import numpy as np
import torch

torch.set_num_threads(1)

CPU = torch.device("cpu")


def layout(bins_per_chr):
    """(masked_chr_starts, chr_of_bin) of a layout with every bin kept."""
    bins_per_chr = np.asarray(bins_per_chr)
    starts = np.concatenate([[0], np.cumsum(bins_per_chr)[:-1]]).astype(np.int64)
    chr_of_bin = np.repeat(np.arange(len(bins_per_chr)), bins_per_chr).astype(np.int32)
    return starts, chr_of_bin


def t64(a):
    """numpy -> float64 CPU tensor."""
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def null_chooser(gender, n):
    """The seeded null-sample draw both packages use by default (seed 3)."""
    return np.random.default_rng([3, ord(gender)]).choice(
        n, size=min(n, 100), replace=False
    )
