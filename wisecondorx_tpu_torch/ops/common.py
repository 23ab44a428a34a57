"""Masked reductions over fixed-shape tensors plus a validity mask.

Counterpart of wisecondorx_tpu/ops/common.py.  Empty selections give NaN,
as numpy's reductions over empty arrays do.
"""

from __future__ import annotations

import torch


def masked_mean(x, valid, dim=-1):
    """Mean over ``valid`` lanes; NaN where no lane is valid."""
    n = valid.sum(dim=dim)
    s = torch.where(valid, x, 0.0).sum(dim=dim)
    return s / n  # 0/0 -> NaN, like np.mean of an empty slice


def masked_std(x, valid, dim=-1):
    """Population std (ddof=0) over valid lanes; NaN if empty."""
    n = valid.sum(dim=dim)
    mean = masked_mean(x, valid, dim=dim)
    d = torch.where(valid, x - mean.unsqueeze(dim), 0.0)
    return torch.sqrt((d * d).sum(dim=dim) / n)


def masked_median(x, valid, dim=-1):
    """Median over valid lanes with numpy semantics; NaN if empty.

    ``torch.median`` returns the lower middle of an even count, numpy the
    mean of the two middles: sort with invalid lanes pushed to +inf and
    average the two middle order statistics of the valid prefix."""
    s = torch.where(valid, x, torch.inf).sort(dim=dim).values
    n = valid.sum(dim=dim)
    k = x.shape[dim]
    lo_idx = ((n - 1) // 2).clamp(0, k - 1).unsqueeze(dim)
    hi_idx = (n // 2).clamp(0, k - 1).unsqueeze(dim)
    lo = s.gather(dim, lo_idx).squeeze(dim)
    hi = s.gather(dim, hi_idx).squeeze(dim)
    return torch.where(n > 0, (lo + hi) * 0.5, torch.nan)


def median(x, dim=-1):
    """Plain median (all lanes valid), averaging the two middles."""
    return masked_median(x, torch.ones_like(x, dtype=torch.bool), dim=dim)


def nanmedian(x, dim=-1):
    """Median of the non-NaN entries of ``x`` along ``dim``, averaging the
    two middles like ``np.nanmedian``; NaN when every entry is NaN."""
    return masked_median(x, ~torch.isnan(x), dim=dim)
