"""PCA between-sample normalization in Gram-matrix form.

Counterpart of wisecondorx_tpu/ops/pca.py.  With X the centred
samples x bins matrix, the top-k right singular vectors come from the k
principal eigenvectors of the small S x S Gram matrix ``X X^T``; each
sample is divided by its rank-k reconstruction.  The Gram product and the
correction are device matmuls; the S x S eigendecomposition stays in host
numpy float64, because another eigensolver can flip the signs of the
stored ``pca_components``.
"""

from __future__ import annotations

import numpy as np
import torch


def train_pca(data_bs: torch.Tensor, n_components: int = 5):
    """Fit PCA on [bins, samples] data and divide out the rank-k
    reconstruction.

    Returns (corrected [bins, samples] tensor on ``data_bs.device``,
    components [k, bins] numpy, mean [bins] numpy)."""
    x = data_bs.T  # [samples, bins]
    mean = x.mean(dim=0)
    xc = x - mean
    gram = xc @ xc.T
    _, eigvecs = np.linalg.eigh(gram.cpu().numpy().astype(np.float64))
    u = torch.as_tensor(
        np.ascontiguousarray(eigvecs[:, ::-1][:, :n_components]),
        dtype=x.dtype, device=x.device,
    )
    coeffs = u.T @ xc  # [k, bins]
    norms = torch.linalg.vector_norm(coeffs, dim=1, keepdim=True)
    components = coeffs / torch.where(norms > 0, norms, 1.0)
    reconstructed = u @ coeffs + mean
    corrected = (x / reconstructed).T.contiguous()
    return corrected, components.cpu().numpy(), mean.cpu().numpy()


def project_sample(sample_bins, components, mean):
    """Divide a test sample by its PCA reconstruction
    (``transform`` = (x - mean) @ components^T, plus the mean back)."""
    coeffs = (sample_bins - mean) @ components.T
    return sample_bins / (coeffs @ components + mean)
