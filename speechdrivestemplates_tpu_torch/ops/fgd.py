"""Frechet Gesture Distance between two sets of pose-encoder latents.

The port's copy of the JAX package's ``ops/fgd.py`` (the reference's
``core/utils/fgd.py``, the standard stable FID computation): Gaussian fits of
the latents, then d^2 = ||mu1 - mu2||^2 + Tr(C1 + C2 - 2 sqrt(C1 C2)), in
float64 on the host with ``scipy.linalg.sqrtm``. It is an epoch-level metric,
not a step op. Without scipy it raises: there is no other route.
"""

from __future__ import annotations

import numpy as np


def calculate_frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    from scipy import linalg

    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    if mu1.shape != mu2.shape or sigma1.shape != sigma2.shape:
        raise ValueError(f"latent sets of different widths: {mu1.shape} vs {mu2.shape}")
    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        # a near-singular product: jitter the diagonals (reference fgd.py:39-45)
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def compute_fgd(a: np.ndarray, b: np.ndarray) -> float:
    """FGD between two latent sets, each (N, D)."""
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return calculate_frechet_distance(a.mean(0), np.cov(a, rowvar=False),
                                      b.mean(0), np.cov(b, rowvar=False))
