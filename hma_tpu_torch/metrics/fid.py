"""FID statistics (counterpart of hma_tpu/metrics/fid.py, its distance
half): the Fréchet distance between Gaussians fitted to two feature sets,
computed on the host with numpy and scipy, as pytorch-fid computes it.

The InceptionV3 backbone that turns images into pool3 features is not
ported yet (ROADMAP.md Queue A, item 6): `calculate_fid` takes an `embed_fn`
and raises without one.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
from scipy import linalg

_BACKBONES = ("the {} backbone is not ported yet (ROADMAP.md Queue A, item 6: "
              "metrics/{{lpips,fid,fvd}}.py); pass embed_fn")


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """||mu1 - mu2||^2 + tr(s1 + s2 - 2 sqrt(s1 s2)), with `eps` added to
    the diagonals when the product's square root is not finite."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def activation_statistics(feats: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Mean and sample covariance of (N, D) features."""
    return np.mean(feats, axis=0), np.cov(feats, rowvar=False)


def fid_from_features(pred_feats: np.ndarray, gt_feats: np.ndarray) -> float:
    return frechet_distance(*activation_statistics(pred_feats),
                            *activation_statistics(gt_feats))


def calculate_fid(pred_images: np.ndarray, gt_images: np.ndarray,
                  embed_fn: Optional[Callable] = None) -> float:
    """FID of two image batches under `embed_fn(images) -> (N, D)`."""
    if embed_fn is None:
        raise NotImplementedError(_BACKBONES.format("InceptionV3"))
    return fid_from_features(embed_fn(pred_images), embed_fn(gt_images))
