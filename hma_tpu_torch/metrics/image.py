"""Pixel-space fidelity metrics: PSNR, SSIM, ΔPSNR (counterpart of
hma_tpu/metrics/image.py), as torch ops on an explicit device (the CPU
unless asked: decoded frames live on the host).

SSIM is skimage's (the reference scores with skimage): a 7x7 uniform window
over the "valid" region, K1 = 0.01, K2 = 0.03, covariances scaled by
NP / (NP - 1), the mean over pixels and channels. ΔPSNR is the
controllability probe: PSNR with ground-truth actions minus the mean PSNR of
random-action rollouts.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch.nn import functional as F


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).float()


def psnr(pred, target, data_range: float = 255.0, device="cpu") -> torch.Tensor:
    """PSNR over all elements of two broadcastable arrays, a 0-d tensor."""
    mse = torch.mean((_f32(pred, device) - _f32(target, device)) ** 2)
    return 10.0 * torch.log10(data_range**2 / torch.clamp(mse, min=1e-12))


def _uniform_filter(x: torch.Tensor, size: int) -> torch.Tensor:
    """Mean over size x size windows of each channel of (H, W, C), "valid"."""
    C = x.shape[-1]
    kernel = torch.full((C, 1, size, size), 1.0 / (size * size), device=x.device)
    return F.conv2d(x.permute(2, 0, 1)[None], kernel, groups=C)[0].permute(1, 2, 0)


def ssim(pred, target, data_range: float = 255.0, win_size: int = 7,
         k1: float = 0.01, k2: float = 0.03, device="cpu") -> torch.Tensor:
    """SSIM of one (H, W, C) image pair, a 0-d tensor."""
    x, y = _f32(pred, device), _f32(target, device)
    cov_norm = win_size**2 / (win_size**2 - 1)
    ux, uy = _uniform_filter(x, win_size), _uniform_filter(y, win_size)
    uxx, uyy = _uniform_filter(x * x, win_size), _uniform_filter(y * y, win_size)
    uxy = _uniform_filter(x * y, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    c1, c2 = (k1 * data_range) ** 2, (k2 * data_range) ** 2
    num = (2 * ux * uy + c1) * (2 * vxy + c2)
    den = (ux**2 + uy**2 + c1) * (vx + vy + c2)
    return torch.mean(num / den)


def batch_psnr(pred, target, data_range: float = 255.0, device="cpu") -> list[float]:
    """Per-image PSNR of (N, H, W, C) batches."""
    return [float(psnr(p, t, data_range, device)) for p, t in zip(pred, target)]


def batch_ssim(pred, target, data_range: float = 255.0, device="cpu") -> list[float]:
    """Per-image SSIM of (N, H, W, C) batches."""
    return [float(ssim(p, t, data_range, device=device)) for p, t in zip(pred, target)]


def delta_psnr(gt_action_psnr: float, random_action_psnrs: Sequence[float]) -> float:
    """Controllability: PSNR(gt actions) - mean PSNR(random actions)."""
    return float(gt_action_psnr) - float(np.mean(random_action_psnrs))
