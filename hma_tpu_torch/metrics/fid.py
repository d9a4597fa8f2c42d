"""FID (counterpart of hma_tpu/metrics/fid.py): the Fréchet distance between
Gaussians fitted to two feature sets, computed on the host with numpy and
scipy as pytorch-fid computes it (in an exact low-rank form where both sets
have fewer samples than dimensions), and the FID variant of InceptionV3
whose pool3 features (2048-d) it is taken over.

`InceptionV3FID` is NCHW with pytorch-fid's module names (`Mixed_5b.
branch5x5_2.conv.weight`, `...bn.running_var`), so its state dict is the
layout that `hma_tpu`'s `load_inception_torch_weights` reads: BasicConvs of
a bias-free conv, BatchNorm (eps 1e-3, running statistics) and ReLU; the
3x3 avg pools exclude their padding; the last block max-pools. The embedding
(`make_inception_embed_fn`) resizes uint8 frames bilinearly to 299² (with
antialiasing when it shrinks them, as `jax.image.resize` does), maps them to
[-1, 1] and runs the net in fp32 with TF32 off, on the CUDA card unless told
otherwise. Without weights the net is drawn from a seeded CPU generator
(conv weights N(0, 1 / fan_in), BatchNorm the identity), the same on every
device, whose values differ from `hma_tpu`'s random init by design.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional

import numpy as np
import torch
from scipy import linalg
from torch import nn
from torch.nn import functional as F

from hma_tpu_torch import resolve_device


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
    """The Fréchet distance of Gaussians fitted to (N, D) and (M, D) features.
    With fewer samples than dimensions on both sides (both covariances
    singular) it takes the exact low-rank form: the nonzero eigenvalues of
    s1 s2 = Xc^T Xc Yc^T Yc / (n m) are those of G G^T / (n m), G = Xc Yc^T,
    so tr sqrt(s1 s2) is G's singular values summed over sqrt(n m). That is
    O(N M D) where scipy's sqrtm is O(D^3): a d512 clip's flattened latents
    (D 12288) take hours through sqrtm. On such inputs the two forms agree to
    ~1e-7 relative."""
    x, y = np.asarray(pred_feats, np.float64), np.asarray(gt_feats, np.float64)
    if max(len(x), len(y)) >= x.shape[1]:
        return frechet_distance(*activation_statistics(pred_feats),
                                *activation_statistics(gt_feats))
    xc, yc = x - x.mean(axis=0), y - y.mean(axis=0)
    diff = x.mean(axis=0) - y.mean(axis=0)
    n, m = len(x) - 1, len(y) - 1
    trace_sqrt = np.linalg.svd(xc @ yc.T, compute_uv=False).sum() / math.sqrt(n * m)
    return float(diff.dot(diff) + (xc**2).sum() / n + (yc**2).sum() / m - 2 * trace_sqrt)


# ---------------------------------------------------------------------------
# The backbones' shared parts (metrics/fvd.py uses them too)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fp32_convs():
    """cuDNN's convolutions in full fp32 (no TF32) inside the block: the
    metrics are distances between feature statistics, which TF32's 10-bit
    mantissa would move."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def resize_bilinear(x: torch.Tensor, size: tuple) -> torch.Tensor:
    """(N, C, H, W) float -> (N, C, *size), `jax.image.resize(...,
    "bilinear")`: half-pixel centres, and antialiased where it shrinks the
    image (without it a downsample lands tens of levels off on [0, 255];
    with it an upsample drifts ~5e-4)."""
    shrink = size[0] < x.shape[-2] or size[1] < x.shape[-1]
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False, antialias=shrink)


@torch.no_grad()
def backbone(make: Callable[[], nn.Module], state_dict: Optional[dict], device,
             seed: int = 0) -> nn.Module:
    """The net `make()` builds, on `device` in fp32, eval mode: loaded from
    `state_dict`, or without one drawn on the CPU from a generator seeded
    `seed` (so one seed gives one net on every device): conv weights N(0, 1 /
    fan_in), conv biases 0, BatchNorm the identity. It is built on the meta
    device, so nothing is drawn twice. Keys of heads the net does not have
    (pytorch-fid's `fc`, the logits of an I3D file under the videogpt
    backend) are left out, as `hma_tpu`'s importers leave them; a key the
    net has and the file lacks raises."""
    with torch.device("meta"):
        model = make()
    model = model.to_empty(device=device)
    for mod in model.modules():  # to_empty leaves the BatchNorm buffers unset
        if isinstance(mod, nn.modules.batchnorm._BatchNorm):
            mod.reset_parameters()
    if state_dict is not None:
        missing = model.load_state_dict(state_dict, strict=False).missing_keys
        if missing:
            raise KeyError(f"the backbone's weights lack {len(missing)} keys, "
                           f"e.g. {missing[:3]}")
        return model.eval()
    generator = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.Conv3d)):
            w = mod.weight
            w.copy_(torch.randn(w.shape, generator=generator) / math.sqrt(w[0].numel()))
            if mod.bias is not None:
                mod.bias.zero_()
    return model.eval()


# ---------------------------------------------------------------------------
# InceptionV3, the FID variant
# ---------------------------------------------------------------------------

class BasicConv(nn.Module):
    """Bias-free conv, BatchNorm (eps 1e-3, running statistics), ReLU."""

    def __init__(self, c_in: int, c_out: int, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, kernel, stride=stride, padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(c_out, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _avg_pool(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, c_in: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv(c_in, 64, 1)
        self.branch5x5_1 = BasicConv(c_in, 48, 1)
        self.branch5x5_2 = BasicConv(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv(c_in, 64, 1)
        self.branch3x3dbl_2 = BasicConv(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv(96, 96, 3, padding=1)
        self.branch_pool = BasicConv(c_in, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3, self.branch_pool(_avg_pool(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, c_in: int):
        super().__init__()
        self.branch3x3 = BasicConv(c_in, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv(c_in, 64, 1)
        self.branch3x3dbl_2 = BasicConv(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionC(nn.Module):
    def __init__(self, c_in: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv(c_in, 192, 1)
        self.branch7x7_1 = BasicConv(c_in, c7, 1)
        self.branch7x7_2 = BasicConv(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv(c_in, c7, 1)
        self.branch7x7dbl_2 = BasicConv(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv(c_in, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avg_pool(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, c_in: int):
        super().__init__()
        self.branch3x3_1 = BasicConv(c_in, 192, 1)
        self.branch3x3_2 = BasicConv(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv(c_in, 192, 1)
        self.branch7x7x3_2 = BasicConv(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv(192, 192, 3, stride=2)

    def forward(self, x):
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([self.branch3x3_2(self.branch3x3_1(x)), b7,
                          F.max_pool2d(x, 3, stride=2)], 1)


class InceptionE(nn.Module):
    """`pool`: "avg" (Mixed_7b) or "max" (Mixed_7c, 3x3 stride 1 padded 1)."""

    def __init__(self, c_in: int, pool: str = "avg"):
        super().__init__()
        self.pool = pool
        self.branch1x1 = BasicConv(c_in, 320, 1)
        self.branch3x3_1 = BasicConv(c_in, 384, 1)
        self.branch3x3_2a = BasicConv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv(c_in, 448, 1)
        self.branch3x3dbl_2 = BasicConv(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv(c_in, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        bp = _avg_pool(x) if self.pool == "avg" else F.max_pool2d(x, 3, stride=1, padding=1)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], 1)


class InceptionV3FID(nn.Module):
    """(B, 3, 299, 299) in [-1, 1] -> (B, 2048) pool3 features."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048, pool="max")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, stride=2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, stride=2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                     "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))


def inception_inputs(images: torch.Tensor) -> torch.Tensor:
    """uint8 (N, H, W, 3) -> the net's (N, 3, 299, 299) input in [-1, 1]."""
    x = resize_bilinear(images.permute(0, 3, 1, 2).float(), (299, 299))
    return x / 127.5 - 1.0


def make_inception_embed_fn(state_dict: Optional[dict] = None, batch_size: int = 32,
                            device=None, seed: int = 0) -> Callable[[np.ndarray], np.ndarray]:
    """Returns embed(images uint8 (N, H, W, 3), numpy) -> (N, 2048) fp32
    numpy pool3 features, in batches of `batch_size` on `device` (the CUDA
    card unless told otherwise). The net loads `state_dict` (pytorch-fid's
    layout) or, without one, is drawn from `seed`."""
    device = resolve_device(device)
    model = backbone(InceptionV3FID, state_dict, device, seed)

    @torch.no_grad()
    def embed(images: np.ndarray) -> np.ndarray:
        out = []
        with fp32_convs():
            for i in range(0, len(images), batch_size):
                chunk = torch.from_numpy(np.asarray(images[i:i + batch_size])).to(device)
                out.append(model(inception_inputs(chunk)).cpu().numpy())
        return np.concatenate(out)

    return embed


def calculate_fid(pred_images: np.ndarray, gt_images: np.ndarray,
                  embed_fn: Optional[Callable] = None, device=None) -> float:
    """FID of two uint8 image batches (N, H, W, 3) under `embed_fn(images) ->
    (N, D)`, by default the InceptionV3 embedding on `device`."""
    embed_fn = embed_fn or make_inception_embed_fn(device=device)
    return fid_from_features(embed_fn(pred_images), embed_fn(gt_images))
