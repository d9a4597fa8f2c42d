"""Host image helpers of the encode pipeline (counterpart of
hma_tpu/tokenizer/image_ops.py): center crop, the bilinear antialiased
resize and the [-1, 1] normalisation, numpy uint8 in and out, one frame at a
time on the CPU. The encoders run on the card."""

from __future__ import annotations

import numpy as np
import torch
from torch.nn import functional as F


def center_crop_to_square(img: np.ndarray) -> np.ndarray:
    """Crop the larger spatial dim symmetrically to a square (h, w, c)."""
    h, w = img.shape[:2]
    side = min(h, w)
    top = (h - side) // 2
    left = (w - side) // 2
    return img[top:top + side, left:left + side]


def resize_image(img: np.ndarray, target: int = 256, keep_res: bool = False,
                 max_res: int = 1024) -> np.ndarray:
    """Center-crop to square then resize to target² (or keep the side,
    capped at max_res, with `keep_res`). uint8 in, uint8 out.

    `jax.image.resize(method="bilinear")` is a triangle filter widened by
    the scale on a shrink (antialias) and plain bilinear interpolation on a
    stretch, with half-pixel centres: `F.interpolate(mode="bilinear",
    antialias=True, align_corners=False)` in fp32 computes the same. Both
    round half to even, so only ties that the two fp32 sums break
    differently can differ, by one level."""
    img = center_crop_to_square(img)
    side = img.shape[0]
    out = min(side if keep_res else target, max_res)
    if side == out:
        return img
    y = torch.from_numpy(resize_bilinear(img, out))
    return y.round().clamp(0, 255).to(torch.uint8).numpy()


def resize_bilinear(img: np.ndarray, out: int) -> np.ndarray:
    """(h, w, c) -> (out, out, c) float32 before rounding: the antialiased
    bilinear resize of `resize_image`."""
    x = torch.from_numpy(np.ascontiguousarray(img)).float().permute(2, 0, 1)[None]
    y = F.interpolate(x, size=(out, out), mode="bilinear", antialias=True,
                      align_corners=False)
    return y[0].permute(1, 2, 0).contiguous().numpy()


def normalize_image_np(img: np.ndarray) -> np.ndarray:
    """uint8 [0, 255] -> float32 [-1, 1]."""
    return img.astype(np.float32) / 127.5 - 1.0


def unnormalize_image_np(img: np.ndarray) -> np.ndarray:
    return np.clip((img + 1.0) * 127.5, 0, 255).astype(np.uint8)
