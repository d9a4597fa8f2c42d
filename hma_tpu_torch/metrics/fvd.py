"""FVD (counterpart of hma_tpu/metrics/fvd.py): the Fréchet distance between
the I3D embeddings of two video batches at the full clip length, the value
the reference's sweep over clip lengths >= 10 ends on, with both of the
reference's I3D variants:

  - "videogpt": the 1024-d globally pooled features, frames resized straight
    to `resize`²;
  - "styleganv" (the reference default): the 400-d Kinetics logits head
    (avg pool (2, 7, 7), a 1x1x1 conv with bias, the mean over what is left
    of time and space), frames resized so that the shorter side is `resize`
    (the other rounded up), then centre-cropped.

`InceptionI3D` is NCTHW with the torch i3d module names (`Mixed_3b.b1b.
conv3d.weight`, `...bn.running_mean`, `logits.conv3d.bias`), the layout
that `hma_tpu`'s `load_i3d_torch_weights` reads. Every conv and max pool pads
TF-style "SAME" from its input's size: total = max((ceil(n / s) - 1) s + k
- n, 0), total // 2 before and the rest after (asymmetric at stride 2, which
`nn.Conv3d`'s padding cannot express); pools pad with -inf. The embedding
runs in fp32 with TF32 off, on the CUDA card unless told otherwise.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from hma_tpu_torch import resolve_device
from hma_tpu_torch.metrics.fid import backbone, fid_from_features, fp32_convs, resize_bilinear

BACKENDS = ("videogpt", "styleganv")


def pad_same(x: torch.Tensor, kernel, stride, value: float = 0.0) -> torch.Tensor:
    """(B, C, T, H, W) padded for a TF "SAME" window of `kernel` / `stride`."""
    pads = []
    for n, k, s in zip(reversed(x.shape[2:]), reversed(kernel), reversed(stride)):
        total = max((math.ceil(n / s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads, value=value)


def max_pool_same(x: torch.Tensor, kernel, stride) -> torch.Tensor:
    return F.max_pool3d(pad_same(x, kernel, stride, -math.inf), kernel, stride)


class Unit3D(nn.Module):
    """SAME-padded conv3d, then (but for the logits head) BatchNorm (eps
    1e-3, running statistics) and ReLU."""

    def __init__(self, c_in: int, c_out: int, kernel=(1, 1, 1), stride=(1, 1, 1),
                 head: bool = False):
        super().__init__()
        self.kernel, self.stride, self.head = kernel, stride, head
        self.conv3d = nn.Conv3d(c_in, c_out, kernel, stride, bias=head)
        if not head:
            self.bn = nn.BatchNorm3d(c_out, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv3d(pad_same(x, self.kernel, self.stride))
        return x if self.head else F.relu(self.bn(x))


class InceptionI3DBlock(nn.Module):
    """Four branches: 1x1x1; 1x1x1 then 3x3x3; 1x1x1 then 3x3x3; a 3x3x3
    max pool then 1x1x1. channels: (b0, b1a, b1b, b2a, b2b, b3b)."""

    def __init__(self, c_in: int, channels: tuple):
        super().__init__()
        c = channels
        self.b0 = Unit3D(c_in, c[0])
        self.b1a = Unit3D(c_in, c[1])
        self.b1b = Unit3D(c[1], c[2], (3, 3, 3))
        self.b2a = Unit3D(c_in, c[3])
        self.b2b = Unit3D(c[3], c[4], (3, 3, 3))
        self.b3b = Unit3D(c_in, c[5])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pool = max_pool_same(x, (3, 3, 3), (1, 1, 1))
        return torch.cat([self.b0(x), self.b1b(self.b1a(x)), self.b2b(self.b2a(x)),
                          self.b3b(pool)], 1)


_MIXED = {"Mixed_3b": (192, (64, 96, 128, 16, 32, 32)),
          "Mixed_3c": (256, (128, 128, 192, 32, 96, 64)),
          "Mixed_4b": (480, (192, 96, 208, 16, 48, 64)),
          "Mixed_4c": (512, (160, 112, 224, 24, 64, 64)),
          "Mixed_4d": (512, (128, 128, 256, 24, 64, 64)),
          "Mixed_4e": (512, (112, 144, 288, 32, 64, 64)),
          "Mixed_4f": (528, (256, 160, 320, 32, 128, 128)),
          "Mixed_5b": (832, (256, 160, 320, 32, 128, 128)),
          "Mixed_5c": (832, (384, 192, 384, 48, 128, 128))}
# the max pools before these blocks: (kernel, stride)
_POOL_BEFORE = {"Mixed_3b": ((1, 3, 3), (1, 2, 2)), "Mixed_4b": ((3, 3, 3), (2, 2, 2)),
                "Mixed_5b": ((2, 2, 2), (2, 2, 2))}


class InceptionI3D(nn.Module):
    """Kinetics-400 I3D on (B, 3, T, H, W) in [-1, 1]: (B, 1024) pooled
    features with `num_classes=None` (videogpt), (B, num_classes) logits
    otherwise (styleganv; its avg pool needs H, W >= 193 and T >= 9)."""

    def __init__(self, num_classes: Optional[int] = None):
        super().__init__()
        self.Conv3d_1a_7x7 = Unit3D(3, 64, (7, 7, 7), (2, 2, 2))
        self.Conv3d_2b_1x1 = Unit3D(64, 64)
        self.Conv3d_2c_3x3 = Unit3D(64, 192, (3, 3, 3))
        for name, (c_in, channels) in _MIXED.items():
            setattr(self, name, InceptionI3DBlock(c_in, channels))
        if num_classes is not None:
            self.logits = Unit3D(1024, num_classes, head=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = max_pool_same(self.Conv3d_1a_7x7(x), (1, 3, 3), (1, 2, 2))
        x = self.Conv3d_2c_3x3(self.Conv3d_2b_1x1(x))
        for name in _MIXED:
            if name in _POOL_BEFORE:
                x = max_pool_same(x, *_POOL_BEFORE[name])
            x = getattr(self, name)(x)
        if hasattr(self, "logits"):
            x = self.logits(F.avg_pool3d(x, (2, 7, 7), stride=1))
        return x.mean(dim=(2, 3, 4))


def i3d_inputs(videos: torch.Tensor, resize: int, backend: str) -> torch.Tensor:
    """uint8 (N, T, H, W, 3) -> the net's (N, 3, T, resize, resize) input
    in [-1, 1]: straight resize (videogpt) or shorter side to `resize` and
    a centre crop (styleganv)."""
    N, T, H, W, _ = videos.shape
    if backend == "styleganv":
        scale = resize / min(H, W)
        th, tw = (resize, math.ceil(W * scale)) if H < W else (math.ceil(H * scale), resize)
    else:
        th = tw = resize
    x = resize_bilinear(videos.flatten(0, 1).permute(0, 3, 1, 2).float(), (th, tw))
    h0, w0 = (th - resize) // 2, (tw - resize) // 2
    x = x[:, :, h0:h0 + resize, w0:w0 + resize] / 127.5 - 1.0
    return x.reshape(N, T, 3, resize, resize).transpose(1, 2)


def make_i3d_embed_fn(state_dict: Optional[dict] = None, batch_size: int = 8,
                      resize: int = 224, backend: str = "videogpt", device=None,
                      seed: int = 0) -> Callable[[np.ndarray], np.ndarray]:
    """Returns embed(videos uint8 (N, T, H, W, 3), numpy) -> (N, 1024)
    (videogpt) or (N, 400) (styleganv) fp32 numpy, in batches of
    `batch_size` on `device` (the CUDA card unless told otherwise). The net
    loads `state_dict` (the torch i3d layout) or, without one, is drawn from
    `seed`."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    device = resolve_device(device)
    num_classes = 400 if backend == "styleganv" else None
    model = backbone(lambda: InceptionI3D(num_classes), state_dict, device, seed)

    @torch.no_grad()
    def embed(videos: np.ndarray) -> np.ndarray:
        out = []
        with fp32_convs():
            for i in range(0, len(videos), batch_size):
                chunk = torch.from_numpy(np.asarray(videos[i:i + batch_size])).to(device)
                out.append(model(i3d_inputs(chunk, resize, backend)).cpu().numpy())
        return np.concatenate(out)

    return embed


def calculate_fvd(pred_videos: np.ndarray, gt_videos: np.ndarray,
                  embed_fn: Optional[Callable] = None, backend: str = "videogpt",
                  i3d_state_dict: Optional[dict] = None, device=None) -> float:
    """(N, T, ...) batches, T >= 10 -> the Fréchet distance of their
    embeddings under `embed_fn(videos) -> (N, D)`, by default the `backend`
    I3D (weights `i3d_state_dict`, else drawn from a seed) on uint8 (N, T, H,
    W, 3) videos on `device`."""
    if pred_videos.shape[1] < 10:
        raise ValueError(f"FVD needs clips of >= 10 frames, got {pred_videos.shape[1]}")
    embed_fn = embed_fn or make_i3d_embed_fn(i3d_state_dict, backend=backend, device=device)
    return float(fid_from_features(embed_fn(pred_videos), embed_fn(gt_videos)))
