"""LPIPS perceptual distance with VGG16 and AlexNet backbones (counterpart
of hma_tpu/metrics/lpips.py): VGG16 LPIPS is the tokenizer's perceptual
loss, AlexNet LPIPS the trainer's rollout metric.

NCHW modules in the `lpips` package's state-dict layout: the trunk's convs
under `net.slice{k}.{i}` (i the torchvision `features` index) and the
linear heads under `lin{l}.model.1.weight`; `load_lpips_torch_weights` also
takes the newer `lins.{l}.model.1.weight` form, as hma_tpu's loader does.
The numerics are hma_tpu's: the scaling layer (x - shift) / scale in fp32,
the 2x2 (VGG) and 3x3 stride-2 (AlexNet) max pools without padding, each
tap divided by its channel norm plus 1e-10, and the heads' means over the
pixels summed. Without weights the trunk is drawn from a seed and the heads
are ones (hma_tpu's init). On the card the convs run in full fp32 (TF32
off), as the FID and FVD backbones do.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from hma_tpu_torch import resolve_device
from hma_tpu_torch.metrics.fid import fp32_convs

# ImageNet scaling layer constants (lpips ScalingLayer)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512, "M"]
# torchvision `features` indices where each LPIPS slice of VGG16 ends (after
# relu1_2, relu2_2, relu3_3, relu4_3, relu5_3)
VGG16_SLICES = (4, 9, 16, 23, 30)
VGG16_CHANNELS = (64, 128, 256, 512, 512)
ALEX_SLICES = (2, 5, 8, 10, 12)
ALEX_CHANNELS = (64, 192, 384, 256, 256)


def _vgg16_layers() -> list[nn.Module]:
    """torchvision's vgg16 `features` up to its last ReLU (30 modules)."""
    layers, c_in = [], 3
    for v in VGG16_CFG:
        if v == "M":
            layers.append(nn.MaxPool2d(2, 2))
        else:
            layers += [nn.Conv2d(c_in, v, 3, padding=1), nn.ReLU()]
            c_in = v
    return layers[:VGG16_SLICES[-1]]


def _alexnet_layers() -> list[nn.Module]:
    """torchvision's alexnet `features` up to its last ReLU (12 modules)."""
    return [nn.Conv2d(3, 64, 11, stride=4, padding=2), nn.ReLU(), nn.MaxPool2d(3, 2),
            nn.Conv2d(64, 192, 5, padding=2), nn.ReLU(), nn.MaxPool2d(3, 2),
            nn.Conv2d(192, 384, 3, padding=1), nn.ReLU(),
            nn.Conv2d(384, 256, 3, padding=1), nn.ReLU(),
            nn.Conv2d(256, 256, 3, padding=1), nn.ReLU()]


class Trunk(nn.Module):
    """The backbone as five slices, `slice{k}` holding the torchvision
    modules of its index range under their own indices; returns each
    slice's output (the LPIPS taps)."""

    def __init__(self, layers: list[nn.Module], ends: tuple):
        super().__init__()
        start = 0
        for k, end in enumerate(ends, 1):
            part = nn.Sequential()
            for i in range(start, end):
                part.add_module(str(i), layers[i])
            setattr(self, f"slice{k}", part)
            start = end
        self.n = len(ends)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        taps = []
        for k in range(1, self.n + 1):
            x = getattr(self, f"slice{k}")(x)
            taps.append(x)
        return taps


class LinearHead(nn.Module):
    """`lin{l}`: a 1x1 conv to one channel without bias, at `model.1` (the
    lpips package keeps a dropout at `model.0`, off in evaluation)."""

    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.Sequential(nn.Identity(), nn.Conv2d(channels, 1, 1, bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


def _normalize_tensor(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """x over its channel norm plus eps (eps outside the sqrt)."""
    return x / (torch.sqrt(torch.sum(x**2, dim=1, keepdim=True)) + eps)


class LPIPS(nn.Module):
    """d(x, y) = sum_l mean_hw(lin_l((nx_l - ny_l)^2)); x, y (B, 3, H, W) in
    [-1, 1] -> (B,) fp32. net: "vgg" (the tokenizer's loss) or "alex" (the
    rollout metric)."""

    def __init__(self, net: str = "vgg", device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if net not in ("vgg", "alex"):
            raise ValueError(f"LPIPS net {net!r}: 'vgg' or 'alex'")
        vgg = net == "vgg"
        self.net = Trunk(_vgg16_layers() if vgg else _alexnet_layers(),
                         VGG16_SLICES if vgg else ALEX_SLICES)
        for i, c in enumerate(VGG16_CHANNELS if vgg else ALEX_CHANNELS):
            setattr(self, f"lin{i}", LinearHead(c))
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1), persistent=False)
        self.to(resolve_device(device))
        self.reset_parameters(generator)
        self.eval()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Trunk conv weights N(0, 1 / fan_in), drawn in fp32 on the CPU (one
        seed gives one net on every device), biases 0; the heads ones."""
        for mod in self.net.modules():
            if isinstance(mod, nn.Conv2d):
                w = mod.weight
                fan_in = w.shape[1] * w.shape[2] * w.shape[3]
                w.copy_(torch.randn(w.shape, generator=generator) / math.sqrt(fan_in))
                mod.bias.zero_()
        for i in range(self.net.n):
            getattr(self, f"lin{i}").model[1].weight.fill_(1.0)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        with fp32_convs():
            fx = self.net((x.float() - self.shift) / self.scale)
            fy = self.net((y.float() - self.shift) / self.scale)
            total = 0.0
            for i, (a, b) in enumerate(zip(fx, fy)):
                diff = (_normalize_tensor(a) - _normalize_tensor(b)) ** 2
                total = total + getattr(self, f"lin{i}")(diff).mean(dim=(1, 2, 3))
        return total


def load_lpips_torch_weights(model: LPIPS, state_dict: dict) -> LPIPS:
    """Load an `lpips` package state dict (`net.slice*` convs and
    `lin{l}.model.1.weight` or `lins.{l}.model.1.weight` heads) into `model`
    and return it. Keys outside `net.` and the heads (the scaling layer's
    buffers) are ignored, as hma_tpu ignores them; a trunk or head key that
    is missing or does not fit raises."""
    picked = {}
    for k, v in state_dict.items():
        if k.startswith("lins."):
            k = "lin" + k[len("lins."):]
        if k.startswith("net.") or (k.startswith("lin") and ".model.1." in k):
            picked[k] = torch.as_tensor(v).float()
    model.load_state_dict(picked, strict=True)
    return model


def make_lpips_fn(state_dict: Optional[dict] = None, net: str = "vgg", device=None):
    """Returns lpips(x, y) -> (B,) fp32 numpy distances of two (B, H, W, 3)
    uint8 batches (numpy or tensors), mapped to [-1, 1] on `device` (the card
    unless told otherwise). Without `state_dict` the trunk is drawn from seed
    0 and the heads are ones."""
    model = LPIPS(net, device=device, generator=torch.Generator().manual_seed(0))
    if state_dict is not None:
        load_lpips_torch_weights(model, state_dict)
    dev = model.shift.device

    def to_pm1(img) -> torch.Tensor:
        return (torch.as_tensor(img).to(dev).float() / 127.5 - 1.0).permute(0, 3, 1, 2)

    @torch.no_grad()
    def run(x, y) -> np.ndarray:
        return model(to_pm1(x), to_pm1(y)).cpu().numpy()

    return run
