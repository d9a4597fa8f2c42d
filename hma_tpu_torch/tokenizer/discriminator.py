"""PatchGAN discriminator for tokenizer GAN training (counterpart of
hma_tpu/tokenizer/discriminator.py).

`NLayerDiscriminator` in the reference's state-dict layout (a `main`
Sequential: 4x4 convs padded (1, 1), stride 2 but for the last two,
BatchNorm and LeakyReLU(0.2), one-channel patch logits). Its BatchNorm is
flax's: in training it normalizes by the batch mean and the biased batch
variance E[x²] - E[x]² (clipped at 0), and moves the running statistics
by 0.1 of the way toward them, the running variance toward the *biased*
variance (torch's BatchNorm2d moves it toward the unbiased one); in
evaluation it reads the running statistics. Conv weights are drawn N(0,
0.02), BatchNorm scales N(1, 0.02), biases 0.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d with flax's statistics (momentum 0.9 in flax's terms)."""

    def __init__(self, channels: int, device=None):
        super().__init__(channels, eps=1e-5, momentum=0.1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
            with torch.no_grad():
                self.running_mean.lerp_(mean, self.momentum)
                self.running_var.lerp_(var, self.momentum)
                self.num_batches_tracked += 1
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]


class NLayerDiscriminator(nn.Module):
    """x (B, input_nc, H, W) in [-1, 1] -> (B, 1, H', W') patch logits, fp32."""

    def __init__(self, input_nc: int = 3, ndf: int = 64, n_layers: int = 3, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        layers = [nn.Conv2d(input_nc, ndf, 4, 2, 1, device=device), nn.LeakyReLU(0.2)]
        mult = 1
        for n in range(1, n_layers + 1):
            prev, mult = mult, min(2**n, 8)
            stride = 2 if n < n_layers else 1
            layers += [nn.Conv2d(ndf * prev, ndf * mult, 4, stride, 1, bias=False,
                                 device=device),
                       BatchNorm(ndf * mult, device), nn.LeakyReLU(0.2)]
        layers.append(nn.Conv2d(ndf * mult, 1, 4, 1, 1, device=device))
        self.main = nn.Sequential(*layers)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for mod in self.main:
            if isinstance(mod, nn.Conv2d):
                mod.weight.copy_(0.02 * torch.randn(mod.weight.shape, generator=generator))
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, BatchNorm):
                mod.weight.copy_(1.0 + 0.02 * torch.randn(mod.weight.shape,
                                                          generator=generator))
                mod.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.main(x)

