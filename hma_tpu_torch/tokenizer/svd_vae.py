"""SVD temporal VAE, diffusers' AutoencoderKLTemporalDecoder (counterpart of
hma_tpu/tokenizer/svd_vae.py): the SD-VAE encoder (frames to the latent
mean, 4 channels at /8) and the temporal decoder (spatial resnets mixed with
(3, 1, 1) frame-axis resnets by a learned AlphaBlender, then a (3, 1, 1)
`time_conv_out`), which turns the continuous family's latents into pixels.

NCHW modules whose state-dict keys and shapes are the diffusers checkpoint's
(`encoder.down_blocks.<i>.resnets.<j>.conv1.weight`,
`decoder.up_blocks.<i>.resnets.<j>.temporal_res_block.conv1.weight`
(O, I, 3, 1, 1), `...time_mixer.mix_factor`, `...attentions.0.to_out.0`,
`quant_conv`), so a released state dict loads with `load_state_dict`. The
numerics are `hma_tpu`'s: GroupNorm(min(32, C), eps 1e-6) in fp32 and the
SiLU after it in fp32, then a cast to the compute dtype before each conv or
linear; single-head attention over the H*W positions with fp32 scores and
softmax, the probs cast to the compute dtype before p.v; the encoder's
stride-2 downsample padded (0, 1) on the bottom and right; alpha * s +
(1 - alpha) * t with alpha = sigmoid(mix_factor) in fp32, so in bf16 the
decoder's residual stream is fp32 from its first spatio-temporal block on,
as JAX's type promotion makes it there. Conv and linear weights are held in
the compute dtype, GroupNorm's and mix_factor in fp32.

`SVDTemporalVAE.encode` takes (B, H, W, 3) frames in [-1, 1] and returns the
(B, H/8, W/8, 4) latent mean; `decode` takes RAW (not x SVD_SCALE) latents
(B, T, h, w, 4) and returns (B, T, 8h, 8w, 3), as `hma_tpu`'s do.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from hma_tpu_torch.data.datasets import SVD_SCALE  # noqa: F401  (re-exported)
from hma_tpu_torch.tokenizer.magvit2 import GroupNorm, _norm_swish

BLOCK_OUT = (128, 256, 512, 512)  # the released architecture's widths


class ResnetBlock2D(nn.Module):
    """GroupNorm -> SiLU -> 3x3 conv, twice, plus the (1x1-projected) input."""

    def __init__(self, c_in: int, c_out: int, dtype, device):
        super().__init__()
        self.dtype = dtype
        self.norm1 = GroupNorm(c_in, device)
        self.conv1 = nn.Conv2d(c_in, c_out, 3, padding=1, dtype=dtype, device=device)
        self.norm2 = GroupNorm(c_out, device)
        self.conv2 = nn.Conv2d(c_out, c_out, 3, padding=1, dtype=dtype, device=device)
        if c_in != c_out:
            self.conv_shortcut = nn.Conv2d(c_in, c_out, 1, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(_norm_swish(self.norm1, x, self.dtype))
        h = self.conv2(_norm_swish(self.norm2, h, self.dtype))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x.to(self.dtype))
        return x + h


class AttnBlock(nn.Module):
    """Single-head self-attention over the H*W positions of each image,
    scaled by 1/sqrt(C), with the residual."""

    def __init__(self, channels: int, dtype, device):
        super().__init__()
        self.dtype = dtype
        self.group_norm = GroupNorm(channels, device)
        self.to_q = nn.Linear(channels, channels, dtype=dtype, device=device)
        self.to_k = nn.Linear(channels, channels, dtype=dtype, device=device)
        self.to_v = nn.Linear(channels, channels, dtype=dtype, device=device)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels, dtype=dtype, device=device)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        h = self.group_norm(x).flatten(2).transpose(1, 2).to(self.dtype)  # (B, HW, C)
        q, k, v = self.to_q(h), self.to_k(h), self.to_v(h)
        # bf16 products are exact in fp32: this is an fp32-accumulated q.k
        scores = torch.matmul(q.float(), k.float().transpose(1, 2)) / math.sqrt(C)
        out = torch.matmul(torch.softmax(scores, dim=-1).to(self.dtype), v)
        out = self.to_out[0](out)
        return x + out.transpose(1, 2).reshape(B, C, H, W)


def _level(**modules) -> nn.Module:
    """A parameter-free container, so the keys read `down_blocks.0.resnets...`."""
    level = nn.Module()
    for name, mod in modules.items():
        setattr(level, name, mod)
    return level


class SVDEncoder(nn.Module):
    """(B, 3, H, W) in [-1, 1] -> (B, 2 * latent_channels, H/8, W/8): the
    mean and log-variance halves before `quant_conv`."""

    def __init__(self, block_out: Sequence[int], latent_channels: int, dtype, device):
        super().__init__()
        self.dtype = dtype
        self.conv_in = nn.Conv2d(3, block_out[0], 3, padding=1, dtype=dtype, device=device)
        self.down_blocks = nn.ModuleList()
        width = block_out[0]
        for i, out in enumerate(block_out):
            level = _level(resnets=nn.ModuleList([ResnetBlock2D(width, out, dtype, device),
                                                  ResnetBlock2D(out, out, dtype, device)]))
            if i < len(block_out) - 1:  # stride 2, padded (0, 1) after F.pad
                level.downsamplers = nn.ModuleList([_level(conv=nn.Conv2d(
                    out, out, 3, stride=2, dtype=dtype, device=device))])
            self.down_blocks.append(level)
            width = out
        self.mid_block = _level(
            resnets=nn.ModuleList([ResnetBlock2D(width, width, dtype, device),
                                   ResnetBlock2D(width, width, dtype, device)]),
            attentions=nn.ModuleList([AttnBlock(width, dtype, device)]))
        self.conv_norm_out = GroupNorm(width, device)
        self.conv_out = nn.Conv2d(width, 2 * latent_channels, 3, padding=1, dtype=dtype,
                                  device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x.to(self.dtype))
        for level in self.down_blocks:
            for block in level.resnets:
                h = block(h)
            if hasattr(level, "downsamplers"):
                h = level.downsamplers[0].conv(F.pad(h, (0, 1, 0, 1)))
        mid = self.mid_block
        h = mid.resnets[1](mid.attentions[0](mid.resnets[0](h)))
        return self.conv_out(_norm_swish(self.conv_norm_out, h, self.dtype))


def _frames_to_clips(x: torch.Tensor, T: int) -> torch.Tensor:
    """(B*T, C, H, W) -> (B, C, T, H, W), a view."""
    BT, C, H, W = x.shape
    return x.view(BT // T, T, C, H, W).transpose(1, 2)


def _clips_to_frames(x: torch.Tensor) -> torch.Tensor:
    """(B, C, T, H, W) -> (B*T, C, H, W)."""
    B, C, T, H, W = x.shape
    return x.transpose(1, 2).reshape(B * T, C, H, W)


class TemporalResnetBlock(nn.Module):
    """The resnet of `ResnetBlock2D` over (B, C, T, H, W) clips with (3, 1, 1)
    convs along the frame axis; GroupNorm's statistics span all T frames. It
    keeps its width (it runs on a spatial block's output), so it has no
    shortcut conv."""

    def __init__(self, channels: int, dtype, device):
        super().__init__()
        self.dtype = dtype
        conv = dict(kernel_size=(3, 1, 1), padding=(1, 0, 0), dtype=dtype, device=device)
        self.norm1 = GroupNorm(channels, device)
        self.conv1 = nn.Conv3d(channels, channels, **conv)
        self.norm2 = GroupNorm(channels, device)
        self.conv2 = nn.Conv3d(channels, channels, **conv)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(_norm_swish(self.norm1, x, self.dtype))
        return x + self.conv2(_norm_swish(self.norm2, h, self.dtype))


class SpatioTemporalResBlock(nn.Module):
    """A spatial resnet per frame, a temporal resnet on its output, mixed by
    the learned AlphaBlender: alpha * s + (1 - alpha) * t, alpha =
    sigmoid(mix_factor), in fp32."""

    def __init__(self, c_in: int, c_out: int, dtype, device):
        super().__init__()
        self.spatial_res_block = ResnetBlock2D(c_in, c_out, dtype, device)
        self.temporal_res_block = TemporalResnetBlock(c_out, dtype, device)
        self.time_mixer = _level(mix_factor=nn.Parameter(
            torch.full((1,), 0.5, device=device)))

    def forward(self, x: torch.Tensor, T: int) -> torch.Tensor:
        """x: (B*T, C, H, W) frames -> (B*T, C_out, H, W)."""
        s = _frames_to_clips(self.spatial_res_block(x), T)
        t = self.temporal_res_block(s)
        alpha = torch.sigmoid(self.time_mixer.mix_factor.float())
        return _clips_to_frames(alpha * s.float() + (1 - alpha) * t.float())


class TemporalDecoder(nn.Module):
    """(B, T, latent_channels, h, w) latents -> (B, T, 3, 8h, 8w) frames."""

    def __init__(self, block_out: Sequence[int], latent_channels: int, dtype, device):
        super().__init__()
        self.dtype = dtype
        top = block_out[-1]
        self.conv_in = nn.Conv2d(latent_channels, top, 3, padding=1, dtype=dtype,
                                 device=device)
        self.mid_block = _level(
            resnets=nn.ModuleList([SpatioTemporalResBlock(top, top, dtype, device),
                                   SpatioTemporalResBlock(top, top, dtype, device)]),
            attentions=nn.ModuleList([AttnBlock(top, dtype, device)]))
        self.up_blocks = nn.ModuleList()
        width = top
        for i, out in enumerate(reversed(block_out)):
            level = _level(resnets=nn.ModuleList(
                [SpatioTemporalResBlock(width if j == 0 else out, out, dtype, device)
                 for j in range(3)]))
            if i < len(block_out) - 1:
                level.upsamplers = nn.ModuleList([_level(conv=nn.Conv2d(
                    out, out, 3, padding=1, dtype=dtype, device=device))])
            self.up_blocks.append(level)
            width = out
        self.conv_norm_out = GroupNorm(width, device)
        self.conv_out = nn.Conv2d(width, 3, 3, padding=1, dtype=dtype, device=device)
        self.time_conv_out = nn.Conv3d(3, 3, (3, 1, 1), padding=(1, 0, 0), dtype=dtype,
                                       device=device)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        B, T = z.shape[:2]
        x = self.conv_in(z.flatten(0, 1).to(self.dtype))
        mid = self.mid_block
        x = mid.resnets[0](x, T)
        x = mid.resnets[1](mid.attentions[0](x), T)
        for level in self.up_blocks:
            for block in level.resnets:
                x = block(x, T)
            if hasattr(level, "upsamplers"):  # nearest 2x: pixel (i, j) from (i // 2, j // 2)
                x = level.upsamplers[0].conv(
                    F.interpolate(x.to(self.dtype), scale_factor=2, mode="nearest"))
        x = self.conv_out(_norm_swish(self.conv_norm_out, x, self.dtype))
        x = self.time_conv_out(_frames_to_clips(x, T))  # (B, 3, T, H, W)
        return x.transpose(1, 2)


class SVDTemporalVAE(nn.Module):
    """The encoder, `quant_conv` and the temporal decoder. Frames are
    channels-last at this interface, as `hma_tpu`'s."""

    def __init__(self, block_out: Sequence[int] = BLOCK_OUT, latent_channels: int = 4,
                 dtype=torch.bfloat16, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.block_out = tuple(block_out)
        self.latent_channels = latent_channels
        self.dtype = dtype
        self.encoder = SVDEncoder(block_out, latent_channels, dtype, device)
        self.quant_conv = nn.Conv2d(2 * latent_channels, 2 * latent_channels, 1, dtype=dtype,
                                    device=device)
        self.decoder = TemporalDecoder(block_out, latent_channels, dtype, device)
        if torch.device(device).type != "meta":
            self.reset_parameters(generator)
        if torch.device(device).type == "cuda":  # cuDNN's NHWC convs; values unchanged
            for mod in self.modules():
                if isinstance(mod, nn.Conv2d):
                    mod.to(memory_format=torch.channels_last)
                elif isinstance(mod, nn.Conv3d):
                    mod.to(memory_format=torch.channels_last_3d)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Conv and linear weights N(0, 1 / fan_in), drawn in fp32 and rounded
        to the weights' dtype; zero biases; GroupNorm scale 1, bias 0;
        mix_factor 0.5."""
        for mod in self.modules():
            if isinstance(mod, (nn.Conv2d, nn.Conv3d, nn.Linear)):
                w = mod.weight
                w.copy_(torch.randn(w.shape, generator=generator, device=w.device)
                        / math.sqrt(w[0].numel()))
                mod.bias.zero_()
            elif isinstance(mod, GroupNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, SpatioTemporalResBlock):
                mod.time_mixer.mix_factor.fill_(0.5)

    def encode(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) in [-1, 1] -> (B, H/8, W/8, latent_channels), the
        latent mean (not x SVD_SCALE)."""
        h = self.quant_conv(self.encoder(images.permute(0, 3, 1, 2)))
        return h[:, :self.latent_channels].permute(0, 2, 3, 1)

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """(B, T, h, w, latent_channels) RAW latents -> (B, T, 8h, 8w, 3)."""
        return self.decoder(latents.permute(0, 1, 4, 2, 3)).permute(0, 1, 3, 4, 2)

    def forward(self, images: torch.Tensor, num_frames: int = 1) -> torch.Tensor:
        """(B*T, H, W, 3) frames -> their (B, T, H, W, 3) reconstruction."""
        z = self.encode(images)
        return self.decode(z.reshape(z.shape[0] // num_frames, num_frames, *z.shape[1:]))
