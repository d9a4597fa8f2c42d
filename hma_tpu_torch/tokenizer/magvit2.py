"""MagVit2 (Open-MAGVIT2) VQ tokenizer: conv encoder and decoder with
lookup-free quantization (counterpart of hma_tpu/tokenizer/magvit2.py).

NCHW modules whose parameter names and shapes are the reference torch
checkpoint's (`encoder.down.<i>.block.<j>.conv1.weight` (O, I, kh, kw),
`decoder.up.<i>.upsample.conv1.weight`, `encoder.mid_block.<j>.norm1.weight`,
`conv_in`, `norm_out`, `conv_out`), so a reference `magvit2.ckpt` loads with
`load_state_dict` (`convert.load_magvit2`). The numerics are `hma_tpu`'s:
GroupNorm in fp32 with eps 1e-6, swish, then a cast to the compute dtype
before each conv; bias-free ResBlock convs and encoder `conv_in`; the
stride-2 downsample padded (1, 1); a 1x1 `nin_shortcut` where the width
changes; depth-to-space in DCR order. Conv weights are held in the compute
dtype (`hma_tpu` keeps them in fp32 and casts them at each call, which
rounds them the same way; training holds them in fp32 and casts them at
each call, `param_dtype`), GroupNorm's in fp32. On the card the convs run
channels-last, which changes no values.

`VQConfig()` is the released architecture: base 128, ch_mult (1, 1, 2, 2,
4), 2 res blocks, z 18, 256² images to 16² token grids.
"""

from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from hma_tpu_torch.tokenizer.lfq import LFQResult, codes_to_latents, lfq_quantize


@dataclass
class VQConfig:
    """Tokenizer config: the architecture and the fields the GAN training
    harness reads (`tokenizer/losses.py`, `train_vq.py`; `gen_loss_weight`
    None turns the adaptive GAN weight on), each with hma_tpu's default. A
    sidecar written by either package loads into either: unknown keys are
    dropped on load, as hma_tpu drops them, and the fields hma_tpu has
    beside these (`disc_conditional`, `pixelloss_weight` and the codebook
    fields) are read by neither package."""

    in_channels: int = 3
    z_channels: int = 18
    out_channels: int = 3
    base_channels: int = 128
    ch_mult: tuple = (1, 1, 2, 2, 4)
    num_res_blocks: int = 2

    # loss knobs (used by the GAN training harness)
    disc_in_channels: int = 3
    disc_start: int = 0
    disc_loss: str = "hinge"
    disc_ndf: int = 64
    disc_num_layers: int = 3
    disc_factor: float = 1.0
    disc_weight: float = 0.8
    gen_loss_weight: Optional[float] = 0.1
    lecam_loss_weight: float = 0.005
    codebook_weight: float = 0.1
    commit_weight: float = 0.25
    perceptual_weight: float = 1.0
    sample_minimization_weight: float = 1.0
    batch_maximization_weight: float = 1.0

    def save_pretrained(self, json_path):
        d = dataclasses.asdict(self)
        d["ch_mult"] = list(self.ch_mult)
        with open(json_path, "w") as f:
            json.dump(d, f)

    @classmethod
    def from_pretrained(cls, json_path):
        with open(json_path) as f:
            raw = json.load(f)
        names = {f.name for f in dataclasses.fields(cls)}
        cfg = cls(**{k: v for k, v in raw.items() if k in names})
        cfg.ch_mult = tuple(cfg.ch_mult)
        return cfg


def _groups(c: int) -> int:
    """32 groups at production widths; the largest divisor <= 32 where 32
    does not divide the channel count (small configs)."""
    g = min(32, c)
    while c % g:
        g -= 1
    return g


class GroupNorm(nn.GroupNorm):
    """GroupNorm in fp32 (eps 1e-6) whatever the input's dtype."""

    def __init__(self, channels: int, device=None):
        super().__init__(_groups(channels), channels, eps=1e-6, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.weight, self.bias, self.eps)


def _norm_swish(norm: GroupNorm, x: torch.Tensor, dtype) -> torch.Tensor:
    return F.silu(norm(x)).to(dtype)


class Conv2d(nn.Conv2d):
    """A conv whose weights may be held in another dtype than it computes in
    (fp32 master weights for training): cast to `compute_dtype` at each
    call, as hma_tpu's `param_dtype=float32` convs are."""

    def __init__(self, *args, compute_dtype, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(self.compute_dtype)
        return self._conv_forward(x, self.weight.to(self.compute_dtype), bias)


def _conv(c_in, c_out, k, dtype, device, bias=True, stride=1):
    return Conv2d(c_in, c_out, k, stride=stride, padding=k // 2, bias=bias,
                  dtype=dtype, device=device, compute_dtype=dtype)


class ResBlock(nn.Module):
    """GroupNorm -> swish -> 3x3 conv, twice, plus the (projected) input."""

    def __init__(self, in_filters: int, out_filters: int, dtype, device):
        super().__init__()
        self.dtype = dtype
        self.norm1 = GroupNorm(in_filters, device)
        self.conv1 = _conv(in_filters, out_filters, 3, dtype, device, bias=False)
        self.norm2 = GroupNorm(out_filters, device)
        self.conv2 = _conv(out_filters, out_filters, 3, dtype, device, bias=False)
        if in_filters != out_filters:
            self.nin_shortcut = _conv(in_filters, out_filters, 1, dtype, device, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(_norm_swish(self.norm1, x, self.dtype))
        h = self.conv2(_norm_swish(self.norm2, h, self.dtype))
        return h + (self.nin_shortcut(x) if hasattr(self, "nin_shortcut") else x)


class Encoder(nn.Module):
    """Image (B, 3, H, W) in [-1, 1] -> latent (B, z_channels, H/16, W/16)."""

    def __init__(self, config: VQConfig, dtype, device):
        super().__init__()
        cfg = config
        self.dtype = dtype
        width = cfg.base_channels
        self.conv_in = _conv(cfg.in_channels, width, 3, dtype, device, bias=False)
        self.down = nn.ModuleList()
        for i_level, mult in enumerate(cfg.ch_mult):
            level = nn.Module()
            out = cfg.base_channels * mult
            level.block = nn.ModuleList()
            for _ in range(cfg.num_res_blocks):
                level.block.append(ResBlock(width, out, dtype, device))
                width = out
            if i_level < len(cfg.ch_mult) - 1:  # torch's padding 1, not SAME
                level.downsample = _conv(out, out, 3, dtype, device, stride=2)
            self.down.append(level)
        self.mid_block = nn.ModuleList(ResBlock(width, width, dtype, device)
                                       for _ in range(cfg.num_res_blocks))
        self.norm_out = GroupNorm(width, device)
        self.conv_out = _conv(width, cfg.z_channels, 1, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x.to(self.dtype))
        for level in self.down:
            for block in level.block:
                h = block(h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        for block in self.mid_block:
            h = block(h)
        return self.conv_out(_norm_swish(self.norm_out, h, self.dtype))


def depth_to_space(x: torch.Tensor, block_size: int) -> torch.Tensor:
    """NCHW depth-to-space in DCR order: channel (i * s + j) * cout + k of
    pixel (h, w) goes to pixel (h * s + i, w * s + j), channel k. (Not
    torch's pixel_shuffle, which is CRD.) Worked channels-last, so a
    channels-last input costs one copy."""
    B, C, H, W = x.shape
    s = block_size
    y = x.permute(0, 2, 3, 1).reshape(B, H, W, s, s, C // (s * s))
    y = y.permute(0, 1, 3, 2, 4, 5).reshape(B, H * s, W * s, C // (s * s))
    return y.permute(0, 3, 1, 2)


class Upsampler(nn.Module):
    """3x3 conv to 4x the channels, then 2x depth-to-space."""

    def __init__(self, dim: int, dtype, device):
        super().__init__()
        self.conv1 = _conv(dim, dim * 4, 3, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return depth_to_space(self.conv1(x), 2)


class Decoder(nn.Module):
    """±1 latent (B, z_channels, h, w) -> image (B, 3, 16h, 16w) in [-1, 1]."""

    def __init__(self, config: VQConfig, dtype, device):
        super().__init__()
        cfg = config
        self.dtype = dtype
        width = cfg.base_channels * cfg.ch_mult[-1]
        self.conv_in = _conv(cfg.z_channels, width, 3, dtype, device)
        self.mid_block = nn.ModuleList(ResBlock(width, width, dtype, device)
                                       for _ in range(cfg.num_res_blocks))
        levels = [None] * len(cfg.ch_mult)  # up[i] is level i, run from the top
        for i_level in reversed(range(len(cfg.ch_mult))):
            level = nn.Module()
            out = cfg.base_channels * cfg.ch_mult[i_level]
            level.block = nn.ModuleList()
            for _ in range(cfg.num_res_blocks):
                level.block.append(ResBlock(width, out, dtype, device))
                width = out
            if i_level > 0:
                level.upsample = Upsampler(out, dtype, device)
            levels[i_level] = level
        self.up = nn.ModuleList(levels)
        self.norm_out = GroupNorm(width, device)
        self.conv_out = _conv(width, cfg.out_channels, 3, dtype, device)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(z.to(self.dtype))
        for block in self.mid_block:
            h = block(h)
        for level in reversed(self.up):
            for block in level.block:
                h = block(h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return self.conv_out(_norm_swish(self.norm_out, h, self.dtype))


class VQModel(nn.Module):
    """Encoder + LFQ + Decoder, the codec. Images are NCHW in [-1, 1];
    token grids (B, h, w) int32. The convs compute in `dtype`; their weights
    are held in `param_dtype` (default `dtype`; training keeps fp32 master
    weights, as hma_tpu's convs do)."""

    def __init__(self, config: Optional[VQConfig] = None, dtype=torch.bfloat16,
                 device="cuda", generator: Optional[torch.Generator] = None,
                 param_dtype=None):
        super().__init__()
        self.config = config or VQConfig()
        self.dtype = dtype
        self.encoder = Encoder(self.config, dtype, device)
        self.decoder = Decoder(self.config, dtype, device)
        if param_dtype is not None and param_dtype != dtype:
            for mod in self.modules():
                if isinstance(mod, Conv2d):
                    mod.to(param_dtype)
        if torch.device(device).type != "meta":
            self.reset_parameters(generator)
        if torch.device(device).type == "cuda":
            self.to(memory_format=torch.channels_last)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Conv weights N(0, 1 / fan_in) (flax's lecun_normal, untruncated),
        drawn in fp32 and rounded to the weights' dtype, so a bf16 and an fp32
        model from one seed agree; zero biases; GroupNorm scale 1, bias 0."""
        for mod in self.modules():
            if isinstance(mod, nn.Conv2d):
                w = mod.weight
                fan_in = w.shape[1] * w.shape[2] * w.shape[3]
                w.copy_(torch.randn(w.shape, generator=generator, device=w.device)
                        / math.sqrt(fan_in))
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, GroupNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()

    def encode_without_quantize(self, x: torch.Tensor) -> torch.Tensor:
        return self.encoder(x)

    def encode(self, x: torch.Tensor, compute_losses: bool = False) -> LFQResult:
        """x: (B, 3, H, W) in [-1, 1] -> LFQResult with (B, h, w) indices and
        (B, z_channels, h, w) quantized latents."""
        res = lfq_quantize(
            self.encoder(x).permute(0, 2, 3, 1), compute_losses=compute_losses,
            sample_minimization_weight=self.config.sample_minimization_weight,
            batch_maximization_weight=self.config.batch_maximization_weight)
        return res._replace(quantized=res.quantized.permute(0, 3, 1, 2))

    def decode(self, quant: torch.Tensor) -> torch.Tensor:
        """quant: (B, z_channels, h, w) ±1 latents -> (B, 3, H, W)."""
        return self.decoder(quant)

    def decode_code(self, indices: torch.Tensor) -> torch.Tensor:
        """indices: (B, h, w) token ids -> (B, 3, H, W) images."""
        quant = codes_to_latents(indices, self.config.z_channels, self.dtype)
        return self.decoder(quant.permute(0, 3, 1, 2))

    def forward(self, x: torch.Tensor, compute_losses: bool = False):
        res = self.encode(x, compute_losses=compute_losses)
        return self.decode(res.quantized), res


def normalize_image(img: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] -> float32 [-1, 1]."""
    return img.float() / 127.5 - 1.0


def unnormalize_image(img: torch.Tensor) -> torch.Tensor:
    """float [-1, 1] -> uint8 [0, 255], clipped (then truncated, as a cast)."""
    return torch.clamp((img.float() + 1.0) * 127.5, 0, 255).to(torch.uint8)
