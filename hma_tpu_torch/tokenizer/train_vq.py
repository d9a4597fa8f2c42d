"""MagVit2 tokenizer GAN training: the two-optimizer step, the EMA, the
schedules (counterpart of hma_tpu/tokenizer/train_vq.py).

One call of the step returned by `make_vq_train_step` is hma_tpu's jitted
step, in place on a `VQTrainState`:
  - the adaptive GAN weight (when `gen_loss_weight` is None): the norms of
    the gradients of the reconstruction loss and of the generator loss
    with respect to the decoder's last conv weight, each over a forward of
    its own, ||nll'|| / (||g'|| + 1e-4) clamped to [0, 1e4] times
    `disc_weight`, detached;
  - the generator update: L1 + LPIPS + entropy and commit + the weighted
    non-saturating GAN loss, the discriminator read in evaluation mode (its
    parameters and running statistics untouched), then Adam;
  - the EMA shadow of the updated generator, decay min(0.9999, (1 + n) /
    (10 + n)) at the count n before this update;
  - the discriminator update on the real batch then the generator's
    (detached) output, both in training mode, so the running statistics
    move twice; the LeCam EMAs move before the regularizer reads them;
    only the parameters go through Adam.
Both optimizers are optax's adam(b1 0.5, b2 0.9, eps 1e-8) written by hand,
the learning rate read at the count before the update (linear warmup:
base * min(1, (c + 1) / warmup)). The codec computes in bf16 on the card
and in fp32 on the CPU; its parameters, the discriminator and LPIPS are
fp32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from hma_tpu_torch.metrics.fid import fp32_convs
from hma_tpu_torch.tokenizer.discriminator import NLayerDiscriminator
from hma_tpu_torch.tokenizer.losses import (
    LeCamState,
    adaptive_gan_weight,
    discriminator_loss,
    generator_loss,
    non_saturate_gen_loss,
)
from hma_tpu_torch.tokenizer.magvit2 import VQConfig, VQModel
from hma_tpu_torch.train.step import _adamw_

Schedule = Callable[[int], float]


def ema_decay(num_updates: int, base_decay: float = 0.9999) -> np.float32:
    """min(base_decay, (1 + n) / (10 + n)), in fp32 as hma_tpu computes it."""
    n = np.float32(num_updates)
    return np.minimum(np.float32(base_decay), (np.float32(1) + n) / (np.float32(10) + n))


def warmup_schedule(base_lr: float, warmup_steps: int) -> Schedule:
    """Linear warmup, then constant."""
    return lambda step: base_lr * min(1.0, (step + 1) / max(warmup_steps, 1))


def warmup_cosine_schedule(base_lr: float, warmup_steps: int, max_steps: int,
                           multiplier_min: float = 0.1) -> Schedule:
    """Linear warmup, then a cosine decay to `multiplier_min` * base_lr."""

    def sched(step):
        if step < warmup_steps:
            return base_lr * (step + 1) / max(warmup_steps, 1)
        prog = (step - warmup_steps) / max(max_steps - warmup_steps, 1)
        return base_lr * (multiplier_min
                          + 0.5 * (1 - multiplier_min) * (1 + math.cos(math.pi * prog)))
    return sched


class Adam:
    """optax.adam over a module's parameters, in place, fp32 moments; the
    schedule is read at the count before the update."""

    def __init__(self, params: dict[str, torch.Tensor], schedule: Schedule,
                 b1: float = 0.5, b2: float = 0.9, eps: float = 1e-8):
        self.schedule, self.b1, self.b2, self.eps = schedule, b1, b2, eps
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor]) -> None:
        lr = self.schedule(self.count)
        self.count += 1
        for n, p in params.items():
            _adamw_(p, grads[n], self.m[n], self.v[n], self.count, lr, 0.0,
                    self.b1, self.b2, self.eps, 1.0)


@dataclass
class VQTrainState:
    """The codec (fp32 parameters) and its Adam, the discriminator and its
    Adam, the EMA shadow of every codec parameter, the EMA's update count,
    the LeCam EMAs and the step."""

    gen: VQModel
    gen_opt: Adam
    disc: NLayerDiscriminator
    disc_opt: Adam
    ema: dict
    ema_updates: int
    lecam: LeCamState
    step: int


def init_vq_train_state(config: VQConfig, seed: int = 0, lr: float = 1e-4,
                        warmup_steps: int = 1000, dtype=None, device="cuda") -> VQTrainState:
    """A fresh state on `device`: the codec computing in `dtype` (default
    bf16 on the card, fp32 on the CPU) with fp32 weights, drawn from a
    generator on `device` seeded `seed`; the discriminator in fp32, drawn
    from a CPU generator seeded `seed` + 1."""
    device = torch.device(device)
    dtype = dtype or (torch.bfloat16 if device.type == "cuda" else torch.float32)
    gen = VQModel(config, dtype=dtype, device=device, param_dtype=torch.float32,
                  generator=torch.Generator(device).manual_seed(seed))
    disc = NLayerDiscriminator(config.disc_in_channels, config.disc_ndf,
                               config.disc_num_layers, device=device,
                               generator=torch.Generator().manual_seed(seed + 1))
    return VQTrainState(
        gen=gen, gen_opt=Adam(dict(gen.named_parameters()), warmup_schedule(lr, warmup_steps)),
        disc=disc,
        disc_opt=Adam(dict(disc.named_parameters()), warmup_schedule(lr, warmup_steps)),
        ema={n: p.detach().clone() for n, p in gen.named_parameters()}, ema_updates=0,
        lecam=LeCamState.init(device), step=0)


def make_vq_train_step(state: VQTrainState, config: VQConfig,
                       lpips_fn: Optional[Callable] = None) -> Callable:
    """Returns step(images) -> logs, which updates `state` in place; images
    (B, 3, H, W) fp32 in [-1, 1]; the logs are 0-dim tensors. `lpips_fn(x,
    y)` takes two such batches (the reconstruction in the codec's dtype)."""
    gen, disc = state.gen, state.disc
    gen_params = dict(gen.named_parameters())
    disc_params = dict(disc.named_parameters())
    last = gen.decoder.conv_out.weight
    use_lpips = lpips_fn is not None and config.perceptual_weight > 0

    def nll_of(images, recon):
        rec = torch.abs(images - recon)
        if use_lpips:
            rec = rec + config.perceptual_weight * torch.mean(lpips_fn(images, recon))
        return torch.mean(rec)

    def adaptive_weight(images):
        recon, _ = gen(images, True)
        (nll_g,) = torch.autograd.grad(nll_of(images, recon), last)
        recon, _ = gen(images, True)
        g = non_saturate_gen_loss(disc(recon.float()))
        (gan_g,) = torch.autograd.grad(g, last)
        return adaptive_gan_weight(torch.linalg.vector_norm(nll_g),
                                   torch.linalg.vector_norm(gan_g), config.disc_weight)

    def step(images: torch.Tensor) -> dict:
        with fp32_convs():  # the fp32 parts (discriminator, LPIPS) in full fp32
            disc.eval()  # the generator's side reads the running statistics
            if config.gen_loss_weight is None:
                d_weight = adaptive_weight(images).detach()
            else:
                d_weight = torch.tensor(config.gen_loss_weight, dtype=torch.float32,
                                        device=images.device)

            recon, res = gen(images, True)
            total, gen_logs = generator_loss(
                images, recon, res.entropy_loss, res.commit_loss, disc(recon.float()),
                lpips_fn=lpips_fn, global_step=state.step, config=config, d_weight=d_weight)
            grads = torch.autograd.grad(total, list(gen_params.values()))
            state.gen_opt.step(gen_params, dict(zip(gen_params, grads)))

            with torch.no_grad():
                decay = ema_decay(state.ema_updates)
                for n, p in gen_params.items():
                    state.ema[n].mul_(float(decay)).add_(p * float(np.float32(1) - decay))

            disc.train()
            recon_sg = recon.detach().float()
            logits_real = disc(images)
            logits_fake = disc(recon_sg)
            d_loss, lecam, d_logs = discriminator_loss(
                logits_real, logits_fake, state.lecam, global_step=state.step, config=config)
            grads = torch.autograd.grad(d_loss, list(disc_params.values()))
            state.disc_opt.step(disc_params, dict(zip(disc_params, grads)))

        state.lecam = LeCamState(lecam.real_ema.detach(), lecam.fake_ema.detach())
        state.ema_updates += 1
        state.step += 1
        return {k: v.detach() for k, v in {**gen_logs, **d_logs}.items()}

    return step
