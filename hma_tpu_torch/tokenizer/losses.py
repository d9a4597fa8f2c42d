"""Tokenizer GAN training losses (counterpart of hma_tpu/tokenizer/losses.py).

L1 + LPIPS reconstruction, the non-saturating generator loss with an
adaptive weight from the last layer's gradient norms, the hinge, vanilla
and non-saturating discriminator losses, and the LeCam EMA regularizer.
The LeCam EMAs are an explicit value (`LeCamState`) that the discriminator
loss returns updated, as hma_tpu carries them. Every loss is fp32.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
from torch.nn import functional as F


def adopt_weight(weight: float, global_step: int, threshold: int = 0,
                 value: float = 0.0) -> float:
    """`value` before `threshold` steps, `weight` from then on."""
    return value if global_step < threshold else weight


def hinge_d_loss(logits_real, logits_fake):
    return 0.5 * (torch.mean(F.relu(1.0 - logits_real)) + torch.mean(F.relu(1.0 + logits_fake)))


def vanilla_d_loss(logits_real, logits_fake):
    return 0.5 * (torch.mean(F.softplus(-logits_real)) + torch.mean(F.softplus(logits_fake)))


def _sigmoid_xent(labels, logits):
    return F.relu(logits) - logits * labels + torch.log1p(torch.exp(-torch.abs(logits)))


def non_saturate_gen_loss(logits_fake):
    lf = logits_fake.reshape(logits_fake.shape[0], -1).mean(-1)
    return torch.mean(_sigmoid_xent(torch.ones_like(lf), lf))


def non_saturate_discriminator_loss(logits_real, logits_fake):
    B = logits_fake.shape[0]
    lr = logits_real.reshape(B, -1).mean(-1)
    lf = logits_fake.reshape(B, -1).mean(-1)
    return (torch.mean(_sigmoid_xent(torch.ones_like(lr), lr))
            + torch.mean(_sigmoid_xent(torch.zeros_like(lf), lf)))


D_LOSSES = {
    "hinge": hinge_d_loss,
    "vanilla": vanilla_d_loss,
    "non_saturate": non_saturate_discriminator_loss,
}


class LeCamState(NamedTuple):
    """EMAs of the mean real and fake logits, 0-dim fp32 tensors."""

    real_ema: torch.Tensor
    fake_ema: torch.Tensor

    @classmethod
    def init(cls, device="cpu"):
        return cls(torch.zeros((), device=device), torch.zeros((), device=device))


def lecam_update(state: LeCamState, logits_real, logits_fake,
                 decay: float = 0.999) -> LeCamState:
    return LeCamState(state.real_ema * decay + torch.mean(logits_real) * (1 - decay),
                      state.fake_ema * decay + torch.mean(logits_fake) * (1 - decay))


def lecam_reg(logits_real, logits_fake, state: LeCamState):
    return (torch.mean(F.relu(logits_real - state.fake_ema) ** 2)
            + torch.mean(F.relu(state.real_ema - logits_fake) ** 2))


def adaptive_gan_weight(nll_grad_norm, g_grad_norm, disc_weight: float):
    """||grad_last nll|| / (||grad_last g|| + 1e-4), clamped to [0, 1e4],
    times `disc_weight`."""
    return torch.clamp(nll_grad_norm / (g_grad_norm + 1e-4), 0.0, 1e4) * disc_weight


def generator_loss(inputs, recon, entropy_loss, commit_loss, logits_fake, *,
                   lpips_fn: Optional[Callable], global_step: int, config,
                   d_weight) -> tuple[torch.Tensor, dict]:
    """The generator's total loss and its logs. `inputs` are fp32, `recon`
    the codec's output in its compute dtype (the difference is fp32);
    `d_weight` is precomputed (adaptive, detached, or the config's
    `gen_loss_weight`)."""
    rec = torch.abs(inputs - recon)
    nll = rec
    p_loss = torch.zeros((), device=rec.device)
    if lpips_fn is not None and config.perceptual_weight > 0:
        p_loss = torch.mean(lpips_fn(inputs, recon))
        nll = nll + config.perceptual_weight * p_loss
    nll_loss = torch.mean(nll)

    g_loss = non_saturate_gen_loss(logits_fake)
    disc_factor = adopt_weight(config.disc_factor, global_step, config.disc_start)
    g_term = d_weight * disc_factor * g_loss

    codebook_term = config.codebook_weight * entropy_loss
    total = nll_loss + g_term + codebook_term + config.commit_weight * commit_loss
    logs = {
        "nll_loss": nll_loss, "reconstruct_loss": torch.mean(rec),
        "perceptual_loss": p_loss, "g_loss": g_loss,
        "entropy_loss": entropy_loss, "commit_loss": commit_loss,
        "d_weight": d_weight, "total_loss": total,
    }
    return total, logs


def discriminator_loss(logits_real, logits_fake, lecam: LeCamState, *,
                       global_step: int, config) -> tuple[torch.Tensor, LeCamState, dict]:
    """The discriminator's loss, the updated LeCam EMAs and the logs. The
    EMAs are updated with this batch's logits before the regularizer reads
    them."""
    disc_factor = adopt_weight(config.disc_factor, global_step, config.disc_start)
    base = D_LOSSES[config.disc_loss](logits_real, logits_fake)
    lecam = lecam_update(lecam, logits_real, logits_fake)
    reg = lecam_reg(logits_real, logits_fake, lecam)
    d_loss = disc_factor * (config.lecam_loss_weight * reg + base)
    logs = {"disc_loss": d_loss, "logits_real": torch.mean(logits_real),
            "logits_fake": torch.mean(logits_fake), "lecam_loss": reg,
            "non_saturated_d_loss": base}
    return d_loss, lecam, logs
