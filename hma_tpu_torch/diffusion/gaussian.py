"""Gaussian diffusion: training loss and sampling
(counterpart of hma_tpu/diffusion/gaussian.py).

The schedules are numpy float64 constants, computed exactly as the JAX file
computes them: cosine or linear betas over `diffusion_steps`, re-derived
over a respaced subset of timesteps. The sampler is ancestral sampling with
epsilon prediction and the learned-range variance, a Python loop where the
JAX file has a `lax.scan`. `training_losses` is the eps-MSE plus the
variational bound of the learned variance, with `hma_tpu`'s guards: the
+-80 clamps before every exp() and the double `where` that keeps the
unselected branch's overflow out of the backward (`torch.where` has the
same 0 * inf = NaN backward as `jnp.where`).

The schedule helpers take a step index as an int (sampling: one step for
every row) or a tensor of per-row timesteps (training); a schedule value is
rounded to fp32 as the JAX file's `_extract` rounds its table.

Random draws: every loop takes a `torch.Generator` or, for the tests, the
per-step normals themselves as `zs` (K, N, C) in loop order (`zs[i]`
belongs to step index K-1-i), since `jax.random` and torch never agree;
`training_losses` takes its timesteps and noise as tensors.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Union

import numpy as np
import torch


class DiffusionSchedule(NamedTuple):
    """Precomputed schedule arrays, length = number of (respaced) timesteps."""

    betas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    sqrt_recip_alphas_cumprod: np.ndarray
    sqrt_recipm1_alphas_cumprod: np.ndarray
    posterior_variance: np.ndarray
    posterior_log_variance_clipped: np.ndarray
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray
    timestep_map: np.ndarray  # respaced index -> original timestep (for the net)

    @property
    def num_timesteps(self) -> int:
        return len(self.betas)


def cosine_betas(num_steps: int, max_beta: float = 0.999) -> np.ndarray:
    """The squaredcos_cap_v2 schedule."""

    def alpha_bar(t):
        return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

    betas = []
    for i in range(num_steps):
        t1, t2 = i / num_steps, (i + 1) / num_steps
        betas.append(min(1 - alpha_bar(t2) / alpha_bar(t1), max_beta))
    return np.asarray(betas, dtype=np.float64)


def linear_betas(num_steps: int) -> np.ndarray:
    scale = 1000 / num_steps
    return np.linspace(scale * 1e-4, scale * 2e-2, num_steps, dtype=np.float64)


def space_timesteps(num_timesteps: int, section_counts) -> list[int]:
    """Evenly strided timestep subsets: "ddimN" (an integer stride that
    gives exactly N steps), "a,b,..." (counts per equal section) or an int."""
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired = int(section_counts[len("ddim"):])
            for i in range(1, num_timesteps):
                if len(range(0, num_timesteps, i)) == desired:
                    return list(range(0, num_timesteps, i))
            raise ValueError(f"cannot create exactly {desired} steps with an integer stride")
        section_counts = [int(x) for x in section_counts.split(",")]
    elif isinstance(section_counts, int):
        section_counts = [section_counts]
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx, all_steps = 0, []
    for i, count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < count:
            raise ValueError(f"cannot divide section of {size} steps into {count}")
        stride = 1 if count <= 1 else (size - 1) / (count - 1)
        cur, taken = 0.0, []
        for _ in range(count):
            taken.append(start_idx + round(cur))
            cur += stride
        all_steps += taken
        start_idx += size
    return sorted(all_steps)


def make_schedule(noise_schedule: str = "cosine", diffusion_steps: int = 1000,
                  timestep_respacing="") -> DiffusionSchedule:
    betas = (cosine_betas(diffusion_steps) if noise_schedule == "cosine"
             else linear_betas(diffusion_steps))
    if timestep_respacing in (None, "", []):
        use = list(range(diffusion_steps))
    else:
        use = space_timesteps(diffusion_steps, timestep_respacing)

    # re-derive the betas over the retained timesteps
    alphas_cumprod_full = np.cumprod(1.0 - betas)
    new_betas, timestep_map = [], []
    last = 1.0
    for t in use:
        new_betas.append(1 - alphas_cumprod_full[t] / last)
        last = alphas_cumprod_full[t]
        timestep_map.append(t)
    betas = np.asarray(new_betas, dtype=np.float64)

    alphas = 1.0 - betas
    ac = np.cumprod(alphas)
    ac_prev = np.append(1.0, ac[:-1])
    posterior_variance = betas * (1.0 - ac_prev) / (1.0 - ac)
    posterior_log = np.log(np.append(posterior_variance[1], posterior_variance[1:]))
    return DiffusionSchedule(
        betas=betas,
        alphas_cumprod=ac,
        alphas_cumprod_prev=ac_prev,
        sqrt_alphas_cumprod=np.sqrt(ac),
        sqrt_one_minus_alphas_cumprod=np.sqrt(1.0 - ac),
        sqrt_recip_alphas_cumprod=np.sqrt(1.0 / ac),
        sqrt_recipm1_alphas_cumprod=np.sqrt(1.0 / ac - 1),
        posterior_variance=posterior_variance,
        posterior_log_variance_clipped=posterior_log,
        posterior_mean_coef1=betas * np.sqrt(ac_prev) / (1.0 - ac),
        posterior_mean_coef2=(1.0 - ac_prev) * np.sqrt(alphas) / (1.0 - ac),
        timestep_map=np.asarray(timestep_map, dtype=np.int32),
    )


Step = Union[int, torch.Tensor]  # one step index, or (N,) per-row timesteps

_TABLES: dict = {}  # (id of a schedule array, device) -> (array, fp32 table)


def _table(arr: np.ndarray, device) -> torch.Tensor:
    """`arr` as an fp32 tensor on `device`, made once per array and device
    (the array is kept alive beside it, so its id is not reused)."""
    key = (id(arr), str(device))
    hit = _TABLES.get(key)
    if hit is None or hit[0] is not arr:
        hit = _TABLES[key] = (arr, torch.from_numpy(arr.astype(np.float32)).to(device))
    return hit[1]


def _log_betas(sched: DiffusionSchedule) -> np.ndarray:
    key = ("log_betas", id(sched.betas))
    hit = _TABLES.get(key)
    if hit is None or hit[0] is not sched.betas:
        hit = _TABLES[key] = (sched.betas, np.log(np.maximum(sched.betas, 1e-20)))
    return hit[1]


def _at(arr: np.ndarray, idx: Step, ndim: int = 1):
    """Schedule value at step `idx`, rounded to fp32 as the JAX file's
    `_extract` rounds the table: a float for an int `idx`; for a (N,)
    tensor of timesteps, their values shaped (N, 1, ...) to broadcast
    against an `ndim`-dimensional tensor."""
    if not torch.is_tensor(idx):
        return float(np.float32(arr[idx]))
    out = _table(arr, idx.device)[idx]
    return out.reshape(idx.shape + (1,) * (ndim - idx.ndim))


def q_sample(sched: DiffusionSchedule, x0: torch.Tensor, t: Step,
             noise: torch.Tensor) -> torch.Tensor:
    """Forward diffusion: x_t = sqrt(abar_t) x0 + sqrt(1 - abar_t) noise."""
    return (_at(sched.sqrt_alphas_cumprod, t, x0.ndim) * x0
            + _at(sched.sqrt_one_minus_alphas_cumprod, t, x0.ndim) * noise)


def predict_x0_from_eps(sched: DiffusionSchedule, xt: torch.Tensor, idx: Step,
                        eps: torch.Tensor) -> torch.Tensor:
    return (_at(sched.sqrt_recip_alphas_cumprod, idx, xt.ndim) * xt
            - _at(sched.sqrt_recipm1_alphas_cumprod, idx, xt.ndim) * eps)


def q_posterior_mean(sched: DiffusionSchedule, x0: torch.Tensor,
                     xt: torch.Tensor, idx: Step) -> torch.Tensor:
    return (_at(sched.posterior_mean_coef1, idx, x0.ndim) * x0
            + _at(sched.posterior_mean_coef2, idx, x0.ndim) * xt)


def learned_range_log_variance(sched: DiffusionSchedule, idx: Step,
                               v: torch.Tensor) -> torch.Tensor:
    """Log-variance interpolated between the posterior's (min) and beta's
    (max) from the model's raw v output, with frac = (v + 1) / 2 clamped to
    [0, 1], the interval the interpolation is defined on: a variance head
    that drifts out of range saturates at the boundary."""
    min_log = _at(sched.posterior_log_variance_clipped, idx, v.ndim)
    max_log = _at(_log_betas(sched), idx, v.ndim)
    frac = torch.clamp((v.float() + 1) / 2, 0.0, 1.0)
    return frac * max_log + (1 - frac) * min_log


def _normal_kl(mean1, logvar1, mean2, logvar2):
    """KL(N1 || N2) elementwise, each exp() input clamped to [-80, 80]: fp32
    exp overflows just past 88, and an inf here would reach the backward
    of the branch that the loss discards as 0 * inf = NaN."""
    return 0.5 * (-1.0 + logvar2 - logvar1
                  + torch.exp(torch.clamp(logvar1 - logvar2, -80.0, 80.0))
                  + (mean1 - mean2) ** 2 * torch.exp(torch.clamp(-logvar2, -80.0, 80.0)))


def _discretized_gaussian_log_likelihood(x, means, log_scales):
    """Log-likelihood of x under a Gaussian discretised to bins of 2/255,
    -log_scales clamped to [-80, 80] before exp() (past it the CDFs are
    saturated, so the forward is unchanged and the backward is 0, not
    pdf(inf) * inf = NaN)."""
    centered = x - means
    inv_stdv = torch.exp(torch.clamp(-log_scales, -80.0, 80.0))
    cdf_plus = torch.special.ndtr(inv_stdv * (centered + 1.0 / 255.0))
    cdf_min = torch.special.ndtr(inv_stdv * (centered - 1.0 / 255.0))
    log_cdf_plus = torch.log(torch.clamp(cdf_plus, min=1e-12))
    log_one_minus_cdf_min = torch.log(torch.clamp(1.0 - cdf_min, min=1e-12))
    log_delta = torch.log(torch.clamp(cdf_plus - cdf_min, min=1e-12))
    return torch.where(x < -0.999, log_cdf_plus,
                       torch.where(x > 0.999, log_one_minus_cdf_min, log_delta))


def training_losses(net_apply: Callable, sched: DiffusionSchedule,
                    x0: torch.Tensor, t: torch.Tensor, cond, noise: torch.Tensor,
                    channel_mask: Optional[torch.Tensor] = None) -> dict:
    """Per-row loss: eps-MSE plus the variational bound of the learned-range
    variance (the VB term sees the eps prediction through a stop-gradient).

    net_apply(x_t, t, cond) -> (N, 2C) = [eps, v]; x0, noise: (N, C); t:
    (N,) timesteps; channel_mask: optional (C,) weights of the channels that
    count (padded action channels carry noise the net never sees).
    Returns {"loss", "mse", "vb"}, each (N,).
    """
    xt = q_sample(sched, x0, t, noise)
    out = net_apply(xt, t, cond)
    C = x0.shape[-1]
    eps_pred, v = out[..., :C], out[..., C:]
    dims = tuple(range(1, x0.ndim))

    def cmean(x):
        if channel_mask is None:
            return x.mean(dims)
        w = torch.broadcast_to(channel_mask, x.shape).float()
        return (x * w).sum(dims) / torch.clamp(w.sum(dims), min=1e-8)

    mse = cmean((noise.float() - eps_pred.float()) ** 2)
    x0_pred = predict_x0_from_eps(sched, xt, t, eps_pred.detach())
    model_mean = q_posterior_mean(sched, x0_pred, xt, t)
    model_logvar = learned_range_log_variance(sched, t, v)
    true_mean = q_posterior_mean(sched, x0, xt, t)
    true_logvar = _at(sched.posterior_log_variance_clipped, t, x0.ndim)
    # Each branch gets a finite logvar on the rows where the other one is
    # selected: forward-identical, and no 0 * inf reaches the backward.
    t_is0 = (t == 0).reshape(t.shape + (1,) * (x0.ndim - t.ndim))
    kl = _normal_kl(true_mean, true_logvar, model_mean,
                    torch.where(t_is0, true_logvar, model_logvar))
    kl = cmean(kl) / math.log(2.0)
    nll = -_discretized_gaussian_log_likelihood(
        x0, model_mean, 0.5 * torch.where(t_is0, model_logvar, true_logvar))
    nll = cmean(nll) / math.log(2.0)
    vb = torch.where(t == 0, nll, kl)
    return {"loss": mse + vb, "mse": mse, "vb": vb}


def _p_sample_step(sched: DiffusionSchedule, x: torch.Tensor, idx: int,
                   out: torch.Tensor, z: torch.Tensor, temperature: float,
                   clip_denoised: bool) -> torch.Tensor:
    """One ancestral-sampling update from the net output `out` (..., 2C) =
    [eps, v] for step `idx`, with the step's normals `z`."""
    C = x.shape[-1]
    eps, v = out[..., :C], out[..., C:]
    x0_pred = predict_x0_from_eps(sched, x, idx, eps)
    if clip_denoised:
        x0_pred = torch.clamp(x0_pred, -1.0, 1.0)
    mean = q_posterior_mean(sched, x0_pred, x, idx)
    logvar = learned_range_log_variance(sched, idx, v)
    nonzero = float(idx != 0)
    return mean + nonzero * torch.exp(0.5 * logvar) * z * temperature


def _normals(zs: Optional[torch.Tensor], i: int, like: torch.Tensor,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    if zs is not None:
        return zs[i]
    return torch.randn(like.shape, generator=generator, device=like.device,
                       dtype=torch.float32)


@torch.no_grad()
def p_sample_loop(net_apply: Callable, sched: DiffusionSchedule,
                  noise: torch.Tensor, cond, generator: Optional[torch.Generator] = None,
                  *, temperature: float = 1.0, clip_denoised: bool = False,
                  zs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Ancestral sampling from step K-1 down to 0. `net_apply(x, t, cond)`
    receives the ORIGINAL timestep (`timestep_map`) as a (N,) tensor."""
    x = noise
    K = sched.num_timesteps
    for i in range(K):
        idx = K - 1 - i
        t = torch.full((x.shape[0],), int(sched.timestep_map[idx]),
                       dtype=torch.long, device=x.device)
        out = net_apply(x, t, cond)
        z = _normals(zs, i, x, generator)
        x = _p_sample_step(sched, x, idx, out, z, temperature,
                           clip_denoised).to(noise.dtype)
    return x


@torch.no_grad()
def p_sample_loop_indexed(net_apply_idx: Callable, sched: DiffusionSchedule,
                          noise: torch.Tensor,
                          generator: Optional[torch.Generator] = None, *,
                          temperature: float = 1.0, clip_denoised: bool = False,
                          zs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`p_sample_loop` for a net keyed by the respaced step index,
    `net_apply_idx(x, idx)`: the premodulated sampler computes everything
    that depends on (t, cond) for all steps beforehand. Same draws in the
    same order as `p_sample_loop`."""
    x = noise
    K = sched.num_timesteps
    for i in range(K):
        idx = K - 1 - i
        out = net_apply_idx(x, idx)
        z = _normals(zs, i, x, generator)
        x = _p_sample_step(sched, x, idx, out, z, temperature,
                           clip_denoised).to(noise.dtype)
    return x
