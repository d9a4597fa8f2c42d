"""MAR diffusion head: an adaLN-modulated residual MLP and its sampler
(counterpart of hma_tpu/models/diffloss.py).

A per-token `SimpleMLPAdaLN` predicts (eps, v) from a noisy latent row, its
timestep and the trunk's conditioning row; a domain-stacked variant serves
the per-embodiment action heads. `DiffLoss.sample` runs ancestral sampling
over the respaced schedule (default "100" steps of the 1000-step cosine
schedule). The sampler is premodulated: everything that depends on (t,
cond) alone, the timestep and cond embeddings and every adaLN modulation,
is computed for all K steps in one batched pass of plain GEMMs
(`premod_phases`' `precompute`), and the sequential loop, which touches only
input_proj / fc1 / fc2 / final_linear, is one launch of the fused denoise
loop (`ops.diffusion_sampler.fused_denoise_loop`, K6' on a CUDA tensor, its
plain version on a CPU tensor). `sample(premod=False)` evaluates the whole
net at every step and is the oracle the premodulated path is tested against.

`DiffLoss.loss` is the training loss: per-row timesteps in [0, 1000) of
the unrespaced cosine schedule and Gaussian noise, drawn from a generator
or handed in as tensors, through `diffusion.gaussian.training_losses`.

The two LayerNorm forms differ and both are kept: the plain head uses flax's
fast-variance form max(0, E[x^2] - E[x]^2) (`attention.LayerNorm`), the
domain head E[(x - E[x])^2] (`action_stems.DomainLayerNorm`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.distributed.fsdp import FSDPModule
from torch.nn import functional as F

from hma_tpu_torch.diffusion.gaussian import (
    make_schedule,
    p_sample_loop,
    training_losses,
)
from hma_tpu_torch.models.action_stems import DomainDense, DomainLayerNorm
from hma_tpu_torch.models.attention import Dense, LayerNorm
from hma_tpu_torch.ops.diffusion_sampler import (
    fused_denoise_loop,
    layer_norm,
    pack_weights,
    pregenerate_noises,
    schedule_table,
)
from hma_tpu_torch.parallel.distributed import draw_rows, global_count


def timestep_embedding(t: torch.Tensor, dim: int, max_period: int = 10000) -> torch.Tensor:
    """DiT sinusoidal embedding (N, dim) fp32 of timesteps t (N,), cosines
    first."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def _final_ln(h: torch.Tensor) -> torch.Tensor:
    """The parameterless fp32 LayerNorm(eps=1e-6), fast-variance form."""
    return layer_norm(h.float(), None, None, domain=False)


class _TimestepEmbedder(nn.Module):
    def __init__(self, hidden: int, freq_dim: int = 256, dtype=torch.bfloat16,
                 device="cuda"):
        super().__init__()
        self.freq_dim = freq_dim
        self.fc1 = Dense(freq_dim, hidden, True, dtype, device)
        self.fc2 = Dense(hidden, hidden, True, dtype, device)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.silu(self.fc1(timestep_embedding(t, self.freq_dim))))


class SimpleMLPAdaLN(nn.Module):
    """Residual MLP with adaLN conditioning.

    forward(x (N, C), t (N,), c (N, Z)) -> (N, 2C) fp32: [eps, v].
    """

    def __init__(self, in_channels: int, model_channels: int, z_channels: int,
                 num_res_blocks: int, dtype=torch.bfloat16, device="cuda"):
        super().__init__()
        H = model_channels
        kw = dict(dtype=dtype, device=device)
        self.dtype = dtype
        self.num_res_blocks = num_res_blocks
        self.input_proj = Dense(in_channels, H, **kw)
        self.time_embed = _TimestepEmbedder(H, **kw)
        self.cond_embed = Dense(z_channels, H, **kw)
        for i in range(num_res_blocks):
            setattr(self, f"res_{i}_adaLN", Dense(H, 3 * H, **kw))
            setattr(self, f"res_{i}_ln", LayerNorm(H, eps=1e-6, device=device))
            setattr(self, f"res_{i}_fc1", Dense(H, H, **kw))
            setattr(self, f"res_{i}_fc2", Dense(H, H, **kw))
        self.final_adaLN = Dense(H, 2 * H, **kw)
        self.final_linear = Dense(H, 2 * in_channels, **kw)

    def forward(self, x: torch.Tensor, t: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        h = self.input_proj(x.to(self.dtype))
        y = self.time_embed(t) + self.cond_embed(c.to(self.dtype))
        sy = F.silu(y)
        for i in range(self.num_res_blocks):
            shift, scale, gate = getattr(self, f"res_{i}_adaLN")(sy).chunk(3, dim=-1)
            hn = getattr(self, f"res_{i}_ln")(h).to(self.dtype)
            hh = hn * (1 + scale) + shift
            hh = getattr(self, f"res_{i}_fc1")(hh)
            hh = getattr(self, f"res_{i}_fc2")(F.silu(hh))
            h = h + gate * hh
        shift, scale = self.final_adaLN(sy).chunk(2, dim=-1)
        hh = _final_ln(h).to(self.dtype) * (1 + scale) + shift
        return self.final_linear(hh).float()


class DomainSimpleMLPAdaLN(nn.Module):
    """Per-domain stacked SimpleMLPAdaLN (the action diffusion heads).

    Channels are padded to `in_channels` = max_d_action across domains and
    the output layout is [eps (max) | v (max)]. Every parameter group has a
    leading domain axis, the timestep embedder and the LayerNorms too.
    """

    def __init__(self, num_domains: int, in_channels: int, model_channels: int,
                 z_channels: int, num_res_blocks: int, dtype=torch.bfloat16,
                 device="cuda"):
        super().__init__()
        H, nd = model_channels, num_domains
        kw = dict(init_gain=0.1, dtype=dtype, device=device)
        self.dtype = dtype
        self.num_res_blocks = num_res_blocks
        self.input_proj = DomainDense(nd, in_channels, H, **kw)
        self.time_fc1 = DomainDense(nd, 256, H, **kw)
        self.time_fc2 = DomainDense(nd, H, H, **kw)
        self.cond_embed = DomainDense(nd, z_channels, H, **kw)
        for i in range(num_res_blocks):
            setattr(self, f"res_{i}_adaLN", DomainDense(nd, H, 3 * H, **kw))
            setattr(self, f"res_{i}_ln", DomainLayerNorm(nd, H, epsilon=1e-6, dtype=dtype,
                                                         device=device))
            setattr(self, f"res_{i}_fc1", DomainDense(nd, H, H, **kw))
            setattr(self, f"res_{i}_fc2", DomainDense(nd, H, H, **kw))
        self.final_adaLN = DomainDense(nd, H, 2 * H, **kw)
        self.final_linear = DomainDense(nd, H, 2 * in_channels, **kw)

    def forward(self, x: torch.Tensor, t: torch.Tensor, c: torch.Tensor,
                domain_id: int) -> torch.Tensor:
        d = domain_id
        h = self.input_proj(x, d)
        t_emb = self.time_fc1(timestep_embedding(t, 256).to(self.dtype), d)
        t_emb = self.time_fc2(F.silu(t_emb), d)
        sy = F.silu(t_emb + self.cond_embed(c, d))
        for i in range(self.num_res_blocks):
            shift, scale, gate = getattr(self, f"res_{i}_adaLN")(sy, d).chunk(3, dim=-1)
            hn = getattr(self, f"res_{i}_ln")(h, d)
            hh = hn * (1 + scale) + shift
            hh = getattr(self, f"res_{i}_fc1")(hh, d)
            hh = getattr(self, f"res_{i}_fc2")(F.silu(hh), d)
            h = h + gate * hh
        shift, scale = self.final_adaLN(sy, d).chunk(2, dim=-1)
        hh = _final_ln(h).to(self.dtype) * (1 + scale) + shift
        return self.final_linear(hh, d).float()


def premod_phases(net: nn.Module, domain_id: Optional[int] = None):
    """Split a SimpleMLPAdaLN (domain_id None) or DomainSimpleMLPAdaLN into
    the two phases of sampling:

      precompute(t_all (K,), c (N, Z)) -> mods   # all (t, c)-dependent work
      residual(x (N, C), mods_k) -> (N, 2C)      # the x-dependent MLP

    x is the only quantity that changes between denoise steps, so the
    timestep / cond embeddings and every adaLN modulation are computed for
    all K steps in one batched pass; the sequential loop then touches only
    input_proj / fc1 / fc2 / final_linear and the small mod rows. `mods` is
    {"blocks": tuple of (K, N, 3H), "final": (K, N, 2H)}; `residual` takes
    one step's slice of it. Op for op the modules' `forward`.
    """
    dtype, depth = net.dtype, net.num_res_blocks
    if domain_id is None:
        dense = lambda name, x: getattr(net, name)(x)
    else:
        dense = lambda name, x: getattr(net, name)(x, domain_id)

    def precompute(t_all: torch.Tensor, c: torch.Tensor) -> dict:
        if domain_id is None:
            t_emb = net.time_embed(t_all)
        else:
            t_emb = dense("time_fc1", timestep_embedding(t_all, 256).to(dtype))
            t_emb = dense("time_fc2", F.silu(t_emb))
        c_emb = dense("cond_embed", c.to(dtype))
        sy = F.silu(t_emb[:, None, :] + c_emb[None, :, :])  # (K, N, H)
        return {"blocks": tuple(dense(f"res_{i}_adaLN", sy) for i in range(depth)),
                "final": dense("final_adaLN", sy)}

    def residual(x: torch.Tensor, mods_k: dict) -> torch.Tensor:
        h = dense("input_proj", x.to(dtype))
        for i in range(depth):
            shift, scale, gate = mods_k["blocks"][i].chunk(3, dim=-1)
            hn = dense(f"res_{i}_ln", h).to(dtype)
            hh = hn * (1 + scale) + shift
            hh = dense(f"res_{i}_fc1", hh)
            hh = dense(f"res_{i}_fc2", F.silu(hh))
            h = h + gate * hh
        shift, scale = mods_k["final"].chunk(2, dim=-1)
        hh = _final_ln(h).to(dtype) * (1 + scale) + shift
        return dense("final_linear", hh).float()

    return precompute, residual


class DiffLoss(nn.Module):
    """Diffusion head: `sample(z (N, Z) [or (2N, Z) with cfg != 1], ...)`
    -> (N or 2N, C) fp32. `num_domains` > 0 builds the domain-stacked net."""

    def __init__(self, target_channels: int, z_channels: int, depth: int, width: int,
                 num_sampling_steps: str = "100", num_domains: int = 0,
                 dtype=torch.bfloat16, device="cuda"):
        super().__init__()
        self.target_channels = target_channels
        self.depth = depth
        self.width = width
        self.num_domains = num_domains
        self.dtype = dtype
        if num_domains > 0:
            self.net = DomainSimpleMLPAdaLN(num_domains, target_channels, width,
                                            z_channels, depth, dtype, device)
        else:
            self.net = SimpleMLPAdaLN(target_channels, width, z_channels, depth,
                                      dtype, device)
        self.train_sched = make_schedule("cosine", 1000, "")
        self.gen_sched = make_schedule("cosine", 1000, num_sampling_steps)
        self._loop_cache = {}  # see _loop_kernel_inputs

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The JAX head's init: xavier-uniform(gain 0.1) linears (over flax's
        fans for the stacked tables), N(0, 0.02) timestep embedder, zero
        adaLN and final linears (DiT style), zero biases, unit LayerNorms."""
        for name, mod in self.net.named_modules():
            leaf = name.rsplit(".", 1)[-1]
            zero = leaf.endswith("adaLN") or leaf == "final_linear"
            normal = name.startswith("time_")
            if isinstance(mod, Dense):
                fan_out, fan_in = mod.weight.shape
                if zero:
                    mod.weight.zero_()
                elif normal:
                    mod.weight.normal_(0.0, 0.02, generator=generator)
                else:
                    b = 0.1 * math.sqrt(6.0 / (fan_in + fan_out))
                    mod.weight.uniform_(-b, b, generator=generator)
                mod.bias.zero_()
            elif isinstance(mod, DomainDense):
                nd, fan_in, fan_out = mod.kernel.shape
                if zero:
                    mod.kernel.zero_()
                elif normal:
                    mod.kernel.normal_(0.0, 0.02, generator=generator)
                else:
                    b = 0.1 * math.sqrt(6.0 / (nd * fan_in + nd * fan_out))
                    mod.kernel.uniform_(-b, b, generator=generator)
                mod.bias.zero_()

    def _apply_net(self, domain_id):
        if self.num_domains > 0:
            return lambda x, t, c: self.net(x, t, c, domain_id)
        return self.net

    def loss(self, target: torch.Tensor, z: torch.Tensor,
             mask: Optional[torch.Tensor] = None, domain_id: Optional[int] = None,
             dim_mask: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None, *,
             t: Optional[torch.Tensor] = None,
             noise: Optional[torch.Tensor] = None, group=None,
             blocks: int = 1) -> torch.Tensor:
        """Masked diffusion loss over token rows: target (N, C), z (N, Z),
        mask (N,) weights of the rows that count (all, when None); dim_mask
        (C,) the channels that exist (padded action channels are hidden
        from the net and left out of the mean).

        The draws, per-row timesteps t (N,) and noise (N, C), come from
        `generator`, t first, or are handed in; the rows are `blocks` tiled
        copies of the batch's (`distributed.draw_rows`). With `group` (data
        parallelism) the mask's count is summed over its ranks."""
        N, dev = target.shape[0], target.device
        if t is None:
            K = self.train_sched.num_timesteps
            t = draw_rows(lambda m, g: torch.randint(0, K, (m,), generator=g, device=dev),
                          N, generator, blocks)
        if noise is None:
            noise = draw_rows(lambda m, g: torch.randn(m, *target.shape[1:], generator=g,
                                                       device=dev), N, generator, blocks)
        net = self._apply_net(domain_id)
        if dim_mask is not None:
            base = net
            net = lambda x, tt, c: base(x * dim_mask, tt, c)
            target = target * dim_mask
        out = training_losses(net, self.train_sched, target, t, z, noise,
                              channel_mask=dim_mask)
        loss = out["loss"]
        if mask is None:
            return loss.mean()
        return (loss * mask).sum() / (global_count(mask.sum(), group) + 1e-8)

    @torch.no_grad()
    def sample(self, z: torch.Tensor, generator: Optional[torch.Generator] = None,
               temperature: float = 1.0, cfg: float = 1.0,
               clip_denoised: bool = False, domain_id: Optional[int] = None,
               premod: bool = True, *, noise: Optional[torch.Tensor] = None,
               zs: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Ancestral sampling. With cfg != 1, z is (2N, Z) [cond; uncond] and
        both halves of the returned (2N, C) start from the same noise and
        take the same mixed eps.

        Draws come from `generator`, or are handed in: `noise` (N, C), the
        start ((N/2, C) under cfg, shared by both halves), and `zs`
        (K, N, C), the per-step normals in loop order.

        premod=True (default) is the premodulated sampler through the fused
        denoise loop; premod=False evaluates the whole net at every step.
        """
        if premod:
            return self._sample_premod(z, generator, temperature, cfg, clip_denoised,
                                       domain_id, noise, zs)
        net = self._apply_net(domain_id)
        C = self.target_channels
        noise, n_half = self._start_noise(z, generator, cfg, noise)
        if zs is None:  # the per-step normals, drawn in loop order as the loop would
            zs = pregenerate_noises(generator, self.gen_sched.num_timesteps, z.shape[0], C,
                                    z.device, 2 if n_half else 1)
        if n_half:
            n = n_half

            def fn(x, t, c):
                half = x[:n]
                out = net(torch.cat([half, half]), t, c)
                eps, rest = out[..., :C], out[..., C:]
                cond_eps, uncond_eps = eps[:n], eps[n:]
                half_eps = uncond_eps + cfg * (cond_eps - uncond_eps)
                return torch.cat([torch.cat([half_eps, half_eps]), rest], dim=-1)
        else:
            fn = net
        return p_sample_loop(fn, self.gen_sched, noise, z, generator,
                             temperature=temperature, clip_denoised=clip_denoised,
                             zs=zs)

    def _start_noise(self, z, generator, cfg, noise):
        """(start noise (N, C) fp32, n_half): under cfg one draw of (N/2, C)
        serves both halves."""
        C = self.target_channels
        n_half = z.shape[0] // 2 if cfg != 1.0 else 0
        rows = n_half or z.shape[0]
        if noise is None:
            noise = draw_rows(lambda m, g: torch.randn(m, C, generator=g, device=z.device),
                              rows, generator)
        if tuple(noise.shape) != (rows, C):
            raise ValueError(f"noise must be {(rows, C)}, got {tuple(noise.shape)}")
        noise = noise.float()
        return (torch.cat([noise, noise]) if n_half else noise), n_half

    def _sample_premod(self, z, generator, temperature, cfg, clip_denoised,
                       domain_id, noise, zs):
        """`sample` through `premod_phases`' precompute and the fused loop."""
        sched = self.gen_sched
        precompute, _ = premod_phases(
            self.net, domain_id if self.num_domains > 0 else None)
        t_all = torch.from_numpy(sched.timestep_map).to(z.device)  # original timesteps
        mods = precompute(t_all, z)
        return self._sample_kernel(z, generator, mods, float(temperature), float(cfg),
                                   clip_denoised, domain_id, noise, zs)

    def _loop_kernel_fc_params(self, domain_id):
        """The sequential phase's weights as `fused_denoise_loop` takes them:
        {kernel (in, out), bias} in the compute dtype per linear, {scale,
        bias} fp32 per LayerNorm, the domain net sliced at `domain_id`."""
        fc = {}
        names = (["input_proj", "final_linear"]
                 + [f"res_{j}_fc{k}" for j in range(self.depth) for k in (1, 2)])
        for name in names:
            mod = getattr(self.net, name)
            if self.num_domains > 0:
                kernel, bias = mod.kernel[domain_id], mod.bias[domain_id]
            else:
                kernel, bias = mod.weight.t(), mod.bias
            fc[name] = {"kernel": kernel.to(self.dtype), "bias": bias.to(self.dtype)}
        for j in range(self.depth):
            ln = getattr(self.net, f"res_{j}_ln")
            if self.num_domains > 0:
                fc[f"res_{j}_ln"] = {"scale": ln.scale[domain_id],
                                     "bias": ln.bias[domain_id]}
            else:
                fc[f"res_{j}_ln"] = {"scale": ln.weight, "bias": ln.bias}
        return fc

    def _sample_kernel(self, z, generator, mods, temperature, cfg, clip_denoised,
                       domain_id, noise, zs):
        sched = self.gen_sched
        N, C, K = z.shape[0], self.target_channels, sched.num_timesteps
        noise, n_half = self._start_noise(z, generator, cfg, noise)
        if zs is None:
            zs = pregenerate_noises(generator, K, N, C, z.device, 2 if n_half else 1)
        mods_cat = torch.cat(list(mods["blocks"]) + [mods["final"]], dim=-1)
        fc, tbl, packed = self._loop_kernel_inputs(domain_id, z.device)
        return fused_denoise_loop(
            noise, zs, mods_cat, tbl, fc,
            depth=self.depth, temperature=temperature, clip_denoised=clip_denoised,
            domain_ln=self.num_domains > 0, n_half=n_half, cfg=cfg, dtype=self.dtype,
            packed=packed)

    def _loop_kernel_inputs(self, domain_id, device):
        """(fc_params, schedule table, packed weights) of one domain on
        `device`, made once and kept while the head's parameters stay as they
        are: a rollout samples 16 times a frame from frozen weights. The
        packed buffers are the kernel's and are None on the CPU.

        A head sharded by FSDP2 (`parallel.mesh.shard_model`) samples inside
        its gathered `sample`; its whole parameters live in storage that
        FSDP2 frees after the call and refills, with new values, at the next,
        so nothing is kept: they are read (and packed) at every call."""
        sharded = isinstance(self, FSDPModule)
        if not sharded:
            state = tuple((p.data_ptr(), p._version) for p in self.net.parameters())
            key = (domain_id, str(device))
            hit = self._loop_cache.get(key)
            if hit is not None and hit[0] == state:
                return hit[1:]
        fc = self._loop_kernel_fc_params(domain_id)
        tbl = torch.from_numpy(schedule_table(self.gen_sched)).to(device)
        packed = pack_weights(fc, self.depth, self.dtype) if device.type == "cuda" else None
        if not sharded:
            self._loop_cache[key] = (state, fc, tbl, packed)
        return fc, tbl, packed
