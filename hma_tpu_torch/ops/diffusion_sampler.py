"""The MAR diffusion head's whole denoise loop as one kernel: K6'
(csrc/denoise_loop.cu).

K6' replaces the Pallas TPU kernel
`hma_tpu/ops/diffusion_sampler.py:_denoise_kernel` (entered through
`fused_denoise_loop`): all K steps of ancestral sampling for N token rows.
Per step the x-dependent part of SimpleMLPAdaLN runs (input_proj, depth x
[LayerNorm, modulate, fc1, SiLU, fc2, gated residual], a parameterless
final LayerNorm, modulate, final_linear), then optional classifier-free
mixing of eps, the posterior mean, the learned-range variance and the
step's noise. Everything that depends on (t, cond) alone, the adaLN
modulations `mods`, is computed beforehand for all steps by plain GEMMs
(`models.diffloss.premod_phases`), and the per-step normals `zs` are drawn
beforehand, so the kernel is a pure function of its inputs.

What bounds it on an H100: at the d512 card's shapes (K 100, N 48, C 16,
H 1024, depth 4, bf16) it needs 81 GFLOP and reads 155 MB once (mods 138
MB, weights 17 MB), so the bound is 0.08 ms, by operations. The kernel is
nowhere near it: its products are skinny (48 x 1024 x 1024), every layer
needs the whole (N, H) activation of the one before, and 900 dependent
products follow one another, so it is bound by latency. The TPU kernel
keeps all weights in its 100 MB fast memory; a Hopper block has 227 KB. The
design:
  - one persistent cooperative launch per call (one block per SM, grid
    sized by the occupancy query so that all blocks are co-resident), all
    K steps inside, `cooperative_groups` grid syncs between the phases
    (3 depth + 2 a step);
  - a row phase computes each row's LayerNorm and modulation once a layer:
    the rows are dealt over the warps of the whole grid, a warp holds its
    row in registers and writes LN(h) (1 + scale) + shift to an (N, H)
    scratch. The step's first row phase also makes the row's x (the
    posterior update of the step before) and h = input_proj(x), so no
    block recomputes another's rows;
  - each product (fc1, fc2, final_linear) reads that scratch, or fc1's
    output, as a plain tile and is split over its output columns in tiles
    of 8, dealt round-robin over the SMs. In bf16 a block stages its 8
    weight rows and up to 80 activation rows in shared memory with 16-byte
    `cp.async` copies, all in flight at once, and its warps run the
    products on the tensor cores (`mma.sync` m16n8k16, fp32 accumulators,
    k split over the warps, the partial sums added in shared memory in a
    fixed order); in fp32, which the tensor cores cannot multiply in full
    precision, a warp takes one column and 24 rows on CUDA cores;
  - weights are read from global memory (they stay in the 50 MB L2 across
    steps); x lives in a ping-pong fp32 scratch.
Weights resident in shared memory, prefetch of the next step's mods,
`wgmma`, clusters and 2-D tiles at N 512 are later work.

Numerics (the contract of the TPU kernel, mirrored op for op by
`fused_denoise_loop_plain`): every product takes inputs in the compute
dtype, accumulates in fp32, rounds to the compute dtype and then adds the
bias in that dtype; LayerNorm in fp32 (the flax fast-variance form, or the
`jnp.var` form with `domain_ln`), result cast down; modulation and the
gated residual in the compute dtype; SiLU as x * sigmoid(x) in fp32; the
net returns fp32 and x, the posterior update and the noise stay fp32.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from hma_tpu_torch.ops._build import launch_denoise_loop
from hma_tpu_torch.parallel.distributed import draw_rows

LN_EPS = 1e-6
MAX_C = 64  # K6' takes C <= MAX_C and H a multiple of 128 up to MAX_H:
MAX_H = 1152  # its tiles of 48 fp32 or 80 + 8 bf16 rows must fit shared memory


def layer_norm(x32: torch.Tensor, scale, bias, *, domain: bool) -> torch.Tensor:
    """fp32 LayerNorm(eps=1e-6) over the last axis. domain=False: var =
    max(0, E[x^2] - E[x]^2); domain=True: var = E[(x - E[x])^2].
    scale/bias None: the parameterless final LayerNorm."""
    mu = x32.mean(-1, keepdim=True)
    if domain:
        var = (x32 - mu).square().mean(-1, keepdim=True)
        y = (x32 - mu) * torch.rsqrt(var + LN_EPS)
        if scale is not None:
            y = y * scale + bias
        return y
    mu2 = x32.square().mean(-1, keepdim=True)
    var = torch.clamp(mu2 - mu.square(), min=0.0)
    mul = torch.rsqrt(var + LN_EPS)
    if scale is not None:
        mul = mul * scale
    y = (x32 - mu) * mul
    if bias is not None:
        y = y + bias
    return y


def _acc(dtype):
    """The type of x, LayerNorm, SiLU and the net's output: fp32, or fp64
    for an fp64 computation."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _dot(a: torch.Tensor, p: dict, dtype) -> torch.Tensor:
    """a @ kernel with fp32 accumulation, rounded to `dtype`, then + bias
    in `dtype`."""
    y = (a.to(dtype) @ p["kernel"].to(dtype)).to(dtype)
    return y + p["bias"].to(dtype)


def denoise_net_plain(x: torch.Tensor, mods_k: torch.Tensor, fc_params: dict, *,
                      depth: int, domain_ln: bool, dtype) -> torch.Tensor:
    """The residual MLP on rows x (N, C) in `dtype` with one step's
    modulations mods_k (N, depth*3H + 2H); returns (N, 2C) fp32 (fp64
    when `dtype` is: the exact-arithmetic witness of the checks)."""
    H = fc_params["input_proj"]["kernel"].shape[-1]
    acc = _acc(dtype)
    h = _dot(x, fc_params["input_proj"], dtype)
    for j in range(depth):
        off = j * 3 * H
        shift = mods_k[:, off:off + H]
        scale = mods_k[:, off + H:off + 2 * H]
        gate = mods_k[:, off + 2 * H:off + 3 * H]
        ln = fc_params[f"res_{j}_ln"]
        hn = layer_norm(h.to(acc), ln["scale"].to(acc), ln["bias"].to(acc),
                        domain=domain_ln).to(dtype)
        hh = hn * (1 + scale) + shift
        hh = _dot(hh, fc_params[f"res_{j}_fc1"], dtype)
        hh = (hh.to(acc) * torch.sigmoid(hh.to(acc))).to(dtype)
        hh = _dot(hh, fc_params[f"res_{j}_fc2"], dtype)
        h = h + gate * hh
    off = depth * 3 * H
    shift = mods_k[:, off:off + H]
    scale = mods_k[:, off + H:off + 2 * H]
    hn = layer_norm(h.to(acc), None, None, domain=False)
    hh = hn.to(dtype) * (1 + scale) + shift
    return _dot(hh, fc_params["final_linear"], dtype).to(acc)


def denoise_step_plain(x: torch.Tensor, z: torch.Tensor, mods_k: torch.Tensor,
                       sched_row: torch.Tensor, fc_params: dict, *, depth: int,
                       temperature: float, clip_denoised: bool, domain_ln: bool,
                       n_half: int, cfg: float, dtype, nonzero: float) -> torch.Tensor:
    """One step of the loop: x (N, C) fp32 -> x (N, C) fp32 with the step's
    normals z, modulations mods_k and schedule row sched_row (8,).
    `nonzero` is the gate on the noise, 0 at the last step (idx = 0)."""
    C = x.shape[1]
    net = dict(depth=depth, domain_ln=domain_ln, dtype=dtype)
    if n_half > 0:
        # rows: [cond (n) | uncond (n) | tail]; the net sees the cond rows twice
        half = x[:n_half].to(dtype)
        out = denoise_net_plain(torch.cat([half, half, x[2 * n_half:].to(dtype)]),
                                mods_k, fc_params, **net)
        eps, rest = out[:, :C], out[:, C:]
        cond_eps, uncond_eps = eps[:n_half], eps[n_half:2 * n_half]
        half_eps = uncond_eps + cfg * (cond_eps - uncond_eps)
        eps = torch.cat([half_eps, half_eps, eps[2 * n_half:]])
    else:
        out = denoise_net_plain(x.to(dtype), mods_k, fc_params, **net)
        eps, rest = out[:, :C], out[:, C:]
    srac, srm1, pmc1, pmc2, minlog, maxlog = sched_row[:6].unbind()
    x0p = srac * x - srm1 * eps
    if clip_denoised:
        x0p = torch.clamp(x0p, -1.0, 1.0)
    mean = pmc1 * x0p + pmc2 * x
    frac = torch.clamp((rest + 1.0) / 2.0, 0.0, 1.0)
    logvar = frac * maxlog + (1.0 - frac) * minlog
    return mean + nonzero * torch.exp(0.5 * logvar) * z.to(x.dtype) * temperature


@torch.no_grad()
def fused_denoise_loop_plain(x_noise: torch.Tensor, zs: torch.Tensor,
                             mods: torch.Tensor, sched_tbl: torch.Tensor,
                             fc_params: dict, *, depth: int, temperature: float,
                             clip_denoised: bool, domain_ln: bool, n_half: int = 0,
                             cfg: float = 1.0, dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of K6': a Python loop over the K steps with the
    kernel's roundings. Arguments as `fused_denoise_loop`; dtype may also
    be fp64, in which x and every sum are fp64 too."""
    K = zs.shape[0]
    x = x_noise.to(_acc(dtype))
    for i in range(K):
        idx = K - 1 - i
        x = denoise_step_plain(
            x, zs[i], mods[idx], sched_tbl[idx], fc_params, depth=depth,
            temperature=temperature, clip_denoised=clip_denoised,
            domain_ln=domain_ln, n_half=n_half, cfg=cfg, dtype=dtype,
            nonzero=float(idx != 0))
    return x


def pack_weights(fc_params: dict, depth: int, dtype):
    """The kernel's two weight buffers: every kernel and bias flattened in
    the order the kernel walks them, in `dtype`, the kernels transposed to
    (out, in) but input_proj's, kept (in, out); and the LayerNorm scales and
    biases in fp32."""
    def linear(name, transpose=True):
        p = fc_params[name]
        kernel = p["kernel"].to(dtype)
        return [(kernel.t() if transpose else kernel).reshape(-1),
                p["bias"].to(dtype).reshape(-1)]

    parts = linear("input_proj", transpose=False)
    for j in range(depth):
        parts += linear(f"res_{j}_fc1") + linear(f"res_{j}_fc2")
    parts += linear("final_linear")
    ln = [fc_params[f"res_{j}_ln"][k].float().reshape(-1)
          for j in range(depth) for k in ("scale", "bias")]
    return torch.cat(parts), torch.cat(ln) if ln else torch.zeros(0, device=parts[0].device)


@torch.no_grad()
def fused_denoise_loop(x_noise: torch.Tensor, zs: torch.Tensor, mods: torch.Tensor,
                       sched_tbl: torch.Tensor, fc_params: dict, *, depth: int,
                       temperature: float, clip_denoised: bool, domain_ln: bool,
                       n_half: int = 0, cfg: float = 1.0, dtype=torch.bfloat16,
                       packed=None) -> torch.Tensor:
    """Run the K-step ancestral loop; returns x (N, C) fp32.

    x_noise (N, C) fp32; zs (K, N, C) fp32, the per-step normals in loop
    order (zs[i] belongs to idx = K-1-i); mods (K, N, depth*3H + 2H) the
    premodulations in `dtype`; sched_tbl (K, 8) fp32 rows
    [sqrt_recip_ac, sqrt_recipm1_ac, post_mean_c1, post_mean_c2,
    post_logvar_clipped, log_betas, 0, 0]; fc_params with keys
    input_proj / res_{j}_ln / res_{j}_fc1 / res_{j}_fc2 / final_linear, each
    {kernel (in, out), bias} ({scale, bias} for the LayerNorms), already
    sliced to one domain. With n_half > 0 the rows are [cond | uncond |
    tail] and eps of both halves is uncond + cfg * (cond - uncond).

    CPU tensors take the plain version; CUDA tensors launch K6' or raise
    (dtype fp32 or bf16, H a multiple of 128 up to 1152, C <= 64).
    `packed` is `pack_weights(fc_params, depth, dtype)` made ahead by a
    caller whose weights are frozen; without it they are packed here.
    """
    kw = dict(depth=depth, temperature=float(temperature),
              clip_denoised=bool(clip_denoised), domain_ln=bool(domain_ln),
              n_half=int(n_half), cfg=float(cfg), dtype=dtype)
    if x_noise.device.type == "cpu":
        return fused_denoise_loop_plain(x_noise, zs, mods, sched_tbl, fc_params, **kw)
    if x_noise.device.type != "cuda":
        raise ValueError(f"fused_denoise_loop: unsupported device {x_noise.device}")
    N, C = x_noise.shape
    K = zs.shape[0]
    H = fc_params["input_proj"]["kernel"].shape[-1]
    M = depth * 3 * H + 2 * H
    if (zs.shape != (K, N, C) or mods.shape != (K, N, M)
            or sched_tbl.shape != (K, 8) or not 0 <= 2 * n_half <= N):
        raise ValueError(
            f"fused_denoise_loop: x {tuple(x_noise.shape)}, zs {tuple(zs.shape)}, "
            f"mods {tuple(mods.shape)} (want {(K, N, M)}), sched "
            f"{tuple(sched_tbl.shape)}, n_half {n_half}")
    if H % 128 or not 0 < H <= MAX_H or not 0 < C <= MAX_C or K < 1 or N < 1:
        raise ValueError(f"fused_denoise_loop: needs H % 128 == 0, H <= {MAX_H}, "
                         f"C <= {MAX_C}, got H {H}, C {C}, K {K}, N {N}")
    weights, ln = packed if packed is not None else pack_weights(fc_params, depth, dtype)
    out = launch_denoise_loop(
        x_noise.float().contiguous(), zs.float().contiguous(),
        mods.to(dtype).contiguous(), sched_tbl.float().contiguous(), weights, ln,
        K=K, N=N, C=C, H=H, depth=depth, dtype=dtype,
        clip_denoised=bool(clip_denoised), domain_ln=bool(domain_ln),
        n_half=int(n_half), cfg=float(cfg), temperature=float(temperature))
    fused_denoise_loop.launches += 1
    return out


fused_denoise_loop.launches = 0


def pregenerate_noises(generator: Optional[torch.Generator], K: int, N: int,
                       C: int, device, blocks: int = 1) -> torch.Tensor:
    """The per-step normals (K, N, C) fp32 in loop order, one draw of (N, C)
    per step as `p_sample_loop` makes them; the N rows are `blocks` blocks
    of the batch's (2 under cfg: [cond | uncond]; `distributed.draw_rows`)."""
    draw = lambda m, g: torch.randn(m, C, generator=g, device=device)
    return torch.stack([draw_rows(draw, N, generator, blocks) for _ in range(K)])


def schedule_table(sched) -> np.ndarray:
    """(K, 8) fp32 schedule rows for `fused_denoise_loop`."""
    K = sched.num_timesteps
    tbl = np.zeros((K, 8), np.float32)
    tbl[:, 0] = sched.sqrt_recip_alphas_cumprod
    tbl[:, 1] = sched.sqrt_recipm1_alphas_cumprod
    tbl[:, 2] = sched.posterior_mean_coef1
    tbl[:, 3] = sched.posterior_mean_coef2
    tbl[:, 4] = sched.posterior_log_variance_clipped
    tbl[:, 5] = np.log(np.maximum(sched.betas, 1e-20))
    return tbl
