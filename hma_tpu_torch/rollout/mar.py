"""MAR-style continuous-latent rollout with a temporal KV cache
(counterpart of hma_tpu/rollout/mar.py).

Frames are decoded autoregressively; within a frame a random generation
order unmasks patch subsets on a cosine count schedule, and each newly
revealed subset's latents are sampled from the per-token diffusion head
conditioned on the trunk output. The trunk runs the KV-cached single-frame
path (`STMAR.frame_latents`) against read-only caches, and one more pass per
generated frame writes the finished frame into them. Subset sizes depend
only on seq_len and maskgit_steps, so every step gathers a fixed number of
rows, `max(counts)`, padded modulo S exactly as the JAX engine pads them: the
row layout, and with it the place of every random draw, is the same in both
packages. Python loops stand where the JAX file has `lax.scan`s.
`generate_latents_reference_algo` is the reference algorithm, a full
T-frame forward per refinement step and every scheduled position re-sampled
at every step.

Random draws come from a `torch.Generator` or, since `jax.random` and torch
never give the same numbers, are handed in as `draws`, a dict of tensors
with a leading axis over the generated frames:
  "orders" (F, B, S) int64, each row a permutation of the S patch positions
           ((F, B/2, S) under cfg: both halves share their orders);
  "noise"  (F, steps, N, C) the start noise of each step's sampler call, N
           = B * max(counts) rows ((F, steps, N/2, C) under cfg);
  "zs"     (F, steps, K, N, C) the K per-step normals of each call in loop
           order (zs[..., i, :, :] belongs to schedule index K-1-i).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from hma_tpu_torch.models.st_mar import STMAR, patchify, unpatchify
from hma_tpu_torch.parallel.distributed import draw_rows


def mar_subset_schedule(seq_len: int, steps: int,
                        compat: str = "mar") -> tuple[list[int], list[int]]:
    """(starts, counts): step s samples order[starts[s] : starts[s] + counts[s]].

    compat="mar" (default; each position is sampled exactly once, when
    first revealed): masked-after-step-s = clamp(floor(seq_len * cos(pi/2 *
    (s+1)/steps)), 1, prev-1), 0 after the final step, and step s reveals
    order[nxt : prev].

    compat="reference": the reference loop's selection, whose `unmasked`
    state is never updated, so step s re-samples EVERY position past the
    schedule point, order[nxt : seq_len] with nxt = clamp(floor(seq_len *
    cos(...)), 1, seq_len-1), and the final step all seq_len positions:
    steps * S rows of diffusion work instead of S.
    """
    if compat not in ("mar", "reference"):
        raise ValueError(f"compat {compat!r}")
    starts, counts = [], []
    prev = seq_len
    for s in range(steps):
        if s == steps - 1:
            nxt = 0
        else:
            nxt = int(np.floor(seq_len * math.cos(math.pi / 2 * (s + 1) / steps)))
            hi = seq_len - 1 if compat == "reference" else prev - 1
            nxt = max(1, min(hi, nxt))
        starts.append(nxt)
        counts.append((seq_len if compat == "reference" else prev) - nxt)
        prev = nxt
    return starts, counts


def _frame_draws(draws: Optional[dict], i: int) -> Optional[dict]:
    return None if draws is None else {k: v[i] for k, v in draws.items()}


def _orders(generator, draws: Optional[dict], B: int, S: int, device) -> torch.Tensor:
    """(B, S) generation orders, one permutation per batch row."""
    if draws is not None:
        order = draws["orders"].to(device)
        if tuple(order.shape) != (B, S):
            raise ValueError(f"orders must be {(B, S)}, got {tuple(order.shape)}")
        return order
    return draw_rows(lambda m, g: torch.stack(
        [torch.randperm(S, generator=g, device=device) for _ in range(m)]), B, generator)


def _reveal(model: STMAR, frame: torch.Tensor, z: torch.Tensor, order: torch.Tensor,
            start: int, count: int, maxc: int, generator, draws: Optional[dict],
            step: int, temperature: float, cfg: float) -> torch.Tensor:
    """Sample the `count` positions order[:, start : start + count] of
    `frame` (B, S, pd) from the head, conditioned on z (B, S, d).

    All maxc gathered rows go through the sampler. Padding entries (>=
    count) wrap modulo S onto positions outside this step's range, already
    revealed or not yet, where writing back the current value is a no-op,
    and all maxc indices stay distinct."""
    B, S, pd = frame.shape
    ar = torch.arange(maxc, device=frame.device)
    pos = order[:, (start + ar) % S]  # (B, maxc)
    z_rows = z.gather(1, pos[..., None].expand(-1, -1, z.shape[-1])).reshape(B * maxc, -1)
    given = {} if draws is None else {"noise": draws["noise"][step],
                                      "zs": draws["zs"][step]}
    # clip_denoised: latents scaled by SVD_SCALE mostly live in [-1, 1]
    sampled = model.sample_tokens(z_rows, generator, temperature, cfg, True, **given)
    sampled = sampled.reshape(B, maxc, pd).to(frame.dtype)
    at = pos[..., None].expand(-1, -1, pd)
    new = torch.where((ar < count)[None, :, None], sampled, frame.gather(1, at))
    return frame.scatter(1, at, new)


@torch.no_grad()
def generate_frame_mar(model: STMAR, t: int, k_cache, v_cache, action_ids, domain_id,
                       generator: Optional[torch.Generator] = None,
                       draws: Optional[dict] = None, *,
                       maskgit_steps: Optional[int] = None, temperature: float = 1.0,
                       cfg: float = 1.0, batch_size: int,
                       initial_patches: Optional[torch.Tensor] = None,
                       action_live: Optional[torch.Tensor] = None,
                       sampling_compat: Optional[str] = None):
    """Decode one frame of patchified latents. Returns (patches (B, S_p,
    patch_dim) fp32, action latent or None, k_cache, v_cache), the caches
    filled from the finished frame. `draws`: this frame's slice of the
    module docstring's dict.

    Classifier-free guidance (cfg != 1): the caller supplies a DOUBLED batch
    whose second half runs the no-actions branch (`action_live` = [1]*n +
    [0]*n; see `generate_latents`), the generation orders pair across the
    halves, and `DiffLoss.sample` mixes cond and uncond eps; both
    halves receive the same samples, so both cache sets stay
    consistent. The unconditional branch is the action-dropout branch the
    model trains when drop_action_ratio > 0.
    """
    cfg_model = model.config
    steps = maskgit_steps or cfg_model.maskgit_steps
    S, pd, B = model.seq_len, model.patch_dim, batch_size
    compat = sampling_compat or getattr(cfg_model, "mar_sampling_compat", "mar")
    starts, counts = mar_subset_schedule(S, steps, compat=compat)
    maxc = max(counts)
    device = k_cache.device

    if cfg != 1.0:
        if B % 2 or action_live is None:
            raise ValueError(
                "cfg != 1 requires a caller-doubled [cond | uncond] batch with "
                "action_live set (use generate_latents/teacher_forced_latents)")
        # the uncond half substitutes action_mask_tokens, which only receive
        # gradient when jointly_predict_actions=True; guiding against a
        # never-trained branch amplifies noise
        if not cfg_model.jointly_predict_actions:
            raise ValueError(
                "cfg != 1 needs a trained unconditional branch: train with "
                "jointly_predict_actions=true and drop_action_ratio > 0 so the "
                "action-mask-token branch receives gradient")
        # the same orders in both halves keep cond and uncond rows paired
        half = _orders(generator, draws, B // 2, S, device)
        order = torch.cat([half, half])
    else:
        order = _orders(generator, draws, B, S, device)

    if initial_patches is not None:
        frame = initial_patches
    else:  # fully masked: every patch row is p*p copies of the mask token
        mask_row = model.mask_token[0, 0].float().repeat(cfg_model.patch_size**2)
        frame = mask_row.expand(B, S, pd).contiguous()

    action_latent = None
    for s, (start, count) in enumerate(zip(starts, counts)):
        z, action_latent, _, _ = model.frame_latents(
            frame, t, k_cache, v_cache, action_ids, domain_id, update_cache=False,
            action_live=action_live)
        frame = _reveal(model, frame, z, order, start, count, maxc, generator, draws,
                        s, temperature, cfg)

    _, _, k_cache, v_cache = model.frame_latents(
        frame, t, k_cache, v_cache, action_ids, domain_id, action_live=action_live)
    return frame, action_latent, k_cache, v_cache


def _patches_and_cfg(model: STMAR, latents: torch.Tensor, action_ids, cfg: float):
    """(patches (B, T, S, pd), action_ids, action_live, B0): the patchified
    latents, doubled to [cond | uncond] with `action_live` set under cfg."""
    B0, T = latents.shape[:2]
    patches = patchify(latents, model.config.patch_size).flatten(2, 3)
    action_live = None
    if cfg != 1.0:
        if action_ids is None:
            raise ValueError("cfg != 1 needs action conditioning")
        patches = torch.cat([patches, patches])
        action_ids = torch.cat([action_ids, action_ids])
        action_live = torch.cat([torch.ones(B0, device=latents.device),
                                 torch.zeros(B0, device=latents.device)])
    return patches, action_ids, action_live, B0


@torch.no_grad()
def generate_latents(model: STMAR, prompt: torch.Tensor, num_prompt_frames: int,
                     action_ids, domain_id, generator: Optional[torch.Generator] = None,
                     *, maskgit_steps: Optional[int] = None, temperature: float = 1.0,
                     cfg: float = 1.0, draws: Optional[dict] = None) -> torch.Tensor:
    """KV-cached AR rollout over frames. prompt: (B, T, h, w, C) latents
    (already x SVD_SCALE); returns (B, T, h, w, C) with frames >=
    num_prompt_frames generated. Under cfg the batch is doubled to [cond |
    uncond], the uncond half taking the no-actions branch (action_live = 0)."""
    B0, T, H, W, C = prompt.shape
    p = model.config.patch_size
    out, action_ids, action_live, _ = _patches_and_cfg(model, prompt, action_ids, cfg)
    out = out.clone()
    B = out.shape[0]
    k_cache, v_cache = model.init_cache(B, with_actions=action_ids is not None)
    for t in range(num_prompt_frames):  # prefill from the prompt frames
        _, _, k_cache, v_cache = model.frame_latents(
            out[:, t], t, k_cache, v_cache, action_ids, domain_id,
            action_live=action_live)
    for i, t in enumerate(range(num_prompt_frames, T)):
        frame, _, k_cache, v_cache = generate_frame_mar(
            model, t, k_cache, v_cache, action_ids, domain_id, generator,
            _frame_draws(draws, i), maskgit_steps=maskgit_steps,
            temperature=temperature, cfg=cfg, batch_size=B, action_live=action_live)
        out[:, t] = frame.to(out.dtype)
    # cfg: the uncond half carries the same samples
    return unpatchify(out[:B0].reshape(B0, T, H // p, W // p, -1), p, C)


@torch.no_grad()
def generate_latents_reference_algo(model: STMAR, prompt: torch.Tensor,
                                    num_prompt_frames: int, action_ids, domain_id,
                                    generator: Optional[torch.Generator] = None, *,
                                    maskgit_steps: Optional[int] = None,
                                    temperature: float = 1.0,
                                    draws: Optional[dict] = None) -> torch.Tensor:
    """The reference's MAR generation algorithm: a FULL T-frame trunk
    forward per refinement step and the resample-every-step selection
    (`mar_subset_schedule(compat="reference")`).

    It is the baseline the KV-cached engine is measured against, and the
    oracle of `sampling_compat="reference"`: this function and the cached
    path with that setting consume the same draws in the same row layout,
    so they agree to rounding. No cfg path.
    """
    steps = maskgit_steps or model.config.maskgit_steps
    B, T, H, W, C = prompt.shape
    p = model.config.patch_size
    window = patchify(prompt, p).flatten(2, 3).clone()
    S, pd = window.shape[2:]
    starts, counts = mar_subset_schedule(S, steps, compat="reference")
    maxc = max(counts)
    mask_row = model.mask_token[0, 0].to(window.dtype).repeat(p**2)
    for i, t in enumerate(range(num_prompt_frames, T)):
        frame_draws = _frame_draws(draws, i)
        order = _orders(generator, frame_draws, B, S, window.device)
        window[:, t] = mask_row  # frame t starts fully masked
        for s, (start, count) in enumerate(zip(starts, counts)):
            z_all, _ = model.compute_latents(window, action_ids, domain_id)
            frame = _reveal(model, window[:, t].float(), z_all[:, t], order, start,
                            count, maxc, generator, frame_draws, s, temperature, 1.0)
            window[:, t] = frame.to(window.dtype)
    return unpatchify(window.reshape(B, T, H // p, W // p, pd), p, C)


@torch.no_grad()
def teacher_forced_latents(model: STMAR, latents: torch.Tensor, action_ids, domain_id,
                           generator: Optional[torch.Generator] = None, *,
                           maskgit_steps: Optional[int] = None,
                           temperature: float = 1.0, cfg: float = 1.0,
                           draws: Optional[dict] = None) -> torch.Tensor:
    """Per-frame MAR generation with ground-truth history: for each t in
    [1, T) the caches hold ground-truth frames < t and frame t is decoded
    from fully masked. latents: (B, T, h, w, C) x SVD_SCALE; returns
    (B, T-1, h, w, C), the predictions for frames 1..T-1."""
    B0, T, H, W, C = latents.shape
    p = model.config.patch_size
    patches, action_ids, action_live, _ = _patches_and_cfg(model, latents, action_ids, cfg)
    B = patches.shape[0]
    k_cache, v_cache = model.init_cache(B, with_actions=action_ids is not None)
    frames = []
    for i, t in enumerate(range(1, T)):
        # fill the cache with ground-truth frame t-1
        _, _, k_cache, v_cache = model.frame_latents(
            patches[:, t - 1], t - 1, k_cache, v_cache, action_ids, domain_id,
            action_live=action_live)
        # the decoded frame's own cache write lands in slot t, which the next
        # turn's frame_latents(t) overwrites with the ground truth
        frame, _, _, _ = generate_frame_mar(
            model, t, k_cache, v_cache, action_ids, domain_id, generator,
            _frame_draws(draws, i), maskgit_steps=maskgit_steps,
            temperature=temperature, cfg=cfg, batch_size=B, action_live=action_live)
        frames.append(frame)
    out = torch.stack(frames, dim=1)[:B0]  # (B0, T-1, S, pd)
    return unpatchify(out.reshape(B0, T - 1, H // p, W // p, -1), p, C)


def make_mar_generator(model: STMAR, *, num_prompt_frames: int,
                       maskgit_steps: Optional[int] = None, temperature: float = 1.0,
                       cfg: float = 1.0):
    """A rollout fn(prompt, action_ids, domain_id, generator)."""

    def run(prompt, action_ids, domain_id, generator=None):
        return generate_latents(model, prompt, num_prompt_frames, action_ids,
                                domain_id, generator, maskgit_steps=maskgit_steps,
                                temperature=temperature, cfg=cfg)

    return run
