"""MaskGIT rollout with a temporal KV cache
(counterpart of hma_tpu/rollout/maskgit.py).

Each refinement step runs a single-frame forward (`STMaskGIT.frame_logits`)
against a read-only temporal KV cache, and one more pass per generated frame
writes the finished frame into the cache. `generate_tokens_full` is the
reference algorithm, a full-stack forward per step; with the same random
draws both give the same tokens.

Sampling follows the JAX engine: per-factor argmax at temperature ~ 0, else
categorical draws from a `torch.Generator`; re-masking keeps the n
least-confident tokens masked per the cosine schedule, ordered by
confidence ("greedy") or by uniform draws ("random", the default).
`jax.random` and `torch.Generator` never give the same numbers, so every
function here also takes the "random"-mode draws as a tensor
`unmask_draws`: of shape (frames, maskgit_steps, B, S) for the per-frame
ones (`generate_tokens`, `generate_tokens_full`, `teacher_forced_logits`,
`autoregressive_logits`), (maskgit_steps, B, H*S) for `generate_horizon`,
which unmasks the H frames of its horizon together.

The evaluation surface: `teacher_forced_logits` (ground-truth history) and
`autoregressive_logits` (frame t sees [GT_0 .. GT_{t-2}, sample_{t-1}], the
reference's `--autoregressive_time`), both over the cache, and
`generate_horizon`, which refines frames [out_t_min, out_t_max) jointly
with full-stack forwards.
"""

from __future__ import annotations

from typing import Optional

import torch

from hma_tpu_torch.models.schedules import maskgit_mask_counts
from hma_tpu_torch.models.st_mask_git import STMaskGIT
from hma_tpu_torch.parallel.distributed import draw_rows


def _sample_factored(logits_SNF: torch.Tensor, generator: Optional[torch.Generator],
                     temperature: float, factored_vocab_size: int):
    """Token ids (B, S) and confidences (B, S) from factored logits
    (B, S, nv, fv) fp32; confidence = product over factors of the sampled
    prob, ids = sum_k id_k * fv**k. A sample is argmax(p / q), q ~ Exp(1) a
    row: what torch.multinomial draws for one sample, here through
    `distributed.draw_rows`."""
    B, S, nv, fv = logits_SNF.shape
    probs = torch.softmax(logits_SNF, dim=-1)
    if temperature <= 1e-8:
        samples = torch.argmax(probs, dim=-1)
    else:
        tempered = torch.softmax(logits_SNF / temperature, dim=-1)
        rows = tempered.reshape(-1, fv)
        q = draw_rows(lambda m, g: torch.empty((m, fv), dtype=rows.dtype,
                                               device=rows.device).exponential_(generator=g),
                      len(rows), generator)
        samples = torch.argmax(rows / q, dim=-1).view(B, S, nv)
    conf = torch.gather(probs, -1, samples[..., None])[..., 0]
    powers = factored_vocab_size ** torch.arange(nv, device=samples.device)
    return (samples * powers).sum(-1), conf.prod(-1)


def _mask_lowest(conf: torch.Tensor, n: int) -> torch.Tensor:
    """Boolean (B, S) mask of EXACTLY the n smallest confidences, ties
    broken by index (stable double argsort)."""
    order = torch.argsort(conf, dim=1, stable=True)
    ranks = torch.argsort(order, dim=1, stable=True)
    return ranks < n


def _remask(logits: torch.Tensor, prev: torch.Tensor, unmasked: torch.Tensor,
            n: int, draw: Optional[torch.Tensor], generator, temperature: float,
            unmask_mode: str, mask_id: int):
    """One MaskGIT step on frame logits (B, S, nv, fv): sample, keep the
    tokens already unmasked in `prev`, re-mask the n least confident.
    Returns (tokens (B, S), unmasked (B, S))."""
    samples, confidence = _sample_factored(logits, generator, temperature,
                                           logits.shape[-1])
    if unmask_mode == "greedy":
        conf = confidence
    elif unmask_mode == "random":
        conf = draw if draw is not None else draw_rows(
            lambda m, g: torch.rand((m, *confidence.shape[1:]), generator=g,
                                    device=confidence.device), len(confidence), generator)
    else:
        raise NotImplementedError(unmask_mode)
    conf = torch.where(unmasked, torch.inf, conf)
    lowest = _mask_lowest(conf, n)
    samples = torch.where(lowest, mask_id, samples)
    samples = torch.where(unmasked, prev, samples)
    unmasked = unmasked | ~lowest if n > 0 else torch.ones_like(unmasked)
    return samples, unmasked


def _maskgit_refine(model: STMaskGIT, tokens_t, t, k_cache, v_cache, action_ids,
                    domain_id, generator, draws=None, *, maskgit_steps: int,
                    temperature: float, unmask_mode: str):
    """MaskGIT steps for frame t against read-only caches; draws: optional
    (maskgit_steps, B, S). Returns (tokens (B, S), first-step logits)."""
    B, S = tokens_t.shape
    unmasked = tokens_t != model.mask_token_id
    orig_logits = None
    for step, n in enumerate(maskgit_mask_counts(maskgit_steps, S)):
        logits, _, _ = model.frame_logits(tokens_t, t, k_cache, v_cache,
                                          action_ids, domain_id,
                                          update_cache=False)
        if step == 0:
            orig_logits = logits
        tokens_t, unmasked = _remask(
            logits, tokens_t, unmasked, n,
            None if draws is None else draws[step], generator, temperature,
            unmask_mode, model.mask_token_id)
    return tokens_t, orig_logits


def generate_frame(model: STMaskGIT, tokens_t, t, k_cache, v_cache, action_ids,
                   domain_id, generator=None, draws=None, *, maskgit_steps: int,
                   temperature: float = 0.0, unmask_mode: str = "random"):
    """MaskGIT-decode frame t, then write the finished frame into the caches.
    Returns (tokens (B, S), first-step logits, k_cache, v_cache)."""
    tokens_t, orig_logits = _maskgit_refine(
        model, tokens_t, t, k_cache, v_cache, action_ids, domain_id, generator,
        draws, maskgit_steps=maskgit_steps, temperature=temperature,
        unmask_mode=unmask_mode)
    _, k_cache, v_cache = model.frame_logits(tokens_t, t, k_cache, v_cache,
                                             action_ids, domain_id)
    return tokens_t, orig_logits, k_cache, v_cache


def _prefill(model: STMaskGIT, tokens_TS, k_cache, v_cache, action_ids,
             domain_id, num_frames: int):
    """Fill the temporal KV caches from frames [0, num_frames)."""
    for t in range(num_frames):
        _, k_cache, v_cache = model.frame_logits(tokens_TS[:, t], t, k_cache,
                                                 v_cache, action_ids, domain_id)
    return k_cache, v_cache


def _masked_prompt(model: STMaskGIT, prompt_TS, num_prompt_frames: int):
    out = prompt_TS.clone()
    out[:, num_prompt_frames:] = model.mask_token_id
    return out


@torch.no_grad()
def generate_tokens(model: STMaskGIT, prompt_TS, num_prompt_frames: int,
                    action_ids, domain_id, generator=None, *,
                    maskgit_steps: int = 2, temperature: float = 0.0,
                    unmask_mode: str = "random", return_logits: bool = False,
                    unmask_draws: Optional[torch.Tensor] = None):
    """KV-cached rollout: keep `num_prompt_frames`, generate the rest.

    prompt_TS: (B, T, S) ids; frames >= num_prompt_frames are regenerated.
    unmask_draws: optional (T - num_prompt_frames, maskgit_steps, B, S).
    Returns (B, T, S) ids (and the (B, T-p, S, nv, fv) first-step logits).
    """
    B, T, S = prompt_TS.shape
    k_cache, v_cache = model.init_cache(B, with_actions=action_ids is not None)
    out = _masked_prompt(model, prompt_TS, num_prompt_frames)
    k_cache, v_cache = _prefill(model, out, k_cache, v_cache, action_ids,
                                domain_id, num_prompt_frames)
    logits = []
    for i, t in enumerate(range(num_prompt_frames, T)):
        masked = torch.full((B, S), model.mask_token_id, dtype=out.dtype,
                            device=out.device)
        tokens_t, logits_t, k_cache, v_cache = generate_frame(
            model, masked, t, k_cache, v_cache, action_ids, domain_id,
            generator, None if unmask_draws is None else unmask_draws[i],
            maskgit_steps=maskgit_steps, temperature=temperature,
            unmask_mode=unmask_mode)
        out[:, t] = tokens_t
        logits.append(logits_t)
    if return_logits:
        return out, torch.stack(logits, dim=1)
    return out


def _refine_frame_full(model: STMaskGIT, cur_TS, t, action_ids, domain_id,
                       generator, draws=None, *, maskgit_steps: int,
                       temperature: float, unmask_mode: str):
    """MaskGIT-refine frame t of cur_TS (in place) by full-stack forwards."""
    cfg = model.config
    B, T, S = cur_TS.shape
    nv, fv = cfg.num_factored_vocabs, cfg.factored_vocab_size
    unmasked = cur_TS[:, t] != model.mask_token_id
    for step, n in enumerate(maskgit_mask_counts(maskgit_steps, S)):
        logits_full, _ = model.compute_logits(cur_TS, action_ids, domain_id)
        lt = logits_full[:, :, t].reshape(B, nv, fv, S).permute(0, 3, 1, 2)
        cur_TS[:, t], unmasked = _remask(
            lt, cur_TS[:, t], unmasked, n,
            None if draws is None else draws[step], generator, temperature,
            unmask_mode, model.mask_token_id)
    return cur_TS


@torch.no_grad()
def generate_tokens_full(model: STMaskGIT, prompt_TS, num_prompt_frames: int,
                         action_ids, domain_id, generator=None, *,
                         maskgit_steps: int = 2, temperature: float = 0.0,
                         unmask_mode: str = "random",
                         unmask_draws: Optional[torch.Tensor] = None):
    """Full-recompute rollout, (T - prompt) * maskgit_steps full forwards:
    the reference algorithm. Same tokens as `generate_tokens` under the
    same draws."""
    B, T, S = prompt_TS.shape
    out = _masked_prompt(model, prompt_TS, num_prompt_frames)
    for i, t in enumerate(range(num_prompt_frames, T)):
        _refine_frame_full(model, out, t, action_ids, domain_id, generator,
                           None if unmask_draws is None else unmask_draws[i],
                           maskgit_steps=maskgit_steps, temperature=temperature,
                           unmask_mode=unmask_mode)
    return out


def make_generator(model: STMaskGIT, *, num_prompt_frames: int,
                   maskgit_steps: int = 2, temperature: float = 0.0,
                   unmask_mode: str = "random", return_logits: bool = False):
    """A rollout fn(prompt_TS, action_ids, domain_id, generator)."""

    def run(prompt_TS, action_ids, domain_id, generator=None):
        return generate_tokens(model, prompt_TS, num_prompt_frames, action_ids,
                               domain_id, generator,
                               maskgit_steps=maskgit_steps,
                               temperature=temperature,
                               unmask_mode=unmask_mode,
                               return_logits=return_logits)

    return run


@torch.no_grad()
def teacher_forced_logits(model: STMaskGIT, tokens_TS, action_ids, domain_id,
                          generator=None, *, maskgit_steps: int = 2,
                          temperature: float = 0.0, unmask_mode: str = "random",
                          unmask_draws: Optional[torch.Tensor] = None):
    """Per-frame MaskGIT samples/logits with ground-truth history: for each
    t in [1, T) the cache holds ground-truth frames < t and frame t is
    decoded from fully masked. unmask_draws: optional (T-1, steps, B, S).

    Returns (samples (B, T-1, S), logits (B, T-1, S, nv, fv)).
    """
    B, T, S = tokens_TS.shape
    k_cache, v_cache = model.init_cache(B, with_actions=action_ids is not None)
    samples, logits = [], []
    for i, t in enumerate(range(1, T)):
        _, k_cache, v_cache = model.frame_logits(tokens_TS[:, t - 1], t - 1,
                                                 k_cache, v_cache, action_ids,
                                                 domain_id)
        masked = torch.full((B, S), model.mask_token_id, dtype=tokens_TS.dtype,
                            device=tokens_TS.device)
        tokens_t, logits_t = _maskgit_refine(
            model, masked, t, k_cache, v_cache, action_ids, domain_id,
            generator, None if unmask_draws is None else unmask_draws[i],
            maskgit_steps=maskgit_steps, temperature=temperature,
            unmask_mode=unmask_mode)
        samples.append(tokens_t)
        logits.append(logits_t)
    return torch.stack(samples, dim=1), torch.stack(logits, dim=1)


@torch.no_grad()
def autoregressive_logits(model: STMaskGIT, tokens_TS, num_prompt_frames: int,
                          action_ids, domain_id, generator=None, *,
                          maskgit_steps: int = 2, temperature: float = 0.0,
                          unmask_mode: str = "random",
                          unmask_draws: Optional[torch.Tensor] = None):
    """Per-frame MaskGIT samples/logits with autoregressive history: frame
    t's context is [GT_0 .. GT_{t-2}, sample_{t-1}] (the prompt's frames
    stay ground truth); samples do not accumulate in the context.

    `frame_logits` writes the caches in place, so the order of the two
    fills is the semantics: slot t-2 is re-filled with ground truth (undoing
    the previous step's sample) before slot t-1 is filled, so the sample's
    deeper KVs condition on the all-GT prefix. 2 + maskgit_steps cached
    forwards a frame. unmask_draws: optional (T-1, steps, B, S).

    Returns (samples (B, T-1, S), logits (B, T-1, S, nv, fv)).
    """
    B, T, S = tokens_TS.shape
    k_cache, v_cache = model.init_cache(B, with_actions=action_ids is not None)
    prev = tokens_TS[:, 0]  # unused until t - 1 passes the prompt
    samples, logits = [], []
    for i, t in enumerate(range(1, T)):
        tm2 = max(t - 2, 0)
        model.frame_logits(tokens_TS[:, tm2], tm2, k_cache, v_cache, action_ids,
                           domain_id)
        fill = tokens_TS[:, t - 1] if t - 1 < num_prompt_frames else prev
        model.frame_logits(fill, t - 1, k_cache, v_cache, action_ids, domain_id)
        masked = torch.full((B, S), model.mask_token_id, dtype=tokens_TS.dtype,
                            device=tokens_TS.device)
        prev, logits_t = _maskgit_refine(
            model, masked, t, k_cache, v_cache, action_ids, domain_id, generator,
            None if unmask_draws is None else unmask_draws[i],
            maskgit_steps=maskgit_steps, temperature=temperature,
            unmask_mode=unmask_mode)
        samples.append(prev)
        logits.append(logits_t)
    return torch.stack(samples, dim=1), torch.stack(logits, dim=1)


@torch.no_grad()
def generate_horizon(model: STMaskGIT, prompt_TS, out_t_min: int, out_t_max: int,
                     action_ids, domain_id, generator=None, *, maskgit_steps: int = 2,
                     temperature: float = 0.0, unmask_mode: str = "random",
                     unmask_draws: Optional[torch.Tensor] = None):
    """MaskGIT-decode the frames [out_t_min, out_t_max) jointly: each step
    is one full-stack `compute_logits` over the window (frames from
    out_t_min on masked), and the schedule runs over all H*S tokens of the
    horizon, since its frames condition on one another through the causal
    temporal attention as they unmask. unmask_draws: optional (steps, B,
    H*S), one uniform a token a step.

    Returns (B, out_t_max - out_t_min, S) ids.
    """
    cfg = model.config
    B, T, S = prompt_TS.shape
    H = out_t_max - out_t_min
    nv, fv = cfg.num_factored_vocabs, cfg.factored_vocab_size
    cur = _masked_prompt(model, prompt_TS, out_t_min)
    unmasked = torch.zeros((B, H * S), dtype=torch.bool, device=cur.device)
    for step, n in enumerate(maskgit_mask_counts(maskgit_steps, H * S)):
        logits_full, _ = model.compute_logits(cur, action_ids, domain_id)
        lt = logits_full[:, :, out_t_min:out_t_max].reshape(B, nv, fv, H * S)
        window, unmasked = _remask(
            lt.permute(0, 3, 1, 2), cur[:, out_t_min:out_t_max].reshape(B, H * S),
            unmasked, n, None if unmask_draws is None else unmask_draws[step],
            generator, temperature, unmask_mode, model.mask_token_id)
        cur[:, out_t_min:out_t_max] = window.view(B, H, S)
    return cur[:, out_t_min:out_t_max]
