"""The port's discrete rollout surface for evaluation against hma_tpu's on
the tiny card, fp32 on the CPU: `autoregressive_logits` and
`generate_horizon` token for token (greedy, and with the uniforms JAX
draws), their logits and `STMaskGIT.window_logits` to 1e-4, the caches the
window writes included; and the port's own identities (a window equals the
full forward's frames, a prompt over every frame makes the autoregressive
history the teacher-forced one, a one-frame horizon is the full-recompute
rollout's frame)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hma_tpu.models.st_mask_git import STMaskGIT as JaxSTMaskGIT
from hma_tpu.rollout import maskgit as jax_maskgit
from hma_tpu_torch.rollout.maskgit import (
    autoregressive_logits,
    generate_horizon,
    generate_tokens_full,
    teacher_forced_logits,
)
from torch_port_helpers import build_pair, jax_horizon_draws, jax_unmask_draws, to_torch

STEPS, TOL = 2, 1e-4


@pytest.fixture(scope="module")
def pair():
    return build_pair(seed=4)


@pytest.mark.parametrize("mode,prompt", [("greedy", 1), ("random", 2)])
def test_autoregressive_logits_match_jax(pair, mode, prompt):
    jm, params, tm, tokens, actions = pair
    B, T, S = tokens.shape
    key = jax.random.PRNGKey(11)
    kw = dict(maskgit_steps=STEPS, temperature=0.0, unmask_mode=mode)
    want_s, want_l = jax_maskgit.autoregressive_logits(
        jm, params, tokens, prompt, actions, jnp.asarray(0, jnp.int32), key, **kw)
    draws = (torch.from_numpy(jax_unmask_draws(key, T - 1, B, S, STEPS))
             if mode == "random" else None)
    got_s, got_l = autoregressive_logits(tm, to_torch(tokens), prompt,
                                         to_torch(actions), 0, unmask_draws=draws, **kw)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("mode,horizon", [("greedy", (1, 3)), ("random", (2, 4))])
def test_generate_horizon_matches_jax(pair, mode, horizon):
    jm, params, tm, tokens, actions = pair
    B, T, S = tokens.shape
    lo, hi = horizon
    key = jax.random.PRNGKey(5)
    kw = dict(maskgit_steps=STEPS, temperature=0.0, unmask_mode=mode)
    want = jax_maskgit.generate_horizon(jm, params, tokens, lo, hi, actions,
                                        jnp.asarray(0, jnp.int32), key, **kw)
    draws = (torch.from_numpy(jax_horizon_draws(key, STEPS, B, (hi - lo) * S))
             if mode == "random" else None)
    got = generate_horizon(tm, to_torch(tokens), lo, hi, to_torch(actions), 0,
                           unmask_draws=draws, **kw)
    assert got.shape == (B, hi - lo, S)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_window_logits_match_jax_and_compute_logits(pair):
    jm, params, tm, tokens, actions = pair
    B, T, S = tokens.shape
    t0, write = 1, 2
    dom = jnp.asarray(0, jnp.int32)

    @jax.jit
    def jax_window(params, tokens, actions):  # eager flax is slow on the CPU
        jk, jv = jm.apply(params, B, method=JaxSTMaskGIT.init_cache)
        for t in range(t0):
            _, jk, jv = jm.apply(params, tokens[:, t], jnp.asarray(t, jnp.int32), jk,
                                 jv, actions, dom, method=JaxSTMaskGIT.frame_logits)
        return jm.apply(params, tokens[:, t0:], jnp.asarray(t0, jnp.int32), jk, jv,
                        actions, dom, write_frames=write,
                        method=JaxSTMaskGIT.window_logits)

    want, jk, jv = jax_window(params, tokens, actions)

    x, acts = to_torch(tokens), to_torch(actions)
    with torch.no_grad():
        k, v = tm.init_cache(B)
        for t in range(t0):
            tm.frame_logits(x[:, t], t, k, v, acts, 0)
        got, k2, v2 = tm.window_logits(x[:, t0:], t0, k, v, acts, 0, write_frames=write)
        full, _ = tm.compute_logits(x, acts, 0)
    assert k2 is k and v2 is v  # written in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    cfg = tm.config
    frames = full[:, :, t0:].reshape(B, cfg.num_factored_vocabs, cfg.factored_vocab_size,
                                     T - t0, S).permute(0, 3, 4, 1, 2)
    np.testing.assert_allclose(got.numpy(), frames.numpy(), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=TOL, rtol=TOL)
    assert not k[:, :, t0 + write:].any()  # slots past the written frames untouched


def test_autoregressive_with_prompt_over_every_frame_is_teacher_forced(pair):
    _, _, tm, tokens, actions = pair
    T = tokens.shape[1]
    x, acts = to_torch(tokens), to_torch(actions)
    kw = dict(maskgit_steps=STEPS, temperature=0.0, unmask_mode="random")
    ar = autoregressive_logits(tm, x, T, acts, 0, torch.Generator().manual_seed(2), **kw)
    tf = teacher_forced_logits(tm, x, acts, 0, torch.Generator().manual_seed(2), **kw)
    assert torch.equal(ar[0], tf[0]) and torch.equal(ar[1], tf[1])


def test_one_frame_horizon_is_the_full_rollouts_frame(pair):
    _, _, tm, tokens, actions = pair
    B, T, S = tokens.shape
    x, acts = to_torch(tokens)[:, :3], to_torch(actions)[:, :3]
    draws = torch.rand((1, STEPS, B, S), generator=torch.Generator().manual_seed(9))
    kw = dict(maskgit_steps=STEPS, temperature=0.0, unmask_mode="random")
    horizon = generate_horizon(tm, x, 2, 3, acts, 0, unmask_draws=draws[0], **kw)
    full = generate_tokens_full(tm, x, 2, acts, 0, unmask_draws=draws, **kw)
    assert torch.equal(horizon, full[:, 2:3])
