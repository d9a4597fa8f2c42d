"""Port MaskGIT rollout vs hma_tpu's on a tiny card, fp32 on the CPU: the
tokens must be identical, greedy or with the very uniforms JAX draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hma_tpu.rollout import maskgit as jax_maskgit
from hma_tpu_torch.rollout.maskgit import (
    _mask_lowest,
    generate_tokens,
    generate_tokens_full,
    teacher_forced_logits,
)
from torch_port_helpers import build_pair, jax_unmask_draws, to_torch

PROMPT, STEPS = 1, 2


@pytest.mark.parametrize("mode", ["greedy", "random"])
def test_generate_tokens_match_jax(mode):
    jm, params, tm, tokens, actions = build_pair()
    B, T, S = tokens.shape
    key = jax.random.PRNGKey(3)
    dom = jnp.asarray(0, jnp.int32)
    kw = dict(maskgit_steps=STEPS, temperature=0.0, unmask_mode=mode)
    want, want_logits = jax_maskgit.generate_tokens(
        jm, params, tokens, PROMPT, actions, dom, key, return_logits=True, **kw)
    want = np.asarray(want)
    want_full = np.asarray(jax_maskgit.generate_tokens_full(
        jm, params, tokens, PROMPT, actions, dom, key, **kw))
    np.testing.assert_array_equal(want, want_full)
    draws = None
    if mode == "random":
        draws = torch.from_numpy(jax_unmask_draws(key, T - PROMPT, B, S, STEPS))
    x, acts = to_torch(tokens), to_torch(actions)
    got, got_logits = generate_tokens(tm, x, PROMPT, acts, 0, unmask_draws=draws,
                                      return_logits=True, **kw)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               atol=1e-4, rtol=1e-4)
    got_full = generate_tokens_full(tm, x, PROMPT, acts, 0, unmask_draws=draws, **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got_full.numpy(), want)


def test_cached_rollout_equals_full_recompute():
    _, _, tm, tokens, actions = build_pair()  # the pair this file builds anyway
    x, acts = to_torch(tokens), to_torch(actions)
    kw = dict(maskgit_steps=3, temperature=0.0, unmask_mode="random")
    cached = generate_tokens(tm, x, PROMPT, acts, 0,
                             torch.Generator().manual_seed(5), **kw)
    full = generate_tokens_full(tm, x, PROMPT, acts, 0,
                                torch.Generator().manual_seed(5), **kw)
    assert torch.equal(cached, full)
    assert torch.equal(cached[:, :PROMPT], x[:, :PROMPT])
    assert (cached[:, PROMPT:] < tm.mask_token_id).all()


def test_teacher_forced_logits_match_jax():
    jm, params, tm, tokens, actions = build_pair(seed=2)
    key = jax.random.PRNGKey(0)
    kw = dict(maskgit_steps=STEPS, temperature=0.0, unmask_mode="greedy")
    want_s, want_l = jax_maskgit.teacher_forced_logits(
        jm, params, tokens, actions, jnp.asarray(0, jnp.int32), key, **kw)
    got_s, got_l = teacher_forced_logits(tm, to_torch(tokens), to_torch(actions),
                                         0, **kw)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l),
                               atol=1e-4, rtol=1e-4)


def test_mask_lowest_breaks_ties_by_index():
    conf = torch.tensor([[0.5, 0.1, 0.1, 0.9, 0.1]])
    got = _mask_lowest(conf, 2)
    want = jax_maskgit._mask_lowest(jnp.asarray(conf.numpy()), 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.tolist() == [[False, True, True, False, False]]
