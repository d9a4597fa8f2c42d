"""Port STMaskGIT vs hma_tpu STMaskGIT on a tiny card, fp32 on the CPU:
full forward, per-frame cached forward, and the caches themselves."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hma_tpu.models import factorization as jax_factorization
from hma_tpu.models.schedules import maskgit_mask_counts as jax_mask_counts
from hma_tpu.models.st_mask_git import STMaskGIT as JaxSTMaskGIT
from hma_tpu_torch.models import factorization
from hma_tpu_torch.models.schedules import maskgit_mask_counts
from torch_port_helpers import build_pair, to_torch

TOL = dict(atol=1e-4, rtol=1e-4)


CARDS = [(False, "concat+modulate"), (True, "concat+modulate"), (False, "mlp")]


@pytest.mark.parametrize("qk_norm,action_network", CARDS)
def test_compute_logits_matches_jax(qk_norm, action_network):
    jm, params, tm, tokens, actions = build_pair(qk_norm,
                                                 action_network=action_network)
    dom = jnp.asarray(0, jnp.int32)
    want, _ = jm.apply(params, tokens, actions, dom,
                       method=JaxSTMaskGIT.compute_logits)
    with torch.no_grad():
        got, pred = tm.compute_logits(to_torch(tokens), to_torch(actions), 0)
    assert pred is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("qk_norm,action_network", CARDS)
def test_frame_logits_and_caches_match_jax(qk_norm, action_network):
    jm, params, tm, tokens, actions = build_pair(qk_norm,
                                                 action_network=action_network)
    B, T, _ = tokens.shape
    dom = jnp.asarray(0, jnp.int32)
    frame = jax.jit(functools.partial(jm.apply, method=JaxSTMaskGIT.frame_logits))
    jk, jv = jm.apply(params, B, method=JaxSTMaskGIT.init_cache)
    tk, tv = tm.init_cache(B)
    assert tuple(tk.shape) == jk.shape and tk.dtype == torch.float32
    acts = to_torch(actions)
    for t in range(T):
        want, jk, jv = frame(params, tokens[:, t], jnp.asarray(t, jnp.int32),
                             jk, jv, actions, dom)
        with torch.no_grad():
            got, tk2, tv2 = tm.frame_logits(to_torch(tokens[:, t]), t, tk, tv,
                                            acts, 0)
        assert tk2 is tk and tv2 is tv  # written in place
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=f"frame {t}")
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)


def test_frame_logits_equal_full_forward():
    _, _, tm, tokens, actions = build_pair()
    B, T, S = tokens.shape
    x, acts = to_torch(tokens), to_torch(actions)
    with torch.no_grad():
        full, _ = tm.compute_logits(x, acts, 0)
        k, v = tm.init_cache(B)
        for t in range(T):
            got, _, _ = tm.frame_logits(x[:, t], t, k, v, acts, 0)
            want = full[:, :, t].reshape(B, 2, -1, S).permute(0, 3, 1, 2)
            np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_refinement_pass_leaves_caches_untouched():
    _, _, tm, tokens, actions = build_pair()
    B = tokens.shape[0]
    x, acts = to_torch(tokens), to_torch(actions)
    with torch.no_grad():
        k, v = tm.init_cache(B)
        tm.frame_logits(x[:, 0], 0, k, v, acts, 0)
        k0, v0 = k.clone(), v.clone()
        tm.frame_logits(x[:, 1], 1, k, v, acts, 0, update_cache=False)
    assert torch.equal(k, k0) and torch.equal(v, v0)


def test_factorization_and_schedule_match_jax():
    ids = np.random.default_rng(0).integers(0, 2**18, (3, 7)).astype(np.int32)
    want = np.asarray(jax_factorization.factorize_token_ids(jnp.asarray(ids), 2, 512))
    got = factorization.factorize_token_ids(to_torch(ids), 2, 512)
    np.testing.assert_array_equal(got.numpy(), want)
    back = factorization.unfactorize_token_ids(got, 2, 512)
    np.testing.assert_array_equal(back.numpy(), ids)
    for steps, S in [(2, 256), (4, 16), (1, 9)]:
        assert maskgit_mask_counts(steps, S) == jax_mask_counts(steps, S)


def test_convert_accepts_scan_layout():
    from hma_tpu.models.st_transformer import stack_layer_params
    from hma_tpu_torch.convert import params_from_jax

    jm, params, tm, _, _ = build_pair()
    p = params["params"]
    scan = {**p, "decoder": stack_layer_params(p["decoder"], jm.config.num_layers)}
    assert "layers_scan" in scan["decoder"]
    got = params_from_jax({"params": scan}, tm.config)
    want = tm.state_dict()
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        assert torch.equal(got[name], value), name
