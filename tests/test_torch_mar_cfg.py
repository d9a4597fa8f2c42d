"""Port MAR rollouts under classifier-free guidance and with teacher
forcing vs hma_tpu's, on the tiny `jointly_predict_actions` card, fp32 on
the CPU, the JAX draws handed in."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hma_tpu.rollout import mar as jax_mar
from hma_tpu_torch.models.st_mar import STMAR
from hma_tpu_torch.rollout.mar import (
    generate_frame_mar,
    generate_latents,
    teacher_forced_latents,
)
from torch_port_helpers import build_mar_pair, jax_mar_draws, port_model, tiny_mar_card, to_torch

TOL = dict(atol=1e-4, rtol=1e-4)  # as tests/test_torch_mar_rollout.py
DOM = jnp.asarray(0, jnp.int32)


@pytest.fixture(scope="module")
def joint_pair():
    return build_mar_pair(seed=5, jointly_predict_actions=True)


def _dims(cfg):
    S = cfg.S // cfg.patch_size**2
    return S, cfg.vae_embed_dim * cfg.patch_size**2, int(cfg.num_sampling_steps)


def test_generate_latents_with_cfg_match_jax(joint_pair):
    jm, params, tm, lat, actions = joint_pair
    cfg = jm.config
    B, (S, C, K) = lat.shape[0], _dims(cfg)
    key = jax.random.PRNGKey(6)
    want = np.asarray(jax_mar.generate_latents(
        jm, params, jnp.asarray(lat), 2, jnp.asarray(actions), DOM, key, cfg=2.0))
    # the engine runs the doubled [cond | uncond] batch
    draws = jax_mar_draws(key, cfg.T - 2, 2 * B, S, cfg.maskgit_steps, K, C, cfg=2.0)
    assert draws["orders"].shape[1] == B and draws["noise"].shape[2] * 2 == draws["zs"].shape[3]
    got = generate_latents(tm, to_torch(lat), 2, to_torch(actions), 0, cfg=2.0,
                           draws=draws).numpy()
    assert got.shape == lat.shape
    np.testing.assert_allclose(got, want, **TOL)
    plain = generate_latents(tm, to_torch(lat), 2, to_torch(actions), 0,
                             draws=jax_mar_draws(key, cfg.T - 2, B, S,
                                                 cfg.maskgit_steps, K, C)).numpy()
    assert np.abs(plain - got).max() > 1e-3  # guidance does change the samples


def test_teacher_forced_latents_match_jax(joint_pair):
    jm, params, tm, lat, actions = joint_pair
    cfg = jm.config
    B, (S, C, K) = lat.shape[0], _dims(cfg)
    key = jax.random.PRNGKey(2)
    want = np.asarray(jax_mar.teacher_forced_latents(
        jm, params, jnp.asarray(lat), jnp.asarray(actions), DOM, key, temperature=0.8))
    draws = jax_mar_draws(key, cfg.T - 1, B, S, cfg.maskgit_steps, K, C)
    got = teacher_forced_latents(tm, to_torch(lat), to_torch(actions), 0,
                                 temperature=0.8, draws=draws).numpy()
    assert got.shape == (B, cfg.T - 1, *lat.shape[2:])
    np.testing.assert_allclose(got, want, **TOL)


def test_cfg_refuses_what_jax_refuses(joint_pair):
    _, _, tm, lat, actions = joint_pair
    with pytest.raises(ValueError, match="needs action conditioning"):
        generate_latents(tm, to_torch(lat), 2, None, 0, cfg=2.0)
    k, v = tm.init_cache(2)
    with pytest.raises(ValueError, match="caller-doubled"):
        generate_frame_mar(tm, 1, k, v, to_torch(actions), 0, cfg=2.0, batch_size=2)
    untrained = port_model(STMAR, tiny_mar_card(), seed=5)  # jointly_predict_actions=False
    with pytest.raises(ValueError, match="trained unconditional branch"):
        generate_latents(untrained, to_torch(lat), 2, to_torch(actions), 0, cfg=2.0)
