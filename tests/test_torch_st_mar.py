"""Port STMAR vs hma_tpu's on the tiny continuous card, fp32 on the CPU:
the full forward, the KV-cached per-frame forward, the action_live gate,
patchify, and the conversion of loop- and scan-layout trees."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hma_tpu.models.st_mar import STMAR as JaxSTMAR
from hma_tpu.models.st_mar import patchify as jax_patchify
from hma_tpu.models.st_transformer import stack_layer_params
from hma_tpu_torch.config import DiffusionGenieConfig, load_config
from hma_tpu_torch.convert import params_from_jax
from hma_tpu_torch.models.st_mar import STMAR, patchify, unpatchify
from torch_port_helpers import build_mar_pair, tiny_mar_card, to_torch

TOL = dict(atol=1e-4, rtol=1e-4)
DOM = jnp.asarray(0, jnp.int32)


@pytest.fixture(scope="module")
def pair():
    return build_mar_pair()


@pytest.fixture(scope="module")
def joint_pair():
    return build_mar_pair(seed=3, jointly_predict_actions=True)


def test_patchify_matches_jax_and_round_trips():
    x = np.random.default_rng(1).normal(size=(2, 3, 8, 8, 4)).astype(np.float32)
    got = patchify(torch.from_numpy(x), 2)
    assert tuple(got.shape) == (2, 3, 4, 4, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_patchify(jnp.asarray(x), 2)))
    np.testing.assert_array_equal(unpatchify(got, 2, 4).numpy(), x)


@pytest.mark.parametrize("with_actions", [True, False])
def test_compute_latents_match_jax(pair, with_actions):
    jm, params, tm, lat, actions = pair
    p = jm.config.patch_size
    acts = actions if with_actions else None
    # jitted: eager flax runs the model op by op, several times slower here
    want, _ = jax.jit(functools.partial(jm.apply, method=JaxSTMAR.compute_latents))(
        params, jax_patchify(jnp.asarray(lat), p), acts, DOM)
    got, pooled = tm.compute_latents(patchify(to_torch(lat), p),
                                     None if acts is None else to_torch(acts), 0)
    assert pooled is None and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_frame_latents_match_jax_and_full_forward(pair):
    jm, params, tm, lat, actions = pair
    cfg = jm.config
    B = lat.shape[0]
    jp = jax_patchify(jnp.asarray(lat), cfg.patch_size).reshape(B, cfg.T, -1, 16)
    tp = patchify(to_torch(lat), cfg.patch_size).flatten(2, 3)
    acts = to_torch(actions)
    with torch.no_grad():
        full, _ = tm.compute_latents(tp, acts, 0)
    jk, jv = jm.apply(params, B, method=JaxSTMAR.init_cache)
    k, v = tm.init_cache(B)
    assert tuple(k.shape) == jk.shape
    frame = jax.jit(functools.partial(jm.apply, method=JaxSTMAR.frame_latents))
    for t in range(cfg.T):
        want, _, jk, jv = frame(params, jp[:, t], jnp.asarray(t), jk, jv, actions, DOM)
        # a pass that must leave the caches untouched, then the real one
        before = k.clone()
        with torch.no_grad():
            tm.frame_latents(tp[:, t] + 1.0, t, k, v, acts, 0, update_cache=False)
            assert torch.equal(k, before)
            got, pooled, k, v = tm.frame_latents(tp[:, t], t, k, v, acts, 0)
        assert pooled is None
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(got.numpy(), full[:, t].numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), **TOL)


def test_joint_card_latents_and_action_live_match_jax(joint_pair):
    """A `jointly_predict_actions` card: the pooled action latents, the
    no-actions branch, and action_live = [1, 0] against JAX; a live=0 row
    equals the action_ids=None run."""
    jm, params, tm, lat, actions = joint_pair
    cfg = jm.config
    B = lat.shape[0]
    assert hasattr(tm, "action_diff_loss")
    jp = jax_patchify(jnp.asarray(lat), cfg.patch_size).reshape(B, cfg.T, -1, 16)
    tp = patchify(to_torch(lat), cfg.patch_size).flatten(2, 3)
    acts = to_torch(actions)
    amask = np.zeros((B, cfg.T, 1, 1), np.float32)
    amask[0, 2:] = 1.0
    want, want_a = jax.jit(functools.partial(jm.apply, method=JaxSTMAR.compute_latents))(
        params, jp, actions, DOM, jnp.asarray(amask))
    with torch.no_grad():
        got, got_a = tm.compute_latents(tp, acts, 0, torch.from_numpy(amask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), **TOL)

    live = np.array([1.0, 0.0], np.float32)
    jk, jv = jm.apply(params, B, method=JaxSTMAR.init_cache)
    k, v = tm.init_cache(B)
    k0, v0 = tm.init_cache(B, with_actions=False)
    assert k0.shape == k.shape  # the joint card always carries action tokens
    frame = jax.jit(functools.partial(jm.apply, method=JaxSTMAR.frame_latents))
    for t in range(2):
        want, want_a, jk, jv = frame(params, jp[:, t], jnp.asarray(t), jk, jv, actions, DOM,
                                     action_live=jnp.asarray(live))
        with torch.no_grad():
            got, got_a, k, v = tm.frame_latents(tp[:, t], t, k, v, acts, 0,
                                                action_live=torch.from_numpy(live))
            none, none_a, k0, v0 = tm.frame_latents(tp[:, t], t, k0, v0, None, 0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), **TOL)
        np.testing.assert_allclose(got[1].numpy(), none[1].numpy(), atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(got_a[1].numpy(), none_a[1].numpy(), atol=1e-6, rtol=1e-6)
        assert not np.allclose(got[0].numpy(), none[0].numpy(), atol=1e-4)


def test_scan_layout_tree_converts_to_the_same_state(pair):
    _, params, tm, _, _ = pair
    cfg = DiffusionGenieConfig(**tiny_mar_card())
    tree = dict(params["params"])
    tree["decoder"] = stack_layer_params(tree["decoder"], cfg.num_layers)
    assert "layers_scan" in tree["decoder"]
    got = params_from_jax({"params": tree}, cfg)
    want = tm.state_dict()
    assert got.keys() == want.keys()
    for name in want:
        assert torch.equal(got[name], want[name]), name
    assert {"token_embed.weight", "diffusion_pos_embed_learned", "mask_token",
            "diffloss.net.time_embed.fc1.weight", "diffloss.net.res_1_adaLN.weight",
            "diffloss.net.res_0_ln.weight", "z_proj_ln.bias"} <= want.keys()


def test_joint_tree_has_stacked_action_head(joint_pair):
    tm = joint_pair[2]
    sd = tm.state_dict()
    assert sd["action_diff_loss.net.input_proj.kernel"].ndim == 3
    assert sd["action_diff_loss.net.res_0_ln.scale"].ndim == 2
    assert sd["action_diff_loss.net.time_fc1.kernel"].shape[1] == 256


def test_card_loads_as_diffusion_config_and_forward_is_not_ported(pair, tmp_path):
    tm = pair[2]
    path = tmp_path / "card.json"
    tm.config.save_pretrained(str(path))
    cfg = load_config(str(path))
    assert isinstance(cfg, DiffusionGenieConfig) and cfg == tm.config
    assert cfg.maskgit_steps == 3 and cfg.mar_sampling_compat == "mar"
    # the training forward runs (tests/test_torch_stmar_train.py holds it to
    # hma_tpu's) and, as hma_tpu's, wants the mask indicator
    lat = to_torch(pair[3])
    with pytest.raises(ValueError, match="masked_tokens_indicator"):
        tm(lat, lat)


def test_random_init_is_finite_and_zero_where_jax_is():
    cfg = DiffusionGenieConfig(**tiny_mar_card())
    tm = STMAR(cfg, dtype=torch.float32, device="cpu",
               generator=torch.Generator().manual_seed(0))
    for name in ("pos_embed_TSC", "mask_token", "action_mask_tokens"):
        assert not getattr(tm, name).any()
    assert tm.diffusion_pos_embed_learned.std() > 0
    assert not tm.diffloss.net.final_linear.weight.any()
    assert tm.diffloss.net.input_proj.weight.std() > 0
    z, _ = tm.compute_latents(torch.zeros(1, cfg.T, 4, 16))
    assert torch.isfinite(z).all()
