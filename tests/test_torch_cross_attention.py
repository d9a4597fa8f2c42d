"""Cross-attention action injection and joint action prediction, port vs
hma_tpu on tiny cards, fp32 on the CPU: `DomainCrossAttention` in both
compat modes; a `concat+cross_attention` STMaskGIT that predicts actions
(logits, action_pred, loss and action_loss with the action mask handed in,
the cached paths against the full forward, greedy rollout, one step's
gradients, `jointly_predict_states: false`); the reference mode's full
forward and its cached-decode refusal; STMAR with cross-attention and its
resident-layout refusal.

The JAX parameters are random draws of the shapes `jax.eval_shape` gives
(no init is compiled), and every JAX number the STMaskGIT tests read comes
from one jitted function: XLA's compile is most of their cost.

Tolerances: forwards atol = rtol = 1e-5 (logits up to ~10, action_pred and
losses of order 1); cached against full forward of the port the same; gradients max |dg| <=
1e-4 * max |g| per tensor; rollout tokens exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hma_tpu.config import DiffusionGenieConfig as JaxDiffusionGenieConfig
from hma_tpu.config import GenieConfig as JaxGenieConfig
from hma_tpu.models.action_stems import DomainCrossAttention as JaxCrossAttention
from hma_tpu.models.st_mar import STMAR as JaxSTMAR
from hma_tpu.models.st_mask_git import STMaskGIT as JaxSTMaskGIT
from hma_tpu.rollout import maskgit as jax_maskgit
from hma_tpu_torch.config import DiffusionGenieConfig, GenieConfig
from hma_tpu_torch.convert import params_from_jax
from hma_tpu_torch.models.action_stems import DomainCrossAttention
from hma_tpu_torch.models.st_mar import STMAR
from hma_tpu_torch.models.st_mask_git import STMaskGIT
from hma_tpu_torch.rollout.maskgit import generate_tokens, generate_tokens_full
from torch_port_helpers import tiny_card, tiny_mar_card, to_torch

TOL = 1e-5
GRAD_TOL = 1e-4
JOINT = dict(action_network="concat+cross_attention", jointly_predict_actions=True)
D0 = jnp.asarray(0, jnp.int32)


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(got, want, what=""):
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL, rtol=TOL, err_msg=what)


def _random_params(init, *args, seed=0, scale=0.1):
    """Random fp32 draws of the shapes of `init(*args)`'s params (traced by
    jax.eval_shape, nothing compiled)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: (scale * rng.normal(size=s.shape)).astype(np.float32),
                        jax.eval_shape(init, *args))


@pytest.mark.parametrize("compat", ["fixed", "reference"])
def test_domain_cross_attention_matches_jax(compat):
    """Two domains (domain 1 runs), d 32 in 8 heads of 4, every parameter
    drawn (a live qk-LN scale and bias, a proj bias). For "reference", B 3
    and S 5 give rows b*S+s whose action row (b*S+s) % B is not b, and T 6
    is not the head count, so a plain transpose or the wrong pairing reads
    other numbers."""
    B, S, T, C = 3, 5, 6, 32
    rows = (np.arange(B)[:, None] * S + np.arange(S)[None, :]) % B
    assert (rows != np.arange(B)[:, None]).any() and T != 8
    rng = np.random.default_rng(0)
    q = rng.normal(size=(B, S, T, C) if compat == "reference" else (B, S * T, C))
    kv = rng.normal(size=(B, T + 1, C))
    q, kv = q.astype(np.float32), kv.astype(np.float32)
    jmod = JaxCrossAttention(num_domains=2, num_heads=8, d_model=C, dtype=jnp.float32,
                             compat=compat)
    dom = jnp.asarray(1, jnp.int32)
    params = _random_params(jmod.init, jax.random.PRNGKey(0), q, kv, dom, scale=0.5)
    want = jax.jit(jmod.apply)(params, q, kv, dom)
    tmod = DomainCrossAttention(2, 8, C, torch.float32, compat, device="cpu")
    tmod.load_state_dict(params_from_jax(params, None))
    got = tmod(torch.from_numpy(q), torch.from_numpy(kv), 1)
    assert got.shape == want.shape
    _close(got, want)


@pytest.fixture(scope="module")
def joint():
    """The tiny card at 1 layer with concat+cross_attention and joint
    action prediction, B 3, an action mask with dropped and kept frames, the
    port model on random params, and every JAX number the tests below read
    (1 layer: the compile is most of this file's cost, and a second layer
    adds no path; `chip_smoke.py` phase 22 holds 2 layers and full depth)."""
    card = tiny_card(True, num_layers=1, **JOINT)
    jcfg = JaxGenieConfig(**card)
    jm = JaxSTMaskGIT(jcfg, dtype=jnp.float32)
    rng = np.random.default_rng(4)
    B, T, S = 3, jcfg.T, jcfg.S
    tokens = rng.integers(0, jcfg.image_vocab_size, (B, T, S)).astype(np.int32)
    tokens[:, 1:, ::2] = jcfg.image_vocab_size
    actions = rng.normal(size=(B, T, jcfg.max_d_action)).astype(np.float32)
    am = (rng.random((B, T, 1, 1)) < 0.5).astype(np.float32)
    am[0, :, 0, 0] = [0, 1, 0, 1]
    params = _random_params(jm.init, {"params": jax.random.PRNGKey(0),
                                      "action_drop": jax.random.PRNGKey(0)},
                            tokens, tokens, actions, D0, seed=5)
    jm_ref = JaxSTMaskGIT(dataclasses.replace(jcfg, cross_attention_compat="reference"),
                          dtype=jnp.float32)

    @jax.jit
    def reference(p):
        def loss_fn(p):
            out = jm.apply(p, tokens, tokens, actions, D0, action_mask=am)
            return out["loss"] + 0.5 * out["action_loss"], out

        (loss, out), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        return dict(
            loss=loss, out=out, grads=grads,
            logits=jm.apply(p, tokens, actions, D0, am, method=jm.compute_logits),
            no_actions=jm.apply(p, tokens, None, D0, method=jm.compute_logits),
            reference=jm_ref.apply(p, tokens, actions, D0, am, method=jm_ref.compute_logits),
            # the full-recompute rollout: hma_tpu's tests hold its cached one
            # to it token for token, and it compiles in half the time
            greedy=jax_maskgit.generate_tokens_full(
                jm, p, tokens, 1, actions, D0, jax.random.PRNGKey(3), maskgit_steps=2,
                temperature=0.0, unmask_mode="greedy"))

    cfg = GenieConfig(**card)
    tm = STMaskGIT(cfg, dtype=torch.float32, device="cpu")
    tm.load_state_dict(params_from_jax(params, cfg))
    return dict(jm_ref=jm_ref, params=params, tm=tm, tokens=tokens, actions=actions,
                am=am, want=jax.tree.map(np.asarray, reference(params)))


def _inputs(joint):
    return (to_torch(joint["tokens"]), to_torch(joint["actions"]),
            torch.from_numpy(joint["am"]))


def _port_model(tm, **changes):
    model = STMaskGIT(dataclasses.replace(tm.config, **changes), dtype=torch.float32,
                      device="cpu")
    model.load_state_dict(tm.state_dict())
    return model


@torch.no_grad()
def test_joint_cross_attention_forward_matches_jax(joint):
    tm, want = joint["tm"], joint["want"]
    x, a, am = _inputs(joint)
    got_l, got_p = tm.compute_logits(x, a, 0, am)
    _close(got_l, want["logits"][0], what="logits")
    _close(got_p, want["logits"][1], what="action_pred")
    assert got_p.dtype == torch.float32
    # without actions the mask tokens stand in for every frame's actions
    got_l, got_p = tm.compute_logits(x, None, 0)
    _close(got_l, want["no_actions"][0], what="logits without actions")
    _close(got_p, want["no_actions"][1], what="action_pred without actions")
    got = tm(x, x, a, 0, action_mask=am)
    for k in ("loss", "acc", "action_loss", "actions"):
        _close(got[k], want["out"][k], what=k)
    assert got["action_loss"].item() > 0


@torch.no_grad()
def test_joint_action_drop_draws(joint):
    """Without an action mask the forward draws drop_ratio ~ U(B, 1, 1) and
    mask = U(B, T, 1) < drop_ratio from its generator, in that order."""
    tm = joint["tm"]
    x, a, _ = _inputs(joint)
    B, T = x.shape[:2]
    got = tm(x, x, a, 0, generator=torch.Generator().manual_seed(9))
    g = torch.Generator().manual_seed(9)
    ratio = torch.rand(B, 1, 1, generator=g)
    mask = (torch.rand(B, T, 1, generator=g) < ratio)[..., None].float()
    want = tm(x, x, a, 0, action_mask=mask)
    assert 0 < mask.sum() < mask.numel()
    assert torch.equal(got["action_loss"], want["action_loss"])
    assert torch.equal(got["loss"], want["loss"])


@torch.no_grad()
def test_joint_cached_paths_equal_full_forward(joint):
    tm = joint["tm"]
    x, a, _ = _inputs(joint)
    B, T, S = x.shape
    for acts in (a, None):
        full, _ = tm.compute_logits(x, acts, 0)
        full = full.permute(0, 2, 3, 4, 1).reshape(B, T, S, 2, -1)
        k, v = tm.init_cache(B, with_actions=acts is not None)
        assert k.shape[1] == B * (S + tm.config.action_token_size)
        for t in range(T):
            logits, k, v = tm.frame_logits(x[:, t], t, k, v, acts, 0)
            _close(logits, full[:, t], what=f"frame {t}, actions {acts is not None}")
        k, v = tm.init_cache(B, with_actions=acts is not None)
        tm.window_logits(x[:, :1], 0, k, v, acts, 0, write_frames=1)
        logits, _, _ = tm.window_logits(x[:, 1:], 1, k, v, acts, 0)
        _close(logits, full[:, 1:], what=f"window, actions {acts is not None}")


def test_joint_greedy_rollout_matches_jax(joint):
    """The port's cached and full-recompute rollouts, greedy, against
    hma_tpu's full-recompute one, token for token."""
    x, a, _ = _inputs(joint)
    kw = dict(maskgit_steps=2, temperature=0.0, unmask_mode="greedy")
    for rollout in (generate_tokens, generate_tokens_full):
        got = rollout(joint["tm"], x, 1, a, 0, **kw)
        np.testing.assert_array_equal(got.numpy(), joint["want"]["greedy"], rollout.__name__)


def test_joint_training_gradients_match_jax(joint):
    want = joint["want"]
    model = _port_model(joint["tm"])
    x, a, am = _inputs(joint)
    out = model(x, x, a, 0, action_mask=am)
    loss = out["loss"] + 0.5 * out["action_loss"]
    loss.backward()
    _close(loss, want["loss"], what="loss")
    want_g = params_from_jax(want["grads"], model.config)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(want_g) == set(grads)
    for n in ("action_readout.out.kernel", "decoder.layers.0.action_projector.to_q.kernel",
              "decoder.layers.0.action_projector.qk_ln_scale", "action_mask_tokens"):
        assert want_g[n].abs().max() > 0, n
    for n, w in want_g.items():
        g = torch.zeros_like(w) if grads[n] is None else grads[n]
        assert (g - w).abs().max() <= GRAD_TOL * w.abs().max() + 1e-12, n


@torch.no_grad()
def test_joint_actions_only_card_matches_jax(joint):
    """jointly_predict_states: false gives no logits and a zero token loss;
    the action loss alone trains the model. hma_tpu's action loss does not
    read jointly_predict_states (the token readout is a branch of its own),
    so the main forward's is the reference."""
    want = joint["want"]["out"]
    model = _port_model(joint["tm"], jointly_predict_states=False)
    x, a, am = _inputs(joint)
    logits, pred = model.compute_logits(x, a, 0, am)
    assert logits is None and pred is not None
    got = model(x, x, a, 0, action_mask=am)
    assert got["loss"].item() == got["acc"].item() == 0.0
    _close(got["action_loss"], want["action_loss"], what="action_loss")


def test_reference_compat_full_forward_and_cached_refusal(joint):
    """The reference mode shares the fixed mode's parameters: its full
    forward matches hma_tpu's, and its cached decode raises as hma_tpu's."""
    want_l, want_p = joint["want"]["reference"]
    model = _port_model(joint["tm"], cross_attention_compat="reference")
    x, a, am = _inputs(joint)
    with torch.no_grad():
        got_l, got_p = model.compute_logits(x, a, 0, am)
        fixed_l, _ = joint["tm"].compute_logits(x, a, 0, am)
    _close(got_l, want_l, what="logits")
    _close(got_p, want_p, what="action_pred")
    assert (fixed_l - got_l).abs().max() > 1e-3  # the quirks do move the numbers
    k, v = model.init_cache(x.shape[0])
    with pytest.raises(NotImplementedError, match="full-recompute"):
        model.frame_logits(x[:, 0], 0, k, v, a, 0)
    with pytest.raises(NotImplementedError, match="full-recompute"):
        model.window_logits(x[:, :2], 0, k, v, a, 0)
    jm_ref = joint["jm_ref"]
    kc, vc = jm_ref.apply(joint["params"], 3, method=jm_ref.init_cache)
    with pytest.raises(NotImplementedError, match="full-recompute"):
        jax.eval_shape(lambda p: jm_ref.apply(p, joint["tokens"][:, 0], jnp.asarray(0),
                                              kc, vc, joint["actions"], D0,
                                              method=jm_ref.frame_logits),
                       joint["params"])


def test_stmar_cross_attention_matches_jax_and_resident_refuses():
    card = tiny_mar_card(action_network="concat+cross_attention")
    jcfg = JaxDiffusionGenieConfig(**card)
    jm = JaxSTMAR(jcfg, dtype=jnp.float32)
    rng = np.random.default_rng(6)
    B, T, h, C = 2, jcfg.T, jcfg.h, jcfg.vae_embed_dim
    lat = rng.normal(size=(B, T, h, h, C)).astype(np.float32)
    actions = rng.normal(size=(B, T, jcfg.max_d_action)).astype(np.float32)
    keys = {k: jax.random.PRNGKey(0) for k in ("params", "diffusion", "action_drop")}
    params = _random_params(jm.init, keys, lat, lat, actions, D0,
                            np.zeros((B, T, h, h), np.int32), seed=7)
    x = lat.reshape(B, T, -1, C * 4)  # any (B, T, S_p, patch_dim) input
    want_z, _ = jax.jit(lambda p: jm.apply(p, x, actions, D0, method=jm.compute_latents))(
        params)
    cfg = DiffusionGenieConfig(**card)
    tm = STMAR(cfg, dtype=torch.float32, device="cpu")
    tm.load_state_dict(params_from_jax(params, cfg))
    with torch.no_grad():
        got_z, _ = tm.compute_latents(torch.from_numpy(x), torch.from_numpy(actions), 0)
    _close(got_z, want_z, what="latents")
    resident = JaxSTMAR(jcfg, dtype=jnp.float32, temporal_layout="resident")
    with pytest.raises(NotImplementedError, match="resident"):
        jax.eval_shape(lambda p: resident.apply(p, x, actions, D0,
                                                method=resident.compute_latents), params)
    tm_res = STMAR(cfg, dtype=torch.float32, device="cpu", temporal_layout="resident")
    tm_res.load_state_dict(tm.state_dict())
    with pytest.raises(NotImplementedError, match="resident"):
        tm_res.compute_latents(torch.from_numpy(x), torch.from_numpy(actions), 0)
