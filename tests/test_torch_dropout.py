"""The MLP dropout of the training forward (`mlp_drop`, after the GELU and
after fc2) against hma_tpu, fp32 on the CPU, on the tiny discrete card at
mlp_drop 0.1: JAX's training forward runs under jit with its dropout masks
recorded (`JaxTrainingDraws`), the port takes them as `dropout`, and the
loss (1e-5 relative) and every gradient (max |dg| <= 1e-4 max |g|) must
agree, with remat too. The continuous card's dropout is held to JAX's the
same way in tests/test_torch_stmar_train.py (its mlp_drop 0.1 forward and
train steps).

In the port alone, for both families: a dropout generator gives the same
gradients with remat as without (the masks are drawn from per-block seeds
taken before each block, so the recompute draws them alike), another seed
moves them, and every deterministic path (full forward, eval step, the
cached frame step) gives at mlp_drop 0.1 exactly what it gives at 0.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hma_tpu_torch.convert import params_from_jax
from hma_tpu_torch.models.st_mar import STMAR, patchify
from hma_tpu_torch.models.st_mask_git import STMaskGIT
from hma_tpu_torch.train import step as port_step
from torch_port_helpers import JaxTrainingDraws, build_pair, port_model, tiny_mar_card, to_torch

DROP = 0.1


def _grads(model) -> dict:
    return {n: p.grad for n, p in model.named_parameters()}


def _assert_grads(got: dict, want: dict, rel: float):
    assert set(got) == set(want)
    for n, w in want.items():
        g = got[n] if got[n] is not None else torch.zeros_like(w)
        err, scale = (g - w).abs().max().item(), w.abs().max().item()
        assert err <= rel * scale + 1e-8, f"{n}: max|dg| {err:.3e}, max|g| {scale:.3e}"


@pytest.fixture(scope="module")
def discrete_env():
    """The tiny discrete card at mlp_drop 0.1, masked inputs, and JAX's
    training loss, grads and dropout masks under jit."""
    jm, params, tm, tokens, actions = build_pair(seed=11, mlp_drop=DROP)
    inp = tokens.copy()
    inp[:, 1:, ::2] = jm.config.image_vocab_size

    def loss(p):
        with JaxTrainingDraws() as rec:
            out = jm.apply(p, inp, tokens, actions, jnp.asarray(0, jnp.int32),
                           deterministic=False, rngs={"dropout": jax.random.PRNGKey(4)})
        return out["loss"], rec.tree()

    (want, tree), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    rec = JaxTrainingDraws.of(tree)
    return dict(tm=tm, cfg=tm.config, inp=inp, tokens=tokens, actions=actions,
                loss=float(want), grads=params_from_jax(grads, tm.config), rec=rec)


def _discrete_args(e):
    return to_torch(e["inp"]), to_torch(e["tokens"]), to_torch(e["actions"]), 0


@pytest.mark.parametrize("remat", [False, True])
def test_discrete_training_loss_and_grads_match_jax_with_dropout(discrete_env, remat):
    e = discrete_env
    L = e["cfg"].num_layers
    assert len(e["rec"].dropout) == 2 * L  # after the GELU and after fc2, per block
    keep = np.mean([m.mean() for m in e["rec"].dropout])
    assert 0.8 < keep < 0.97  # about 1 - mlp_drop of the units kept
    tm = STMaskGIT(e["cfg"], dtype=torch.float32, device="cpu", remat=remat)
    tm.load_state_dict(e["tm"].state_dict())
    out = tm(*_discrete_args(e), dropout=e["rec"].masks(0, L))
    np.testing.assert_allclose(out["loss"].item(), e["loss"], rtol=1e-5)
    out["loss"].backward()
    _assert_grads(_grads(tm), e["grads"], 1e-4)
    # without the masks some gradient moves ten times past that limit: the
    # check sees the dropout
    plain = copy.deepcopy(e["tm"])
    plain(*_discrete_args(e))["loss"].backward()
    moved = max((g - e["grads"][n]).abs().max().item() / e["grads"][n].abs().max().item()
                for n, g in _grads(plain).items() if g is not None)
    assert moved > 1e-3


def _remat_grads(build, run, seed):
    """Grads of run(model, generator) without and with remat."""
    out = []
    for remat in (False, True):
        model = build(remat)
        run(model, torch.Generator().manual_seed(seed)).backward()
        out.append(_grads(model))
    return out


@pytest.fixture(scope="module")
def mar_env():
    # the port against itself: no JAX side, so no JAX init is compiled
    tm = port_model(STMAR, tiny_mar_card(mlp_drop=DROP), seed=12)
    cfg, rng = tm.config, np.random.default_rng(12)
    lat = rng.normal(size=(2, cfg.T, cfg.h, cfg.h, cfg.vae_embed_dim)).astype(np.float32)
    actions = rng.normal(size=(2, cfg.T, cfg.max_d_action)).astype(np.float32)
    mask = (np.random.default_rng(3).random(lat.shape[:4]) < 0.5).astype(np.int32)
    mask[:, 0] = 0
    return dict(tm=tm, cfg=tm.config, lat=lat, actions=actions, mask=mask)


@pytest.mark.parametrize("family", ["discrete", "continuous"])
def test_dropout_grads_with_remat_equal_those_without(discrete_env, mar_env, family):
    e = discrete_env if family == "discrete" else mar_env
    cls = STMaskGIT if family == "discrete" else STMAR

    def build(remat):
        model = cls(e["cfg"], dtype=torch.float32, device="cpu", remat=remat)
        model.load_state_dict(e["tm"].state_dict())
        return model

    if family == "discrete":
        def run(model, gen):
            return model(*_discrete_args(e), dropout=gen)["loss"]
    else:
        def run(model, gen):
            lat = torch.from_numpy(e["lat"])
            return model(lat, lat, torch.from_numpy(e["actions"]), 0,
                         torch.from_numpy(e["mask"]), generator=torch.Generator().manual_seed(0),
                         dropout=gen)["loss"]

    plain, remat = _remat_grads(build, run, seed=5)
    for n in plain:
        if plain[n] is None:
            assert remat[n] is None, n
        else:
            torch.testing.assert_close(remat[n], plain[n], atol=0, rtol=0, msg=n)
    other = _remat_grads(build, run, seed=6)[1]
    assert any(not torch.equal(other[n], plain[n]) for n in plain if plain[n] is not None)


def test_deterministic_paths_ignore_mlp_drop(discrete_env, mar_env):
    """Full forward, eval step and the cached frame step give at mlp_drop
    0.1 exactly what the same weights give at 0, in both families."""
    for e, cls in ((discrete_env, STMaskGIT), (mar_env, STMAR)):
        cfg0 = copy.deepcopy(e["cfg"])
        cfg0.mlp_drop = 0.0
        m0 = cls(cfg0, dtype=torch.float32, device="cpu")
        m0.load_state_dict(e["tm"].state_dict())
        m1 = e["tm"]
        assert m1.config.mlp_drop == DROP
        acts = torch.from_numpy(e["actions"])
        with torch.no_grad():
            if cls is STMaskGIT:
                args = _discrete_args(e)
                outs = [m.compute_logits(args[0], acts, 0)[0] for m in (m0, m1)]
                outs += [port_step.make_eval_step(m)({"input_ids": args[0], "labels": args[1],
                                                      "action_ids": acts})["loss"]
                         for m in (m0, m1)]
                caches = [m.init_cache(args[0].shape[0]) for m in (m0, m1)]
                outs += [m.frame_logits(args[0][:, 0], 0, *c, acts, 0)[0]
                         for m, c in zip((m0, m1), caches)]
            else:
                lat = torch.from_numpy(e["lat"])
                patches = patchify(lat, cfg0.patch_size).flatten(2, 3)
                outs = [m.compute_latents(patches, acts, 0)[0] for m in (m0, m1)]
                batch = {"input_ids": lat, "labels": lat, "action_ids": acts,
                         "masked_tokens_indicator": torch.from_numpy(e["mask"])}
                outs += [port_step.make_eval_step(m, continuous=True)(batch)["loss"]
                         for m in (m0, m1)]
                caches = [m.init_cache(lat.shape[0]) for m in (m0, m1)]
                outs += [m.frame_latents(patches[:, 0], 0, *c, acts, 0)[0]
                         for m, c in zip((m0, m1), caches)]
        for a, b in zip(outs[::2], outs[1::2]):
            assert torch.equal(a, b)
