"""Port STMAR training vs hma_tpu on tiny cards, fp32 on the CPU, with the
JAX draws (diffusion timesteps and noise, action-suffix masks, dropout
masks) recorded and handed in: `training_losses` with rows at t = 0 and a
variance output drifted past +-1, `DiffLoss.loss` with `dim_mask`,
`STMAR.forward` (jointly_predict_actions off and on, diffusion_batch_mul 1
and 2), two steps of the continuous train step with the dense and with the
domain-sliced AdamW, the continuous eval step and `maskgit_collate_feature`.

Tolerances: losses 1e-5 relative; every gradient max |dg| <= 1e-4 max |g|
(+1e-8), but for the bare `training_losses` of a contrived net (see there);
after the steps params 1e-5, first moments 2e-5, second moments
4e-5 relative per tensor, with Adam's eps = 1e-3 as in
tests/test_torch_train_step.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hma_tpu.config import DiffusionGenieConfig as JaxDiffusionGenieConfig
from hma_tpu.data.collators import maskgit_collate_feature as jax_collate_feature
from hma_tpu.diffusion import gaussian as jax_gaussian
from hma_tpu.models.diffloss import DiffLoss as JaxDiffLoss
from hma_tpu.models.st_mar import STMAR as JaxSTMAR
from hma_tpu.train import step as jax_step
from hma_tpu_torch.config import DiffusionGenieConfig
from hma_tpu_torch.convert import params_from_jax
from hma_tpu_torch.data.collators import maskgit_collate_feature
from hma_tpu_torch.diffusion import gaussian
from hma_tpu_torch.models.diffloss import DiffLoss
from hma_tpu_torch.models.st_mar import STMAR
from hma_tpu_torch.train import step as port_step
from torch_port_helpers import JaxTrainingDraws, build_mar_pair, perturbed, tiny_mar_card

LR, WD, EPS = 3e-3, 0.05, 1e-3
REL = {"params": 1e-5, "m": 2e-5, "v": 4e-5}
DOM = jnp.asarray(0, jnp.int32)


def _assert_grads(got: dict, want: dict, rel: float = 1e-4):
    """Every tensor of `want` (a missing grad counts as zero) to rel * max|want|."""
    assert set(got) == set(want)
    for n, w in want.items():
        g = got[n] if got[n] is not None else torch.zeros_like(w)
        assert torch.isfinite(g).all(), n
        err, scale = (g - w).abs().max().item(), w.abs().max().item()
        assert err <= rel * scale + 1e-8, f"{n}: max|dg| {err:.3e}, max|g| {scale:.3e}"


def _mask(B, T, h, seed):
    """A masked_tokens_indicator: about half of frames 1.. masked."""
    m = (np.random.default_rng(seed).random((B, T, h, h)) < 0.5).astype(np.int32)
    m[:, 0] = 0
    return m


def test_training_losses_match_jax_at_t0_and_drifted_v():
    """Per-row loss, mse and vb, and the gradients of a linear net, with
    rows at t = 0 (the NLL branch) and v four times past +-1 (the clamped
    variance); every gradient is finite, as the double where and the +-80
    clamps intend."""
    rng = np.random.default_rng(0)
    N, C, Z = 8, 3, 5
    x0 = rng.uniform(-1.2, 1.2, (N, C)).astype(np.float32)  # past +-0.999: the edge bins
    cond = rng.normal(size=(N, Z)).astype(np.float32)
    t = np.array([0, 0, 1, 5, 100, 500, 999, 0], np.int32)
    A0 = (0.5 * rng.normal(size=(C, 2 * C))).astype(np.float32)
    B0 = (0.5 * rng.normal(size=(Z, 2 * C))).astype(np.float32)
    w = rng.uniform(0.5, 1.5, N).astype(np.float32)
    key = jax.random.PRNGKey(3)
    noise = np.asarray(jax.random.normal(key, x0.shape, jnp.float32))
    scale = np.array([1.0] * C + [4.0] * C, np.float32)

    def jax_loss(A, Bm):
        net = lambda x, tt, c: (x @ A + c @ Bm + 1e-3 * tt[:, None]) * scale
        out = jax_gaussian.training_losses(net, jax_gaussian.make_schedule("cosine", 1000, ""),
                                           jnp.asarray(x0), jnp.asarray(t), jnp.asarray(cond), key)
        return jnp.sum(out["loss"] * w), out

    (_, want), (gA, gB) = jax.jit(jax.value_and_grad(jax_loss, argnums=(0, 1),
                                                     has_aux=True))(A0, B0)
    A, Bm = (torch.from_numpy(x).requires_grad_(True) for x in (A0, B0))
    sc = torch.from_numpy(scale)
    net = lambda x, tt, c: (x @ A + c @ Bm + 1e-3 * tt[:, None]) * sc
    got = gaussian.training_losses(net, gaussian.make_schedule("cosine", 1000, ""),
                                   torch.from_numpy(x0), torch.from_numpy(t).long(),
                                   torch.from_numpy(cond), torch.from_numpy(noise))
    v = (torch.from_numpy(x0) @ A + torch.from_numpy(cond) @ Bm)[:, C:] * 4.0
    assert (v.abs() > 1).float().mean() > 0.5  # the variance head has drifted
    # per row, 1e-4 absolute: at t = 0 the NLL takes log(cdf+ - cdf-) of two
    # CDFs near 1, and JAX's and torch's fp32 ndtr differ by up to 1.2e-7,
    # which the cancellation amplifies (the rows read up to 6.8e-5 of ~5.4)
    for k in ("loss", "mse", "vb"):
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-4, err_msg=k)
    total = (got["loss"] * torch.from_numpy(w)).sum()
    np.testing.assert_allclose(total.item(), float(jnp.sum(want["loss"] * w)), rtol=1e-5)
    # the gradient of that log divides the same 1-ulp differences by the
    # small cdf+ - cdf-: it reads 1.2e-4 of max |g|, so 1e-3 here (the models'
    # tests below hold every gradient to 1e-4)
    total.backward()
    _assert_grads({"A": A.grad, "B": Bm.grad},
                  {"A": torch.from_numpy(np.asarray(gA)), "B": torch.from_numpy(np.asarray(gB))},
                  rel=1e-3)


def test_diffloss_loss_with_dim_mask_matches_jax():
    """The domain-stacked head (the action head's form) at domain 1, a
    channel mask hiding the last channel, row weights: loss and every
    parameter gradient."""
    C, Z, N = 5, 12, 10
    kw = dict(target_channels=C, z_channels=Z, depth=2, width=128,
              num_sampling_steps="4", num_domains=2)
    jm = JaxDiffLoss(**kw, dtype=jnp.float32, loop_kernel=False)
    rng = np.random.default_rng(1)
    target = rng.normal(size=(N, C)).astype(np.float32)
    z = rng.normal(size=(N, Z)).astype(np.float32)
    mask = (rng.random(N) < 0.7).astype(np.float32)
    dim_mask = np.array([1, 1, 1, 1, 0], np.float32)
    dom = jnp.asarray(1, jnp.int32)
    init = jax.jit(functools.partial(jm.init, method=JaxDiffLoss.loss))
    params = perturbed(init({"params": jax.random.PRNGKey(0),
                             "diffusion": jax.random.PRNGKey(1)}, target, z, mask, dom,
                            dim_mask), rng, 0.05)

    def loss(p):
        with JaxTrainingDraws() as rec:
            out = jm.apply(p, target, z, mask, dom, dim_mask, method=JaxDiffLoss.loss,
                           rngs={"diffusion": jax.random.PRNGKey(2)})
        return out, rec.tree()

    (want, tree), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    t, noise = JaxTrainingDraws.of(tree).diffusion[0]
    tm = DiffLoss(**kw, dtype=torch.float32, device="cpu")
    tm.load_state_dict(params_from_jax(params, None))
    got = tm.loss(torch.from_numpy(target), torch.from_numpy(z), torch.from_numpy(mask), 1,
                  torch.from_numpy(dim_mask), t=torch.from_numpy(t).long(),
                  noise=torch.from_numpy(noise))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    got.backward()
    _assert_grads({n: p.grad for n, p in tm.named_parameters()},
                  params_from_jax(grads, None))


@pytest.fixture(scope="module", params=[(False, 1, 0.0), (True, 2, 0.1)],
                ids=["joint_off-mul1", "joint_on-mul2-dropout"])
def forward_env(request):
    """A tiny card (jointly_predict_actions, diffusion_batch_mul, mlp_drop),
    its JAX loss (+ 1.0 x the action loss) and grads under jit, and the
    draws that forward made."""
    joint, mul, drop = request.param
    jm, params, tm, lat, actions = build_mar_pair(
        seed=4, jointly_predict_actions=joint, diffusion_batch_mul=mul, mlp_drop=drop)
    mask = _mask(*lat.shape[:3], seed=5)
    rngs = {"diffusion": jax.random.PRNGKey(6), "action_drop": jax.random.PRNGKey(7),
            "dropout": jax.random.PRNGKey(8)}

    def loss(p):
        with JaxTrainingDraws() as rec:
            out = jm.apply(p, lat, lat, actions, DOM, mask, deterministic=False, rngs=rngs)
        total = out["loss"] + (out["action_loss"] if joint else 0.0)
        return total, (out, rec.tree())

    (_, (out, tree)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return dict(joint=joint, drop=drop, tm=tm, lat=lat, actions=actions, mask=mask,
                out=out, grads=grads, rec=JaxTrainingDraws.of(tree), cfg=tm.config)


def test_stmar_forward_loss_and_grads_match_jax(forward_env):
    e = forward_env
    layers = e["cfg"].num_layers if e["drop"] else 0
    draws = e["rec"].draws(0, layers)
    if e["joint"]:
        assert {"action_t0", "action_t", "action_noise"} <= set(draws)
        assert len(draws["t"]) == 2 * e["lat"].shape[0] * 4 * 4  # tiled rows
    out = e["tm"](torch.from_numpy(e["lat"]), torch.from_numpy(e["lat"]),
                  torch.from_numpy(e["actions"]), 0, torch.from_numpy(e["mask"]),
                  dropout=draws.pop("dropout", None), draws=draws)
    np.testing.assert_allclose(out["loss"].item(), float(e["out"]["loss"]), rtol=1e-5)
    total = out["loss"]
    if e["joint"]:
        np.testing.assert_allclose(out["action_loss"].item(),
                                   float(e["out"]["action_loss"]), rtol=1e-5)
        np.testing.assert_allclose(out["actions"].detach().numpy(),
                                   np.asarray(e["out"]["actions"]), atol=1e-5, rtol=1e-5)
        total = total + out["action_loss"]
    else:
        assert "action_loss" not in out
    total.backward()
    _assert_grads({n: p.grad for n, p in e["tm"].named_parameters()},
                  params_from_jax(e["grads"], e["cfg"]))
    e["tm"].zero_grad()


def test_stmar_forward_draws_from_a_generator(forward_env):
    """Without `draws`, the same generator seed gives the same loss, another
    seed another one; the masked rows alone count."""
    e = forward_env
    args = (torch.from_numpy(e["lat"]), torch.from_numpy(e["lat"]),
            torch.from_numpy(e["actions"]), 0, torch.from_numpy(e["mask"]))
    with torch.no_grad():
        a, b, c = (e["tm"](*args, generator=torch.Generator().manual_seed(s),
                           dropout=torch.Generator().manual_seed(s))["loss"].item()
                   for s in (1, 1, 2))
    assert a == b and a != c and np.isfinite(a)
    with pytest.raises(ValueError, match="masked_tokens_indicator"):
        e["tm"](*args[:4])


def _card(num_domains: int) -> dict:
    card = tiny_mar_card(mlp_drop=0.1)
    card.update(action_domains=[f"d{i}" for i in range(num_domains)],
                d_actions=[4] * num_domains,
                action_stats=card["action_stats"] * num_domains)
    return card


def _batch(card, B, seed, domain_id=0):
    rng = np.random.default_rng(seed)
    h = int(np.sqrt(card["S"]))
    lat = rng.normal(size=(B, card["T"], h, h, card["vae_embed_dim"])).astype(np.float32)
    return {"input_ids": lat, "labels": lat, "masked_tokens_indicator": _mask(B, card["T"], h, seed),
            "action_ids": rng.normal(size=(B, card["T"], 4)).astype(np.float32),
            "domain_id": np.int32(domain_id)}


def _port_batch(b):
    out = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items() if k != "domain_id"}
    return {**out, "domain_id": int(b["domain_id"])}


def _steps_env(num_domains: int, domains):
    """A tiny card with `num_domains` domains and mlp_drop 0.1: the JAX
    continuous train step (dense AdamW for one domain, domain-sliced for
    more), jitted with its draws recorded, over batches of `domains`."""
    card = _card(num_domains)
    jcfg = JaxDiffusionGenieConfig(**card)
    jm = JaxSTMAR(jcfg, dtype=jnp.float32)
    b0 = {k: jnp.asarray(v) for k, v in _batch(card, 2, 0).items()}
    init_args = (b0["input_ids"], b0["labels"], b0["action_ids"], b0["domain_id"],
                 b0["masked_tokens_indicator"])
    init_rngs = {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1),
                 "action_drop": jax.random.PRNGKey(2)}
    params = perturbed(jax.jit(jm.init)(init_rngs, *init_args), np.random.default_rng(9))
    sched = jax_step.custom_cosine_schedule(LR, 1, 10)
    mask = None
    if num_domains == 1:
        tx = jax_step.make_optimizer(sched, WD, eps=EPS, params_template=params)
    else:
        other = jax.eval_shape(JaxSTMAR(JaxDiffusionGenieConfig(**_card(num_domains + 1)),
                                        dtype=jnp.float32).init, init_rngs, *init_args)
        mask = jax_step.domain_stacked_mask(params, other)
        tx = jax_step.make_domain_sliced_optimizer(
            sched, WD, eps=EPS, params_template=params, stacked_mask=mask,
            num_domains=num_domains)
    step = jax_step.make_train_step(jm, tx, continuous=True,
                                    action_loss_weight=jcfg.action_loss_weight)

    def step_rec(state, batch, rng):
        with JaxTrainingDraws() as rec:
            state, metrics = step(state, batch, rng)
        return state, metrics, rec.tree()

    step_rec = jax.jit(step_rec)
    state = jax_step.TrainState(params, jax.jit(tx.init)(params), jnp.asarray(0))
    batches, recs = [_batch(card, 2, 10 + i, d) for i, d in enumerate(domains)], []
    for i, b in enumerate(batches):
        state, _, tree = step_rec(state, {k: jnp.asarray(v) for k, v in b.items()},
                                  jax.random.PRNGKey(i))
        recs.append(JaxTrainingDraws.of(tree))
    cfg = DiffusionGenieConfig(**card)
    tm = STMAR(cfg, dtype=torch.float32, device="cpu")
    tm.load_state_dict(params_from_jax(params, cfg))
    return dict(card=card, cfg=cfg, tm=tm, mask=mask, batches=batches, recs=recs,
                state=state)


def _assert_tree_close(got: dict, want: dict, what: str):
    assert set(got) == set(want), what
    for n, w in want.items():
        err, scale = (got[n].detach() - w).abs().max().item(), w.abs().max().item()
        assert err <= REL[what] * scale + 1e-8, \
            f"{what} {n}: max|d| {err:.3e}, max|want| {scale:.3e}"


@pytest.mark.parametrize("sliced", [False, True])
def test_continuous_train_steps_match_jax(sliced):
    e = _steps_env(3, (1, 2)) if sliced else _steps_env(1, (0, 0))
    tm, cfg, state = e["tm"], e["cfg"], e["state"]
    sched = port_step.custom_cosine_schedule(LR, 1, 10)
    if sliced:
        stacked = port_step.domain_stacked_mask(
            tm, STMAR(DiffusionGenieConfig(**_card(4)), dtype=torch.float32, device="meta"))
        tx = port_step.make_domain_sliced_optimizer(tm, sched, WD, eps=EPS,
                                                    stacked_mask=stacked, num_domains=3)
    else:
        tx = port_step.make_optimizer(tm, sched, WD, eps=EPS)
    step = port_step.make_train_step(tm, tx, continuous=True,
                                     action_loss_weight=cfg.action_loss_weight)
    for b, rec in zip(e["batches"], e["recs"]):
        m = step(_port_batch(b), draws=rec.draws(0, cfg.num_layers))
        assert m["skipped"].item() == 0.0 and np.isfinite(m["grad_norm"].item())
    _assert_tree_close(dict(tm.named_parameters()), params_from_jax(state.params, cfg),
                       "params")
    if sliced:
        opt = state.opt_state
        m_want = jax_step._combine(e["mask"], opt.dense[0].mu, opt.m)
        v_want = jax_step._combine(e["mask"], opt.dense[0].nu, opt.v)
        assert tx.domain_count == np.asarray(opt.count).tolist() == [0, 1, 1]
    else:
        adam = state.opt_state[1][0]
        m_want, v_want = adam.mu, adam.nu
    _assert_tree_close(tx.m, params_from_jax(m_want, cfg), "m")
    _assert_tree_close(tx.v, params_from_jax(v_want, cfg), "v")
    assert tx.count == 2


def test_continuous_eval_step_matches_jax():
    """Deterministic (mlp_drop 0.1 is off), perplexity = exp(loss); the
    diffusion draws from the JAX key tree handed in, and from `rng`."""
    jm, params, tm, lat, actions = build_mar_pair(seed=6, mlp_drop=0.1)
    batch = {"input_ids": lat, "labels": lat, "action_ids": actions, "domain_id": np.int32(0),
             "masked_tokens_indicator": _mask(*lat.shape[:3], seed=7)}
    ev = jax_step.make_eval_step(jm, continuous=True)

    def ev_rec(p, b, rng):
        with JaxTrainingDraws() as rec:
            out = ev(p, b, rng)
        return out, rec.tree()

    want, tree = jax.jit(ev_rec)(params, {k: jnp.asarray(v) for k, v in batch.items()},
                                 jax.random.PRNGKey(3))
    rec = JaxTrainingDraws.of(tree)
    assert not rec.dropout  # the eval forward draws no dropout masks
    eval_step = port_step.make_eval_step(tm, continuous=True)
    got = eval_step(_port_batch(batch), draws=rec.draws(0))
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=1e-5)
    np.testing.assert_allclose(got["perplexity"].item(), float(want["perplexity"]), rtol=1e-5)
    a, b = (eval_step(_port_batch(batch), rng=r)["loss"].item() for r in (1, 1))
    assert a == b and a != eval_step(_port_batch(batch), rng=2)["loss"].item()


@pytest.mark.parametrize("seed", range(4))
def test_feature_collator_matches_jax(seed):
    card = dict(num_layers=1, num_heads=1, d_model=8, T=4, S=16, num_prompt_frames=2,
                non_mlm_ratio=0.5, vae_embed_dim=3)
    rng = np.random.default_rng(200 + seed)
    items = [{"input_ids": rng.normal(size=(64, 3)).astype(np.float32), "h": 4, "w": 4,
              "domain": "a", "action_ids": rng.normal(size=(4, 2)).astype(np.float32)}
             for _ in range(3)]
    got = maskgit_collate_feature(items, DiffusionGenieConfig(**card),
                                  np.random.default_rng(seed))
    want = jax_collate_feature(items, JaxDiffusionGenieConfig(**card),
                               np.random.default_rng(seed))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    assert got["masked_tokens_indicator"][:, 0].sum() == 0
