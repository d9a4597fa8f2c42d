"""Port training step vs hma_tpu on tiny cards, fp32 on the CPU: the loss and
accuracy of `STMaskGIT.__call__`, every parameter gradient against
`jax.grad` (through `params_from_jax`'s name map), 2-3 optimizer steps of
`make_train_step` with the dense AdamW (1 domain) and the domain-sliced
AdamW (3 domains) against the JAX step (params, moments, counts), the NaN
guard, grad accumulation, remat, the masks and the schedule.

Tolerances, per tensor, as max |got - want| <= rel * max |want| + 1e-8:
gradients rel 1e-5; after the steps params 1e-5, first moments 2e-5 (two
steps of grads each ~1e-5 off), second moments 4e-5 (squares of them).
Loss and acc 1e-5 relative. Adam divides by sqrt(v), which amplifies the
fp32 noise of near-zero gradients; eps = 1e-3 damps that, as
tests/test_sliced_optimizer.py does for the same reason.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from hma_tpu.config import GenieConfig as JaxGenieConfig
from hma_tpu.models.st_mask_git import STMaskGIT as JaxSTMaskGIT
from hma_tpu.models.st_mask_git import smoothed_ce_floor as jax_ce_floor
from hma_tpu.train import step as jax_step
from hma_tpu_torch.config import GenieConfig
from hma_tpu_torch.convert import params_from_jax
from hma_tpu_torch.models.st_mask_git import STMaskGIT, smoothed_ce_floor
from hma_tpu_torch.train import step as port_step
from torch_port_helpers import tiny_card, to_torch

LR, WD, EPS = 3e-3, 0.05, 1e-3
REL = {"params": 1e-5, "m": 2e-5, "v": 4e-5}


def _card(num_domains: int) -> dict:
    card = tiny_card()
    card.update(action_domains=[f"d{i}" for i in range(num_domains)],
                d_actions=[4] * num_domains,
                action_stats=card["action_stats"] * num_domains)
    return card


def _batch(card, B, seed, domain_id=0, same_mask=False):
    """Labels, input_ids with ~half of frames 1.. masked, actions (numpy)."""
    rng = np.random.default_rng(seed)
    T, S, V = card["T"], card["S"], card["image_vocab_size"]
    labels = rng.integers(0, V, (B, T, S)).astype(np.int32)
    mask = rng.random((1 if same_mask else B, T, S)) < 0.5
    mask[:, 0] = False
    inp = np.where(mask, V, labels).astype(np.int32)
    actions = rng.normal(size=(B, T, max(card["d_actions"]))).astype(np.float32)
    return {"input_ids": inp, "labels": labels, "action_ids": actions,
            "domain_id": np.int32(domain_id)}


def _jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _port_batch(b):
    return {"input_ids": to_torch(b["input_ids"]), "labels": to_torch(b["labels"]),
            "action_ids": to_torch(b["action_ids"]), "domain_id": int(b["domain_id"])}


def _build(card, seed=0):
    """(jax model, perturbed params, port model loaded with them, port cfg)."""
    jcfg = JaxGenieConfig(**card)
    jm = JaxSTMaskGIT(jcfg, dtype=jnp.float32)
    b = _jax_batch(_batch(card, 2, seed))
    params = jax.jit(jm.init)({"params": jax.random.PRNGKey(seed)}, b["input_ids"],
                              b["labels"], b["action_ids"], b["domain_id"])
    rng = np.random.default_rng(seed + 100)
    params = jax.tree.map(
        lambda x: np.asarray(x) + 0.02 * rng.normal(size=x.shape).astype(np.float32),
        params)
    cfg = GenieConfig(**card)
    tm = STMaskGIT(cfg, dtype=torch.float32, device="cpu")
    tm.load_state_dict(params_from_jax(params, cfg))
    return jm, params, tm, cfg


def _as_port(tree, like_params, cfg):
    """A JAX tree shaped like the params (or a tree of bools over them) as
    {port name: tensor}, through the converter's name map."""
    full = jax.tree.map(lambda x, p: np.broadcast_to(np.asarray(x, np.float32),
                                                     np.shape(p)), tree, like_params)
    return params_from_jax(full, cfg)


def _assert_tree_close(got: dict, want: dict, what: str):
    assert set(got) == set(want), what
    for n, w in want.items():
        err = (got[n].detach() - w).abs().max().item()
        scale = w.abs().max().item()
        assert err <= REL[what] * scale + 1e-8, \
            f"{what} {n}: max|d| {err:.3e}, max|want| {scale:.3e}"


@pytest.fixture(scope="module")
def dense_env():
    """1-domain card: JAX value_and_grad at the start, then 2 jitted steps
    of make_train_step with the dense AdamW (init and grad jitted too: eager
    flax takes several times longer on the CPU)."""
    card = _card(1)
    jm, params, tm, cfg = _build(card)
    batches = [_batch(card, 4, seed=10 + i) for i in range(2)]
    (_, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: (lambda o: (o["loss"], o))(jm.apply(p, *(
            _jax_batch(batches[0])[k] for k in
            ("input_ids", "labels", "action_ids", "domain_id")))),
        has_aux=True))(params)
    sched = jax_step.custom_cosine_schedule(LR, 1, 10)
    tx = jax_step.make_optimizer(sched, WD, eps=EPS, params_template=params)
    step = jax.jit(jax_step.make_train_step(jm, tx))
    state = jax_step.TrainState(params, jax.jit(tx.init)(params), jnp.asarray(0))
    for i, b in enumerate(batches):
        state, _ = step(state, _jax_batch(b), jax.random.PRNGKey(i))
    return dict(card=card, cfg=cfg, jm=jm, params=params, tm=tm, batches=batches,
                metrics=metrics, grads=grads, state=state)


@pytest.fixture(scope="module")
def sliced_env():
    """3-domain card: 3 jitted steps (domains 1, 2, 1) with the sliced AdamW."""
    card = _card(3)
    jm, params, tm, cfg = _build(card, seed=1)
    jm_other = JaxSTMaskGIT(JaxGenieConfig(**_card(4)), dtype=jnp.float32)
    b0 = _jax_batch(_batch(card, 2, 0))
    other = jax.eval_shape(jm_other.init, {"params": jax.random.PRNGKey(0)},
                           b0["input_ids"], b0["labels"], b0["action_ids"],
                           b0["domain_id"])
    mask = jax_step.domain_stacked_mask(params, other)
    sched = jax_step.custom_cosine_schedule(LR, 1, 10)
    tx = jax_step.make_domain_sliced_optimizer(
        sched, WD, eps=EPS, params_template=params, stacked_mask=mask,
        num_domains=3)
    step = jax.jit(jax_step.make_train_step(jm, tx))
    state = jax_step.TrainState(params, jax.jit(tx.init)(params), jnp.asarray(0))
    batches = [_batch(card, 4, seed=20 + i, domain_id=d)
               for i, d in enumerate((1, 2, 1))]
    for i, b in enumerate(batches):
        state, _ = step(state, _jax_batch(b), jax.random.PRNGKey(i))
    return dict(card=card, cfg=cfg, params=params, tm=tm, mask=mask,
                batches=batches, state=state)


def test_loss_and_acc_match_jax(dense_env):
    e = dense_env
    b = _port_batch(e["batches"][0])
    with torch.no_grad():
        out = e["tm"](b["input_ids"], b["labels"], b["action_ids"], 0)
    np.testing.assert_allclose(out["loss"].item(), float(e["metrics"]["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(out["acc"].item(), float(e["metrics"]["acc"]),
                               rtol=1e-5, atol=1e-7)
    assert smoothed_ce_floor(2, 512) == pytest.approx(jax_ce_floor(2, 512), rel=1e-12)


def test_every_gradient_matches_jax(dense_env):
    e = dense_env
    tm = copy.deepcopy(e["tm"])
    b = _port_batch(e["batches"][0])
    tm(b["input_ids"], b["labels"], b["action_ids"], 0)["loss"].backward()
    want = params_from_jax(e["grads"], e["cfg"])
    got = dict(tm.named_parameters())
    assert set(got) == set(want)
    worst = 0.0
    for n, w in want.items():
        g = got[n].grad if got[n].grad is not None else torch.zeros_like(w)
        err = (g - w).abs().max().item()
        scale = w.abs().max().item()
        assert err <= 1e-5 * scale + 1e-8, f"{n}: max|dg| {err:.3e}, max|g| {scale:.3e}"
        worst = max(worst, err / max(scale, 1e-30))
    assert worst < 1e-5


def test_dense_adamw_steps_match_jax(dense_env):
    e = dense_env
    tm = copy.deepcopy(e["tm"])
    sched = port_step.custom_cosine_schedule(LR, 1, 10)
    tx = port_step.make_optimizer(tm, sched, WD, eps=EPS)
    step = port_step.make_train_step(tm, tx)
    for b in e["batches"]:
        m = step(_port_batch(b))
        assert m["skipped"].item() == 0.0
    cfg, state = e["cfg"], e["state"]
    _assert_tree_close(dict(tm.named_parameters()),
                       params_from_jax(state.params, cfg), "params")
    adam = state.opt_state[1][0]  # chain(clip, adamw(scale_by_adam, ...))
    _assert_tree_close(tx.m, params_from_jax(adam.mu, cfg), "m")
    _assert_tree_close(tx.v, params_from_jax(adam.nu, cfg), "v")
    assert tx.count == int(adam.count) == 2


def test_sliced_adamw_steps_match_jax(sliced_env):
    e = sliced_env
    tm = copy.deepcopy(e["tm"])
    stacked = port_step.domain_stacked_mask(
        tm, STMaskGIT(GenieConfig(**_card(4)), dtype=torch.float32, device="meta"))
    sched = port_step.custom_cosine_schedule(LR, 1, 10)
    tx = port_step.make_domain_sliced_optimizer(tm, sched, WD, eps=EPS,
                                                stacked_mask=stacked, num_domains=3)
    step = port_step.make_train_step(tm, tx)
    for b in e["batches"]:
        assert step(_port_batch(b))["skipped"].item() == 0.0
    cfg, state, mask = e["cfg"], e["state"], e["mask"]
    opt = state.opt_state
    full_m = jax_step._combine(mask, opt.dense[0].mu, opt.m)
    full_v = jax_step._combine(mask, opt.dense[0].nu, opt.v)
    _assert_tree_close(dict(tm.named_parameters()),
                       params_from_jax(state.params, cfg), "params")
    _assert_tree_close(tx.m, params_from_jax(full_m, cfg), "m")
    _assert_tree_close(tx.v, params_from_jax(full_v, cfg), "v")
    assert tx.domain_count == np.asarray(opt.count).tolist() == [0, 2, 1]
    assert tx.count == int(opt.gcount) == int(opt.dense[0].count) == 3
    # row 0 of every stacked table never moved
    for n, p in tm.named_parameters():
        if stacked[n]:
            torch.testing.assert_close(p[0], e["tm"].state_dict()[n][0], atol=0, rtol=0)


def test_weight_decay_and_stacked_masks_match_jax(sliced_env):
    e = sliced_env
    want_wd = _as_port(jax_step.weight_decay_mask(e["params"]), e["params"], e["cfg"])
    got_wd = port_step.weight_decay_mask(e["tm"])
    assert got_wd == {n: bool(t.flatten()[0]) for n, t in want_wd.items()}
    assert not all(got_wd.values()) and any(got_wd.values())
    want_st = _as_port(e["mask"], e["params"], e["cfg"])
    got_st = port_step.domain_stacked_mask(
        e["tm"], STMaskGIT(GenieConfig(**_card(4)), dtype=torch.float32, device="meta"))
    assert got_st == {n: bool(t.flatten()[0]) for n, t in want_st.items()}
    assert any(got_st.values()) and not all(got_st.values())


def test_schedule_and_lr_scaling_match_jax():
    for warm, total in ((10, 110), (1, 10), (0, 5)):
        j = jax_step.custom_cosine_schedule(2e-3, warm, total)
        p = port_step.custom_cosine_schedule(2e-3, warm, total)
        for s in range(0, total + 3):
            assert p(s) == pytest.approx(float(j(s)), rel=1e-6), (warm, total, s)
    for bsz in (1, 8, 64, 100, 2048, 10_000):
        assert port_step.scale_lr_by_batch(1e-4, bsz) == \
            pytest.approx(jax_step.scale_lr_by_batch(1e-4, bsz))


@pytest.mark.parametrize("sliced", [False, True])
def test_nan_loss_skips_update(dense_env, sliced_env, sliced):
    """A NaN action makes the loss NaN: skipped = 1, params unchanged, the
    moments stay finite, the counts still advance (as JAX's do)."""
    e = sliced_env if sliced else dense_env
    tm = copy.deepcopy(e["tm"])
    if sliced:
        stacked = port_step.domain_stacked_mask(
            tm, STMaskGIT(GenieConfig(**_card(4)), dtype=torch.float32, device="meta"))
        tx = port_step.make_domain_sliced_optimizer(tm, LR, stacked_mask=stacked,
                                                    num_domains=3)
    else:
        tx = port_step.make_optimizer(tm, LR)
    bad = _port_batch(e["batches"][0])
    bad["action_ids"] = bad["action_ids"].clone()
    bad["action_ids"][0, 0, 0] = float("nan")
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    m = port_step.make_train_step(tm, tx)(bad)
    assert not np.isfinite(m["loss"].item()) and m["skipped"].item() == 1.0
    for n, p in tm.named_parameters():
        torch.testing.assert_close(p.detach(), before[n], atol=0, rtol=0)
    assert all(torch.isfinite(t).all() for t in [*tx.m.values(), *tx.v.values()])
    assert tx.count == 1


class _FiniteLossNaNGrad(nn.Module):
    """Finite forward, NaN backward (d sqrt(u)/du at u = 0 times 0): the loss
    is exactly 1, the grad of the active row of `w` is NaN."""

    def __init__(self):
        super().__init__()
        self.w = nn.Parameter(torch.ones(3, 4))
        self.b = nn.Parameter(torch.ones(4))

    def forward(self, input_ids, labels, action_ids=None, domain_id=0, dropout=None,
                generator=None, action_mask=None):
        loss = torch.sqrt(self.w[domain_id] * 0.0).sum() + (self.b * 0).sum() + 1.0
        return {"loss": loss, "acc": torch.zeros(())}


@pytest.mark.parametrize("sliced", [False, True])
def test_nan_guard_catches_finite_loss_nan_grads(sliced):
    model = _FiniteLossNaNGrad()
    if sliced:
        tx = port_step.make_domain_sliced_optimizer(
            model, 1e-3, stacked_mask={"w": True, "b": False}, num_domains=3)
    else:
        tx = port_step.make_optimizer(model, 1e-3)
    batch = {"input_ids": torch.zeros(2, 2), "labels": torch.zeros(2, 2),
             "domain_id": 1}
    m = port_step.make_train_step(model, tx)(batch)
    assert m["loss"].item() == pytest.approx(1.0)
    assert m["skipped"].item() == 1.0 and not np.isfinite(m["grad_norm"].item())
    assert torch.equal(model.w.detach(), torch.ones(3, 4))
    assert all(torch.isfinite(t).all() for t in [*tx.m.values(), *tx.v.values()])


def test_grad_accumulation_equals_full_batch(dense_env):
    """Microbatches with equal masked-token counts average to the full
    batch's gradient (and metrics): 2 chunks of 2 against B = 4."""
    e = dense_env
    b = _port_batch(_batch(e["card"], 4, seed=30, same_mask=True))
    grads, metrics = [], []
    for micro in (0, 2):
        tm = copy.deepcopy(e["tm"])
        tx = port_step.make_optimizer(tm, 0.0, 0.0)  # lr 0: grads only
        captured = {}
        step_fn = tx.step

        def spy(params, grads_, d, ok, step_fn=step_fn, captured=captured):
            captured.update({n: g.clone() for n, g in grads_.items()})
            return step_fn(params, grads_, d, ok)

        tx.step = spy
        metrics.append(port_step.make_train_step(tm, tx, microbatch=micro)(b))
        grads.append(captured)
    for n in grads[0]:
        torch.testing.assert_close(grads[1][n], grads[0][n], atol=1e-7, rtol=1e-5,
                                   msg=n)
    for k in ("loss", "acc", "grad_norm"):
        torch.testing.assert_close(metrics[1][k], metrics[0][k], atol=1e-6, rtol=1e-5)


def test_remat_gives_the_same_gradients(dense_env):
    e = dense_env
    b = _port_batch(e["batches"][1])
    grads = []
    for remat in (False, True):
        tm = STMaskGIT(e["cfg"], dtype=torch.float32, device="cpu", remat=remat)
        tm.load_state_dict(e["tm"].state_dict())
        tm(b["input_ids"], b["labels"], b["action_ids"], 0)["loss"].backward()
        grads.append({n: p.grad for n, p in tm.named_parameters() if p.grad is not None})
    assert set(grads[0]) == set(grads[1])
    for n in grads[0]:
        torch.testing.assert_close(grads[1][n], grads[0][n], atol=0, rtol=0, msg=n)
    with pytest.raises(NotImplementedError, match="remat_policy"):
        STMaskGIT(e["cfg"], dtype=torch.float32, device="cpu", remat=True,
                  remat_policy="dots")


def test_eval_step_and_unported_options(dense_env):
    e = dense_env
    b = _port_batch(e["batches"][0])
    m = port_step.make_eval_step(e["tm"])(b)
    np.testing.assert_allclose(m["loss"].item(), float(e["metrics"]["loss"]), rtol=1e-5)
    np.testing.assert_allclose(m["perplexity"].item(), np.exp(m["loss"].item()),
                               rtol=1e-6)
    # muP and bf16 moments are ported (tests/test_torch_lowp_mup.py holds
    # their updates to hma_tpu's); another moment dtype raises
    tx = port_step.make_optimizer(e["tm"], LR, mup_width_mult=2.0)
    assert set(tx.lr_mult.values()) == {0.5, 1.0}
    tx = port_step.make_optimizer(e["tm"], LR, moment_dtype=torch.bfloat16)
    assert all(m.dtype == torch.bfloat16 for m in [*tx.m.values(), *tx.v.values()])
    with pytest.raises(ValueError, match="adam_moment_dtype"):
        port_step.make_optimizer(e["tm"], LR, moment_dtype=torch.float16)
    # the optax chain the JAX step builds is what the port writes out
    assert isinstance(jax_step.make_optimizer(1e-3), optax.GradientTransformation)
