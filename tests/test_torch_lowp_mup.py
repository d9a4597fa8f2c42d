"""bf16 Adam moments with stochastic rounding, muP and the warmup cosine
schedule, port vs hma_tpu on the CPU. The random bits of every rounding are
JAX's (`jax.random.bits` from hma_tpu's keys), handed to the port, since the
two RNGs never agree. The optimizers run on random parameters and grads of
the tiny cards' shapes, with grads small enough that the clip leaves them as
they are: the moments then see the same fp32 grads on both sides.

Tolerances: stochastic rounding and the bf16 moments bit for bit; params
max |got - want| <= 1e-5 * max |want| per tensor (the bias corrections are
fp32 in JAX and double in the port); fp32 moments of the muP steps 1e-5
relative; schedules 1e-6 relative; `mup_matrix_mask` name by name."""

import dataclasses
import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from torch import nn

from hma_tpu.config import DiffusionGenieConfig as JaxDiffusionGenieConfig
from hma_tpu.config import GenieConfig as JaxGenieConfig
from hma_tpu.models.st_mar import STMAR as JaxSTMAR
from hma_tpu.models.st_mask_git import STMaskGIT as JaxSTMaskGIT
from hma_tpu.train import lowp as jax_lowp
from hma_tpu.train import step as jax_step
from hma_tpu_torch.config import DiffusionGenieConfig, GenieConfig, load_config
from hma_tpu_torch.convert import params_from_jax
from hma_tpu_torch.data.datasets import write_token_dataset
from hma_tpu_torch.models.action_stems import DomainDense
from hma_tpu_torch.models.attention import Dense, LayerNorm
from hma_tpu_torch.models.st_mar import STMAR
from hma_tpu_torch.models.st_mask_git import STMaskGIT
from hma_tpu_torch.train import step as port_step
from hma_tpu_torch.train import trainer
from hma_tpu_torch.train.lowp import resolve_moment_dtype, stochastic_round
from hma_tpu_torch.train_multi import main as train_main
from torch_port_helpers import (
    jax_tree_from_port,
    port_names,
    tiny_card,
    tiny_mar_card,
)

ROOT = Path(__file__).resolve().parent.parent
LR, WD, EPS = 3e-3, 0.05, 1e-3
REL = 1e-5
MOMENT_SHARE = 1e-3
JOINT = dict(action_network="concat+cross_attention", jointly_predict_actions=True)


def _domains(card: dict, n: int) -> dict:
    return {**card, "action_domains": [f"d{i}" for i in range(n)],
            "d_actions": [4] * n, "action_stats": card["action_stats"][:1] * n}


def _shapes(card: dict, continuous: bool = False):
    """jax.eval_shape of the card's init: the param tree's shapes, no FLOPs
    (traced once a card)."""
    return _shapes_of(json.dumps(card, sort_keys=True), continuous)


@functools.lru_cache(maxsize=None)
def _shapes_of(card_json: str, continuous: bool):
    card = json.loads(card_json)
    cfg = (JaxDiffusionGenieConfig if continuous else JaxGenieConfig)(**card)
    jm = (JaxSTMAR if continuous else JaxSTMaskGIT)(cfg, dtype=jnp.float32)
    T, S, da = cfg.T, cfg.S, cfg.max_d_action
    f32 = jnp.float32
    keys = {k: jax.random.PRNGKey(0) for k in ("params", "diffusion", "action_drop")}
    acts, dom = jax.ShapeDtypeStruct((1, T, da), f32), jnp.asarray(0, jnp.int32)
    if continuous:  # the diffusion heads' parameters come from the loss
        x = jax.ShapeDtypeStruct((1, T, cfg.h, cfg.h, cfg.vae_embed_dim), f32)
        return jax.eval_shape(jm.init, keys, x, x, acts, dom,
                              jax.ShapeDtypeStruct((1, T, cfg.h, cfg.h), jnp.int32))
    # the full forward makes every parameter (the loss reads none more)
    x = jax.ShapeDtypeStruct((1, T, S), jnp.int32)
    return jax.eval_shape(functools.partial(jm.init, method=JaxSTMaskGIT.compute_logits),
                          keys, x, acts, dom)


def _port_model(card: dict, continuous: bool = False, device="cpu"):
    cls, cfg_cls = (STMAR, DiffusionGenieConfig) if continuous else (STMaskGIT, GenieConfig)
    return cls(cfg_cls(**card), dtype=torch.float32, device=device)


def test_stochastic_round_bit_for_bit():
    """64K values across magnitudes and the specials (+-0, +-inf, NaN, the
    largest finite fp32, which may round up to inf, the smallest
    subnormals), against hma_tpu's with the bits its key gives."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=1 << 16) * 10.0 ** rng.integers(-30, 30, 1 << 16)).astype(np.float32)
    specials = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan,
                         3.4028235e38, -3.4028235e38, 1e-45, -1e-45, 1.0, -1.0],
                        np.float32)
    x[:specials.size] = specials
    key = jax.random.PRNGKey(7)
    want = np.asarray(jax_lowp.stochastic_round(jnp.asarray(x), jnp.bfloat16, key))
    bits = np.array(jax.random.bits(key, x.shape, jnp.uint32))
    got = stochastic_round(torch.from_numpy(x), torch.from_numpy(bits.view(np.int32)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))
    # each finite result is one of its value's two bf16 neighbours
    down = (torch.from_numpy(x).view(torch.int32) & -0x10000).view(torch.float32)
    fin = torch.isfinite(got)
    assert (got.float() - down).abs()[fin].le(down.abs()[fin] * 2**-7 + 1e-45).all()
    assert resolve_moment_dtype("bfloat16") is torch.bfloat16
    assert resolve_moment_dtype("float32") is None


class Toy(nn.Module):
    """One leaf of each kind the optimizers treat apart: a domain-stacked
    table (kernel and bias), a LayerNorm (undecayed scale), a Dense whose
    one dim follows the width and one whose two do, and a raw tensor.
    `tree` is the same as an hma_tpu param tree."""

    def __init__(self, num_domains: int, width: int = 48, device="cpu"):
        super().__init__()
        self.table = DomainDense(num_domains, width, width, dtype=torch.float32,
                                 device=device)
        self.ln = LayerNorm(width, device=device)
        self.head = Dense(width, 96, True, torch.float32, device)
        self.square = Dense(width, width, False, torch.float32, device)
        self.tokens = nn.Parameter(torch.zeros(1, 3, 1, width, device=device))

    @staticmethod
    def shapes(num_domains: int, width: int = 48) -> dict:
        d = width
        return {"params": {"table": {"kernel": (num_domains, d, d), "bias": (num_domains, d)},
                           "ln": {"scale": (d,), "bias": (d,)},
                           "head": {"kernel": (d, 96), "bias": (96,)},
                           "square": {"kernel": (d, d)}, "tokens": (1, 3, 1, d)}}

    @staticmethod
    def tree(num_domains: int, rng, scale: float, width: int = 48) -> dict:
        return jax.tree.map(lambda s: (scale * rng.normal(size=s)).astype(np.float32),
                            Toy.shapes(num_domains, width),
                            is_leaf=lambda x: isinstance(x, tuple))


@pytest.fixture(scope="module")
def opt_env():
    """Toy parameters over 2 domains, 5 steps of grads (step 2 holds a NaN:
    the guard skips it) with each step's domain, and the stacked mask."""
    rng = np.random.default_rng(0)
    params = Toy.tree(2, rng, 0.1)
    mask = jax_step.domain_stacked_mask(params, Toy.tree(3, rng, 0.0))
    domains = (1, 1, 0, 1, 0)
    grads = []
    for i, d in enumerate(domains):
        g = Toy.tree(2, rng, 1e-3)
        # a stacked table's grad lives in the active domain's row alone
        g = jax.tree.map(lambda x, m: x * (np.arange(x.shape[0]) == d).reshape(
            -1, *[1] * (x.ndim - 1)).astype(np.float32) if m else x, g, mask)
        if i == 2:
            g["params"]["head"]["kernel"][3, 5] = np.nan
        grads.append(g)
    return dict(params=params, mask=mask, domains=domains, grads=grads)


def _recorded_bits(monkeypatch) -> list:
    """A list that receives, in call order, the 16 random bits of every
    stochastic rounding hma_tpu's lowp optimizers make while the list is
    live (a traced function returns them): the bits that its key for that
    leaf and moment gives."""
    sink = []
    round_ = jax_lowp.stochastic_round

    def recording(x, dtype, key):
        sink.append(jax.random.bits(key, x.shape, jnp.uint32) & jnp.uint32(0xFFFF))
        return round_(x, dtype, key)

    monkeypatch.setattr(jax_lowp, "stochastic_round", recording)
    return sink


def _port(tree) -> dict:
    """A toy tree as {port name: fp32 tensor} (`params_from_jax`)."""
    return params_from_jax(jax.tree.map(lambda x: np.asarray(x, np.float32), tree), None)


def _port_noise(m_tree, v_tree, stacked=None, rows=()):
    """{port name: (m bits, v bits)} int32. The leaves that `stacked` (the
    JAX mask) marks hold a row's bits: they cross the name map with a
    leading axis, taken off again for the port names in `rows`."""
    if stacked is not None:
        m_tree, v_tree = (jax.tree.map(lambda s, x: np.asarray(x)[None] if s else x,
                                       stacked, t) for t in (m_tree, v_tree))
    m, v = _port(m_tree), _port(v_tree)
    return {n: tuple((x[n][0] if n in rows else x[n]).to(torch.int32) for x in (m, v))
            for n in m}


def _assert_close(got: dict, want: dict, what: str, rel=REL):
    assert set(got) == set(want), what
    for n, w in want.items():
        err = (got[n].detach().float() - w).abs().max().item()
        assert err <= rel * w.abs().max().item() + 1e-12, f"{what} {n}: {err:.3e}"


def _assert_moments(got: dict, want: dict, what: str):
    """bf16 moments bit for bit but for at most MOMENT_SHARE of their
    elements, which are the neighbouring bf16 value (XLA's CPU fuses
    b1 m + (1 - b1) g into one fma, the port rounds b1 m: a 1-ulp fp32
    difference meets the random threshold about once in 2^16 draws)."""
    differ = total = 0
    for n, w in want.items():
        g = got[n]
        assert g.dtype == torch.bfloat16, n
        assert ((g.float() - w).abs() <= w.abs() * 2**-7).all(), f"{what} {n}"
        differ += (g.float() != w).sum().item()
        total += w.numel()
    assert differ <= MOMENT_SHARE * total, f"{what}: {differ} of {total} differ"


def _toy(num_domains=2):
    tm = Toy(num_domains)
    return tm, dict(tm.named_parameters())


def test_dense_bf16_adamw_matches_jax(opt_env, monkeypatch):
    e = opt_env
    params = e["params"]
    sched = jax_step.custom_cosine_schedule(LR, 1, 10)
    tx = jax_step.make_optimizer(sched, WD, eps=EPS, params_template=params,
                                 moment_dtype=jnp.bfloat16)
    sink = _recorded_bits(monkeypatch)
    treedef = jax.tree.structure(params)

    @jax.jit
    def jstep(p, state, g):
        # hma_tpu's train step around the dense optimizer (train/step.py)
        sink.clear()
        ok = jnp.isfinite(optax.global_norm(g))
        g = jax.tree.map(lambda x: jnp.where(ok, x, jnp.zeros_like(x)), g)
        updates, state = tx.update(g, state, p)
        p = jax.tree.map(lambda a, u: a + u * ok.astype(jnp.float32), p, updates)
        return p, state, list(sink)  # every m leaf's bits, then every v leaf's

    tm, named = _toy()
    tm.load_state_dict(_port(params))
    ptx = port_step.make_optimizer(tm, port_step.custom_cosine_schedule(LR, 1, 10), WD,
                                   eps=EPS, moment_dtype="bfloat16")
    jp, state = params, tx.init(params)
    for i, g in enumerate(e["grads"]):
        jp, state, bits = jstep(jp, state, g)
        half = len(bits) // 2
        noise = _port_noise(jax.tree.unflatten(treedef, bits[:half]),
                            jax.tree.unflatten(treedef, bits[half:]))
        before = {n: p.detach().clone() for n, p in named.items()}
        ptx.step(named, _port(g), 0, torch.tensor(True), noise=noise)
        if i == 2:  # the NaN step: nothing moves
            assert all(torch.equal(named[n], before[n]) for n in named)
    adam = state[1][0]  # chain(clip, chain(scale_by_adam_lowp, decay, lr))
    _assert_close(named, _port(jp), "params")
    _assert_moments(ptx.m, _port(adam.mu), "m")
    _assert_moments(ptx.v, _port(adam.nu), "v")
    assert ptx.count == int(adam.count) == 5


def test_sliced_bf16_adamw_matches_jax(opt_env, monkeypatch):
    e = opt_env
    params, mask = e["params"], e["mask"]
    sched = jax_step.custom_cosine_schedule(LR, 1, 10)
    tx = jax_step.make_domain_sliced_optimizer(
        sched, WD, eps=EPS, params_template=params, stacked_mask=mask, num_domains=2,
        moment_dtype=jnp.bfloat16)
    sink = _recorded_bits(monkeypatch)

    @jax.jit
    def apply(*args):
        # the dense leaves' m bits, then their v bits (the inner optax
        # chain), then each stacked leaf's row m and v bits in turn
        sink.clear()
        return (*tx.update_and_apply(*args), list(sink))

    tm, named = _toy()
    tm.load_state_dict(_port(params))
    stacked = port_step.domain_stacked_mask(tm, Toy(3, device="meta"))
    assert stacked == {n: n.startswith("table.") for n in stacked}
    ptx = port_step.make_domain_sliced_optimizer(
        tm, port_step.custom_cosine_schedule(LR, 1, 10), WD, eps=EPS,
        stacked_mask=stacked, num_domains=2, moment_dtype=torch.bfloat16)
    dense_def = jax.tree.structure(jax_step._prune(mask, params, False))
    stacked_def = jax.tree.structure(jax_step._prune(mask, params, True))
    n_dense = dense_def.num_leaves
    jp, state = params, tx.init(params)
    for i, (d, g) in enumerate(zip(e["domains"], e["grads"])):
        jp, state, _, bits = apply(g, state, jp, jnp.asarray(d, jnp.int32), jnp.asarray(True))
        dense = [jax.tree.unflatten(dense_def, bits[k * n_dense:(k + 1) * n_dense])
                 for k in (0, 1)]
        rows = bits[2 * n_dense:]
        stacked_bits = [jax.tree.unflatten(stacked_def, rows[k::2]) for k in (0, 1)]
        noise = _port_noise(*(jax_step._combine(mask, dense[k], stacked_bits[k]) for k in (0, 1)),
                            mask, [n for n, s in stacked.items() if s])
        before = {n: (p.detach().clone(), ptx.m[n].clone(), ptx.v[n].clone())
                  for n, p in named.items()}
        ptx.step(named, _port(g), d, torch.tensor(True), noise=noise)
        for n, (p0, m0, v0) in before.items():
            if stacked[n]:  # the other domain's rows stay untouched
                o = 1 - d
                assert torch.equal(named[n][o], p0[o]) and torch.equal(ptx.m[n][o], m0[o]) \
                    and torch.equal(ptx.v[n][o], v0[o]), n
            if i == 2:  # the NaN step: no parameter moves
                assert torch.equal(named[n], p0), n
    _assert_close(named, _port(jp), "params")
    _assert_moments(ptx.m, _port(jax_step._combine(mask, state.dense[0].mu, state.m)), "m")
    _assert_moments(ptx.v, _port(jax_step._combine(mask, state.dense[0].nu, state.v)), "v")
    assert ptx.domain_count == [int(c) for c in state.count] == [2, 3]


def _mask_of(card, continuous, base_card=None):
    """(hma_tpu's mup_matrix_mask, the port's) as {port name: bool}; with
    `base_card` against that card's shapes, else the name rule."""
    shapes = _shapes(card, continuous)
    cfg = (DiffusionGenieConfig if continuous else GenieConfig)(**card)
    model = _port_model(card, continuous, device="meta")
    if base_card is None:
        want = jax_step.mup_matrix_mask(shapes)
        got = port_step.mup_matrix_mask(model)
    else:
        want = jax_step.mup_matrix_mask(shapes, _shapes(base_card, continuous))
        base = trainer.mup_base_model(model, cfg)
        assert base.config.d_model == base_card["d_model"]
        got = port_step.mup_matrix_mask(model, base)
    return dict(zip(port_names(shapes, cfg), jax.tree.leaves(want))), got


def _half_heads(card):
    return {**card, "d_model": card["num_heads"] * max(card["d_model"] // card["num_heads"] // 2, 1)}


@pytest.mark.parametrize("name", ["tiny", "tiny_mar", "mar_d512", "magvit_d512"])
def test_mup_matrix_mask_matches_jax(name):
    """The tiny cards (the discrete one with cross-attention and the action
    readout) and the d512 cards' widths (512; 488 in heads of 61) at 2
    layers, from shapes alone (jax.eval_shape, device="meta")."""
    continuous = "mar" in name
    if name.startswith("tiny"):
        card = (_domains(tiny_mar_card(**JOINT), 2) if continuous
                else _domains(tiny_card(True, **JOINT), 2))
    else:
        card = json.loads((ROOT / "hma_tpu_torch" / "configs" / (
            "mar_n32_h8_d512_action.json" if continuous
            else "magvit_n32_h8_d512_action.json")).read_text())
        card.pop("Diffusion", None)
        card = _domains({**card, "num_layers": 2,
                         "action_stats": tiny_card()["action_stats"]}, 2)
    want, got = _mask_of(card, continuous, _half_heads(card))
    assert got == want
    assert sum(got.values()) and not all(got.values())
    if name == "tiny":
        assert got["decoder.layers.0.action_projector.to_q.kernel"]
        assert not got["decoder.layers.0.action_projector.qk_ln_scale"]
        assert not got["action_readout.out.kernel"]
        want, got = _mask_of(card, False)  # the name rule, without a base
        assert got == want


def _moments(state, k: str):
    """The `k` ("mu" or "nu") tree of hma_tpu's muP AdamW state: an
    optax.multi_transform over the "matrix" and "other" partitions."""
    inner = state.inner_states
    masked = lambda x: isinstance(x, optax.MaskedNode)  # noqa: E731
    return jax.tree.map(lambda a, b: b if masked(a) else a,
                        getattr(inner["other"].inner_state[0], k),
                        getattr(inner["matrix"].inner_state[0], k), is_leaf=masked)


def test_mup_steps_match_jax(opt_env):
    """Width mult 2 on the toy: 2 dense fp32 steps with the name rule (no
    base), and 2 sliced fp32 steps against the half-width toy's shapes,
    against hma_tpu's optimizers. The two rules part: the name rule takes
    the head and the raw tensor for matrices, the base rule does not."""
    e = opt_env
    params, mask = e["params"], e["mask"]
    base = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s, jnp.float32), Toy.shapes(2, 24),
                        is_leaf=lambda x: isinstance(x, tuple))
    grads = [jax.tree.map(lambda g: np.nan_to_num(g), g) for g in e["grads"][:2]]
    sched = jax_step.custom_cosine_schedule(LR, 1, 10)
    psched = port_step.custom_cosine_schedule(LR, 1, 10)
    for sliced in (False, True):
        tm, named = _toy()
        tm.load_state_dict(_port(params))
        if sliced:
            tx = jax_step.make_domain_sliced_optimizer(
                sched, WD, eps=EPS, params_template=params, stacked_mask=mask,
                num_domains=2, mup_width_mult=2.0, mup_base_shapes=base)
            ptx = port_step.make_domain_sliced_optimizer(
                tm, psched, WD, eps=EPS, stacked_mask={n: n.startswith("table.") for n in named},
                num_domains=2, mup_width_mult=2.0, mup_base=Toy(2, 24, device="meta"))
            assert {n for n, m in ptx.lr_mult.items() if m != 1} == {"table.kernel",
                                                                     "square.weight"}
            step = jax.jit(tx.update_and_apply)
            state, jp = tx.init(params), params
            for d, g in zip(e["domains"], grads):
                ptx.step(named, _port(g), d, torch.tensor(True))
                jp, state, _ = step(g, state, jp, jnp.asarray(d, jnp.int32), jnp.asarray(True))
            mu = jax_step._combine(mask, _moments(state.dense, "mu"), state.m)
            nu = jax_step._combine(mask, _moments(state.dense, "nu"), state.v)
        else:
            tx = jax_step.make_optimizer(sched, WD, eps=EPS, params_template=params,
                                         mup_width_mult=2.0)
            ptx = port_step.make_optimizer(tm, psched, WD, eps=EPS, mup_width_mult=2.0)
            assert {n for n, m in ptx.lr_mult.items() if m != 1} == {
                "table.kernel", "square.weight", "head.weight", "tokens"}
            upd = jax.jit(tx.update)
            state, jp = tx.init(params), params
            for g in grads:
                ptx.step(named, _port(g), 0, torch.tensor(True))
                u, state = upd(g, state, jp)
                jp = optax.apply_updates(jp, u)
            mu, nu = _moments(state[1], "mu"), _moments(state[1], "nu")
        _assert_close(named, _port(jp), f"params sliced={sliced}")
        _assert_close(ptx.m, _port(mu), f"m sliced={sliced}")
        _assert_close(ptx.v, _port(nu), f"v sliced={sliced}")


@pytest.mark.parametrize("warmup", [0, 1, 3])
def test_warmup_cosine_schedule_matches_optax(warmup):
    total = 10
    want = optax.warmup_cosine_decay_schedule(0.0, 2e-3, warmup, total)
    got = port_step.warmup_cosine_decay_schedule(2e-3, warmup, total)
    for s in range(total + 3):
        np.testing.assert_allclose(got(s), float(want(s)), rtol=1e-6, atol=1e-12,
                                   err_msg=str(s))


@pytest.fixture(scope="module")
def lowp_run(tmp_path_factory):
    """Two token domains, the tiny joint cross-attention card at 1 layer, and a straight
    3-step run of train_multi with --mu_transfer --adam_moment_dtype
    bfloat16 --lr_scheduler_type linear, recording the first step's
    parameters and grads as the optimizer receives them."""
    root = tmp_path_factory.mktemp("port_lowp")
    rng = np.random.default_rng(0)
    domains = ("language_table", "bridge")
    for domain in domains:
        write_token_dataset(
            root / "data" / f"{domain}_magvit_max1000000_train",
            rng.integers(0, 2**18, (40, 4, 4)).astype(np.uint32),
            np.repeat(np.arange(4), 10), rng.normal(size=(40, 2)).astype(np.float32),
            {"name": domain, "vocab_size": 2**18, "s": 16})
    card = tiny_card(True, num_layers=1, **JOINT)
    card.update(num_prompt_frames=2, action_domains=None, d_actions=None,
                action_stats=None)
    GenieConfig(**card).save_pretrained(str(root / "config.json"))
    (root / "split.yaml").write_text(yaml.safe_dump({"domains": ",".join(domains)}))

    def argv(out, *extra):
        return ["--genie_config", str(root / "config.json"), "--output_dir", str(out),
                "--train_split", str(root / "split.yaml"), "--data_root", str(root / "data"),
                "--window_size", "4", "--per_device_train_batch_size", "2",
                "--learning_rate", "3e-3", "--eval_every_n_steps", "100",
                "--max_eval_steps", "1", "--checkpointing_steps", "2",
                "--num_warmup_steps", "1", "--log_every", "1", "--seed", "3",
                "--vis_every_n_steps", "0", "--max_train_steps", "3", "--overfit_first_batch",
                "--mu_transfer", "--adam_moment_dtype", "bfloat16",
                "--lr_scheduler_type", "linear", "--device", "cpu", *extra]

    first = {}
    make_step = trainer.make_train_step

    def recording(model, tx, **kw):
        opt_step = tx.step

        def step(params, grads, domain_id, ok_loss, noise=None):
            if first:
                return opt_step(params, grads, domain_id, ok_loss, noise)
            first.update(params={n: p.detach().clone() for n, p in params.items()},
                         grads={n: g.clone() for n, g in grads.items()},
                         domain=int(domain_id))
            out = opt_step(params, grads, domain_id, ok_loss, noise)
            first.update(after={n: p.detach().clone() for n, p in params.items()},
                         m={n: t.clone() for n, t in tx.m.items()},
                         v={n: t.clone() for n, t in tx.v.items()})
            return out

        tx.step = step
        return make_step(model, tx, **kw)

    trainer.make_train_step = recording
    try:
        train_main(argv(root / "straight"))
    finally:
        trainer.make_train_step = make_step
    return root, argv, first


def test_lowp_mup_trainer_resumes_bit_for_bit(lowp_run):
    root, argv, _ = lowp_run
    straight, resumed = root / "straight", root / "resumed"
    train_main(argv(resumed, "--resume_from_checkpoint", str(straight / "step_2")))
    for name in ("model.pt", "train_state.pt"):
        a, b = (torch.load(d / "final_checkpt" / name, weights_only=True)
                for d in (straight, resumed))
        if name == "train_state.pt":  # the bf16 moments, bit for bit
            assert a["step"] == b["step"] == 3
            assert a["opt_state"]["domain_count"] == b["opt_state"]["domain_count"]
            a, b = ({f"{k}.{n}": t for k in ("m", "v") for n, t in s["opt_state"][k].items()}
                    for s in (a, b))
            assert all(t.dtype == torch.bfloat16 for t in a.values())
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_lowp_mup_trainer_first_step_matches_jax(lowp_run):
    """The first update of the trainer's optimizer (sliced, muP at width
    mult 32 / 256 against the half-head-dim card, bf16 moments, the linear
    flag's warmup cosine schedule) from the parameters and grads it received,
    against the optimizer hma_tpu's trainer builds for the same run. The
    first update reads the fp32 moments before they are rounded, so its
    parameters do not depend on the moment dtype: hma_tpu's runs with fp32
    moments (its bf16 path draws bits for every leaf, ~10 s of compile
    here), and the port's bf16 moments must each be one of the two bf16
    neighbours of hma_tpu's fp32 ones."""
    root, _, first = lowp_run
    cfg = load_config(str(root / "straight" / "step_2" / "config.json"))
    card = dataclasses.asdict(cfg)
    assert card["use_mup"] and card["action_network"] == "concat+cross_attention"
    shapes = _shapes(card)
    other = _shapes({**card, "d_actions": cfg.d_actions + cfg.d_actions[-1:],
                     "action_domains": cfg.action_domains + ["__probe__"],
                     "action_stats": cfg.action_stats + cfg.action_stats[-1:]})
    base_shapes = _shapes(_half_heads(card))
    params = jax_tree_from_port(first["params"], shapes, cfg)
    grads = jax_tree_from_port(first["grads"], shapes, cfg)
    sched = optax.warmup_cosine_decay_schedule(0.0, 3e-3, 1, 3)
    mask = jax_step.domain_stacked_mask(shapes, other)
    tx = jax_step.make_domain_sliced_optimizer(
        sched, 0.05, 0.9, 0.999, 1e-8, 1.0, params_template=params, stacked_mask=mask,
        num_domains=2, mup_width_mult=cfg.d_model / 256.0, mup_base_shapes=base_shapes)
    jp, state, _ = jax.jit(lambda g, p, d: tx.update_and_apply(g, tx.init(p), p, d, True))(
        grads, params, jnp.asarray(first["domain"], jnp.int32))
    _assert_close(first["after"], params_from_jax(jp, cfg), "params")
    for k, want in (("m", jax_step._combine(mask, _moments(state.dense, "mu"), state.m)),
                    ("v", jax_step._combine(mask, _moments(state.dense, "nu"), state.v))):
        for n, w in params_from_jax(want, cfg).items():
            got = first[k][n]
            assert got.dtype == torch.bfloat16, n
            down = (w.view(torch.int32) & -0x10000).view(torch.float32)
            up = torch.where(w == down, down, (down.view(torch.int32) + 0x10000).view(
                torch.float32))
            assert ((got.float() == down) | (got.float() == up)).all(), f"{k} {n}"
