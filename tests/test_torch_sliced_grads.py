"""Sliced gradients (`make_train_step(stacked_mask=)`), port vs port and port
vs hma_tpu on the CPU, fp32, on tiny 3-domain cards of both families: the
discrete concat+modulate card, the discrete card with concat+cross_attention
and joint action prediction, and the STMAR card with joint action prediction
(its action diffusion head is a domain-stacked net) and without.

- Three steps on domains 1, 2, 1 with sliced gradients equal the port's
  full-gradient steps bit for bit (parameters, moments, counts), with fp32
  and bf16 moments and with microbatches of 2, on the first three cards:
  the same products run on a one-row view as on the full table's row.
- The same steps with fp32 moments, at one layer, on the joint
  cross-attention card and the plain STMAR card, equal `hma_tpu`'s sliced
  step (a `single_domain_params` model and its domain-sliced optimizer)
  with its draws handed in: params 1e-5, first moments 2e-5, second
  moments 4e-5 of max |want| per tensor, as tests/test_torch_train_step.py.
  With bf16 moments the link to `hma_tpu` is the bit-for-bit sliced = full
  above and tests/test_torch_lowp_mup.py's sliced bf16 update with JAX's
  rounding bits.
- During a sliced step no stacked table holds a `.grad`, and the
  optimizer receives one-row grads: the memory claim, in a form the CPU can
  check. `hma_tpu`'s guard rails raise, and `--sliced_grads` means what it
  means in `hma_tpu`.
"""

import copy
import json

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from hma_tpu.config import DiffusionGenieConfig as JaxDiffusionGenieConfig
from hma_tpu.config import GenieConfig as JaxGenieConfig
from hma_tpu.models.st_mar import STMAR as JaxSTMAR
from hma_tpu.models.st_mask_git import STMaskGIT as JaxSTMaskGIT
from hma_tpu.train import step as jax_step
from hma_tpu_torch.config import DiffusionGenieConfig, GenieConfig
from hma_tpu_torch.convert import params_from_jax
from hma_tpu_torch.data.datasets import write_token_dataset
from hma_tpu_torch.models.st_mar import STMAR
from hma_tpu_torch.models.st_mask_git import STMaskGIT
from hma_tpu_torch.train import step as port_step
from hma_tpu_torch.train_multi import main as train_main
from torch_port_helpers import JaxTrainingDraws, tiny_card, tiny_mar_card

LR, WD, EPS = 3e-3, 0.05, 1e-3
REL = {"params": 1e-5, "m": 2e-5, "v": 4e-5}
DOMAINS = (1, 2, 1)
B = 4
JOINT = dict(jointly_predict_actions=True)
CARDS = {
    "modulate": (False, {}),
    "cross_attention": (False, dict(action_network="concat+cross_attention", **JOINT)),
    "stmar": (True, JOINT),
    "stmar_plain": (True, {}),  # held to hma_tpu's: its step compiles in half the time
}
PORT_CARDS = ["modulate", "cross_attention", "stmar"]


def _card(name: str, n: int = 3, num_layers: int = 2) -> dict:
    continuous, kw = CARDS[name]
    card = (tiny_mar_card if continuous else tiny_card)(num_layers=num_layers, **kw)
    return {**card, "action_domains": [f"d{i}" for i in range(n)], "d_actions": [4] * n,
            "action_stats": card["action_stats"][:1] * n}


def _batch(name: str, seed: int, domain_id: int) -> dict:
    card, (continuous, _) = _card(name), CARDS[name]
    rng = np.random.default_rng(seed)
    T = card["T"]
    actions = rng.normal(size=(B, T, 4)).astype(np.float32)
    if continuous:
        lat = rng.normal(size=(B, T, 4, 4, card["vae_embed_dim"])).astype(np.float32)
        mask = (rng.random((B, T, 4, 4)) < 0.5).astype(np.int32)
        mask[:, 0] = 0
        return {"input_ids": lat, "labels": lat, "masked_tokens_indicator": mask,
                "action_ids": actions, "domain_id": np.int32(domain_id)}
    V = card["image_vocab_size"]
    labels = rng.integers(0, V, (B, T, card["S"])).astype(np.int32)
    mask = rng.random(labels.shape) < 0.5
    mask[:, 0] = False
    return {"input_ids": np.where(mask, V, labels).astype(np.int32), "labels": labels,
            "action_ids": actions, "domain_id": np.int32(domain_id)}


def _port_batch(b: dict) -> dict:
    out = {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                               and k != "masked_tokens_indicator" else v)
           for k, v in b.items() if k != "domain_id"}
    return {**out, "domain_id": int(b["domain_id"])}


def _port_model(name: str, seed: int = 0, num_layers: int = 2):
    continuous = CARDS[name][0]
    cls, cfg_cls = (STMAR, DiffusionGenieConfig) if continuous else (STMaskGIT, GenieConfig)
    model = cls(cfg_cls(**_card(name, num_layers=num_layers)), dtype=torch.float32, device="cpu",
                generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():  # every table live, the zero-initialised ones too
        g = torch.Generator().manual_seed(seed + 1)
        for p in model.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=g))
    stacked = port_step.domain_stacked_mask(model, cls(cfg_cls(**_card(
        name, 4, num_layers)), dtype=torch.float32, device="meta"))
    return model, stacked


def _run(model, stacked, name, sliced, moment_dtype="float32", microbatch=0,
         draws=None, spy=None):
    tx = port_step.make_domain_sliced_optimizer(
        model, port_step.custom_cosine_schedule(LR, 1, 10), WD, eps=EPS,
        stacked_mask=stacked, num_domains=3, moment_dtype=moment_dtype)
    if spy is not None:
        tx.step = spy(tx.step)
    continuous = CARDS[name][0]
    step = port_step.make_train_step(
        model, tx, microbatch=microbatch, continuous=continuous,
        action_loss_weight=model.config.action_loss_weight,
        stacked_mask=stacked if sliced else None)
    metrics = [step(_port_batch(_batch(name, 20 + i, d)), rng=i,
                    draws=None if draws is None else draws[i])
               for i, d in enumerate(DOMAINS)]
    return tx, metrics


@pytest.mark.parametrize("microbatch", [0, 2])
@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", PORT_CARDS)
def test_sliced_steps_equal_full_steps(name, moment_dtype, microbatch):
    model, stacked = _port_model(name)
    runs = []
    for sliced in (False, True):
        m = copy.deepcopy(model)
        tx, metrics = _run(m, stacked, name, sliced, moment_dtype, microbatch)
        assert all(x["skipped"].item() == 0.0 for x in metrics)
        runs.append((m, tx, metrics))
    (full, tx_f, met_f), (sl, tx_s, met_s) = runs
    for (n, a), b in zip(full.named_parameters(), sl.parameters()):
        assert torch.equal(a, b), n
    for n in tx_f.m:
        assert torch.equal(tx_f.m[n], tx_s.m[n]) and torch.equal(tx_f.v[n], tx_s.v[n]), n
    assert tx_f.domain_count == tx_s.domain_count == [0, 2, 1]
    assert tx_f.count == tx_s.count == 3
    for a, b in zip(met_f, met_s):
        assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("name", PORT_CARDS)
def test_a_sliced_step_forms_no_full_size_grad(name):
    model, stacked = _port_model(name)
    seen = []

    def spy(step):
        def check(params, grads, d, ok, noise=None):
            # at the update, after every backward of the step
            seen.append({n: (params[n].grad, tuple(g.shape)) for n, g in grads.items()})
            return step(params, grads, d, ok, noise)
        return check

    _run(model, stacked, name, sliced=True, microbatch=2, spy=spy)
    assert len(seen) == len(DOMAINS)
    names = [n for n, s in stacked.items() if s]
    assert len(names) > 10
    params = dict(model.named_parameters())
    for step in seen:
        for n in names:
            grad, shape = step[n]
            assert grad is None, n
            assert shape == (1, *params[n].shape[1:]), n
    assert all(p.grad is None for p in model.parameters())


class _ActionMasks:
    """Record the action mask of every hma_tpu STMaskGIT.compute_logits
    call traced inside the block (the joint card's action drop)."""

    def __enter__(self):
        self.masks = []

        def intercept(next_fun, args, kwargs, context):
            if (isinstance(context.module, JaxSTMaskGIT)
                    and context.method_name == "compute_logits"):
                self.masks.append(args[3] if len(args) > 3 else kwargs.get("action_mask"))
            return next_fun(*args, **kwargs)

        self._ctx = fnn.intercept_methods(intercept)
        self._ctx.__enter__()
        return self

    def __exit__(self, *exc):
        self._ctx.__exit__(*exc)


def _jax_sliced_steps(name: str):
    """hma_tpu's sliced-gradient step: 3 jitted steps with its draws
    recorded, from random parameters of the card's shapes, at one layer
    (each layer more adds seconds of tracing and compiling)."""
    continuous = CARDS[name][0]
    card, more = _card(name, num_layers=1), _card(name, 4, num_layers=1)
    cfg_cls, cls = ((JaxDiffusionGenieConfig, JaxSTMAR) if continuous
                    else (JaxGenieConfig, JaxSTMaskGIT))
    jcfg = cfg_cls(**card)
    jm = cls(jcfg, dtype=jnp.float32)
    keys = {k: jax.random.PRNGKey(0) for k in ("params", "diffusion", "action_drop")}
    b0 = {k: jnp.asarray(v) for k, v in _batch(name, 0, 0).items()}
    args = [b0["input_ids"], b0["labels"], b0["action_ids"], b0["domain_id"]]
    if continuous:
        args.append(b0["masked_tokens_indicator"])
    rng = np.random.default_rng(3)
    params = jax.tree.map(lambda s: (0.1 * rng.normal(size=s.shape)).astype(np.float32),
                          jax.eval_shape(jm.init, keys, *args))
    smask = jax_step.domain_stacked_mask(
        params, jax.eval_shape(cls(cfg_cls(**more), dtype=jnp.float32).init, keys, *args))
    tx = jax_step.make_domain_sliced_optimizer(
        jax_step.custom_cosine_schedule(LR, 1, 10), WD, eps=EPS, params_template=params,
        stacked_mask=smask, num_domains=3)
    step = jax_step.make_train_step(
        cls(jcfg, dtype=jnp.float32, single_domain_params=True), tx,
        continuous=continuous, action_loss_weight=jcfg.action_loss_weight,
        stacked_mask=smask)

    @jax.jit
    def step_rec(state, batch, key):
        with JaxTrainingDraws() as rec, _ActionMasks() as am:
            state, _ = step(state, batch, key)
        return state, rec.tree(), am.masks

    state = jax_step.TrainState(params, jax.jit(tx.init)(params), jnp.asarray(0))
    draws = []
    for i, d in enumerate(DOMAINS):
        state, tree, masks = step_rec(state, {k: jnp.asarray(v) for k, v in
                                              _batch(name, 20 + i, d).items()},
                                      jax.random.PRNGKey(i))
        if continuous:
            draws.append(JaxTrainingDraws.of(tree).draws(0, 0))
        else:
            draws.append({"action_mask": torch.from_numpy(np.array(masks[0]))})
    return params, smask, state, draws, cfg_cls


@pytest.mark.parametrize("name", ["cross_attention", "stmar_plain"])
def test_sliced_steps_match_jax_sliced_steps(name):
    params, smask, state, draws, _ = _jax_sliced_steps(name)
    continuous = CARDS[name][0]
    cfg = (DiffusionGenieConfig if continuous else GenieConfig)(**_card(name, num_layers=1))
    model = (STMAR if continuous else STMaskGIT)(cfg, dtype=torch.float32, device="cpu")
    model.load_state_dict(params_from_jax(params, cfg))
    _, stacked = _port_model(name, num_layers=1)
    tx, metrics = _run(model, stacked, name, sliced=True, draws=draws)
    assert all(m["skipped"].item() == 0.0 for m in metrics)
    opt = state.opt_state
    want = {"params": params_from_jax(state.params, cfg),
            "m": params_from_jax(jax_step._combine(smask, opt.dense[0].mu, opt.m), cfg),
            "v": params_from_jax(jax_step._combine(smask, opt.dense[0].nu, opt.v), cfg)}
    got = {"params": dict(model.named_parameters()), "m": tx.m, "v": tx.v}
    for what in ("params", "m", "v"):
        assert set(got[what]) == set(want[what])
        for n, w in want[what].items():
            err, scale = (got[what][n].detach() - w).abs().max().item(), w.abs().max().item()
            assert err <= REL[what] * scale + 1e-8, \
                f"{what} {n}: max|d| {err:.3e}, max|want| {scale:.3e}"
    assert tx.domain_count == np.asarray(opt.count).tolist() == [0, 2, 1]
    assert tx.count == int(opt.gcount) == 3


def test_guard_rails_raise():
    model, stacked = _port_model("modulate")
    with pytest.raises(ValueError, match="domain-sliced optimizer"):
        port_step.make_train_step(model, port_step.make_optimizer(model, LR),
                                  stacked_mask=stacked)
    tx = port_step.make_domain_sliced_optimizer(model, LR, stacked_mask=stacked,
                                                num_domains=3)
    other = {**stacked, next(iter(stacked)): not stacked[next(iter(stacked))]}
    with pytest.raises(ValueError, match="stacked_mask differs"):
        port_step.make_train_step(model, tx, stacked_mask=other)


def test_sliced_grads_flag_means_what_it_means_in_hma_tpu(tmp_path):
    """auto: on with the domain-sliced AdamW on one process; on / off force
    it; one domain (the dense AdamW) has nothing to slice."""
    rng = np.random.default_rng(0)
    for domain in ("a", "b"):
        write_token_dataset(tmp_path / f"{domain}_magvit_max1000000_train",
                            rng.integers(0, 2**18, (20, 4, 4)).astype(np.uint32),
                            np.repeat(np.arange(2), 10), rng.normal(size=(20, 2)).astype(np.float32),
                            {"name": domain, "vocab_size": 2**18, "s": 16})
    GenieConfig(num_layers=2, num_heads=2, d_model=32, T=4, S=16, image_vocab_size=2**18,
                num_factored_vocabs=2, action_token_size=8, action_network="concat+modulate",
                num_prompt_frames=2, use_actions=True).save_pretrained(str(tmp_path / "c.json"))
    active = {}
    for split, flag in (("a,b", "auto"), ("a,b", "on"), ("a,b", "off"), ("a", "auto")):
        (tmp_path / "s.yaml").write_text(yaml.safe_dump({"domains": split}))
        out = tmp_path / f"{split}_{flag}"
        train_main(["--genie_config", str(tmp_path / "c.json"), "--output_dir", str(out),
                    "--train_split", str(tmp_path / "s.yaml"), "--data_root", str(tmp_path),
                    "--window_size", "4", "--per_device_train_batch_size", "2",
                    "--max_train_steps", "1", "--overfit_first_batch",
                    "--sliced_grads", flag, "--device", "cpu"])
        cfg = json.loads(open(out / "metrics.jsonl").readline())["_config"]
        active[split, flag] = (cfg["sliced_grads_active"], cfg["world_size"])
    assert active == {("a,b", "auto"): (True, 1), ("a,b", "on"): (True, 1),
                      ("a,b", "off"): (False, 1), ("a", "auto"): (False, 1)}
