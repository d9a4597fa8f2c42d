"""The port's shipped cards against hma_tpu's, and the head dims they give
the attention kernels, on the CPU:

- every card in hma_tpu_torch/configs/ is a byte copy of its twin in
  hma_tpu/configs/, and the port's `load_config` reads the same fields;
- every shipped card's head dim passes the kernels' launch checks
  (`_build._check`), D 65 and 128 raise; a D 61 view of the (..., 3, H, 61)
  projection is taken at any alignment, while a D 32 row one element past
  a 16-byte boundary still raises;
- a tiny card with 2 heads of D 61 (d_model 122, the magvit d512 card's head
  dim) matches hma_tpu in fp32: the logits, and one training step with the
  dense AdamW (loss, grad norm, first moments, which are 0.1 x the
  gradients after one step, and the parameters).

Tolerances as in tests/test_torch_st_maskgit.py (logits 1e-4) and
tests/test_torch_train_step.py (per tensor, max |got - want| <= rel *
max |want| + 1e-8: params 1e-5, first moments 2e-5; loss 1e-5 relative).
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hma_tpu.config import load_config as jax_load_config
from hma_tpu.models.st_mask_git import STMaskGIT as JaxSTMaskGIT
from hma_tpu.train import step as jax_step
from hma_tpu_torch.config import load_config
from hma_tpu_torch.convert import params_from_jax
from hma_tpu_torch.ops import _build
from hma_tpu_torch.train import step as port_step
from torch_port_helpers import build_pair, to_torch

ROOT = Path(__file__).resolve().parent.parent
CARDS = sorted(p.name for p in (ROOT / "hma_tpu" / "configs").glob("*.json"))
LR, WD, EPS = 3e-3, 0.05, 1e-3


def test_the_port_ships_every_card():
    assert len(CARDS) == 6
    assert sorted(p.name for p in (ROOT / "hma_tpu_torch" / "configs").glob("*.json")) == CARDS


@pytest.mark.parametrize("card", CARDS)
def test_card_is_a_byte_copy(card):
    port = (ROOT / "hma_tpu_torch" / "configs" / card).read_bytes()
    assert port == (ROOT / "hma_tpu" / "configs" / card).read_bytes()


@pytest.mark.parametrize("card", CARDS)
def test_load_config_reads_what_hma_tpu_reads(card):
    got = load_config(str(ROOT / "hma_tpu_torch" / "configs" / card))
    want = jax_load_config(str(ROOT / "hma_tpu" / "configs" / card))
    assert type(got).__name__ == type(want).__name__
    for name in got.__dataclass_fields__:
        assert getattr(got, name) == getattr(want, name), name
    for name in ("S", "max_d_action", "num_domains"):
        assert getattr(got, name) == getattr(want, name), name


def _rows(D, dtype=torch.bfloat16):
    return [torch.zeros(1, 1, 8, D, dtype=dtype) for _ in range(3)]


@pytest.mark.parametrize("card", CARDS)
def test_every_card_head_dim_passes_the_kernel_checks(card):
    cfg = load_config(str(ROOT / "hma_tpu_torch" / "configs" / card))
    D = cfg.d_model // cfg.num_heads
    assert D in (16, 32, 61, 64)
    for dtype in (torch.float32, torch.bfloat16):
        _build._check("fused_attention_fwd", _rows(D, dtype), 1024)


@pytest.mark.parametrize("D", [65, 128])
def test_head_dims_past_64_raise(D):
    with pytest.raises(ValueError, match="ROADMAP Queue B"):
        _build._check("fused_attention_fwd", _rows(D), 1024)


def test_ragged_rows_pass_where_aligned_ones_must_be_aligned():
    """A D 61 view of the (..., 3, H, 61) projection starts 2-byte aligned and
    is taken (the ragged path copies each row's covering 16-byte-aligned
    chunks and shifts the row into place); a D 32 row one
    element past a 16-byte boundary raises, and so dout is copied there."""
    H = 4
    for D, ok in ((61, True), (12, True), (32, False), (16, False)):
        flat = torch.zeros(3 * 5 * 7 * H * D + 1, dtype=torch.bfloat16)
        q, k, v = flat[1:].view(5, 7, 3, H, D).unbind(2)
        assert q.stride(-1) == 1 and _build.aligned16(q) is False
        if ok:
            _build._check("temporal_attention_fwd", (q, k, v), 16)
            assert _build.rows16(q, torch.bfloat16) is q
        else:
            with pytest.raises(ValueError, match="16-byte aligned"):
                _build._check("temporal_attention_fwd", (q, k, v), 16)
            copy = _build.rows16(q, torch.bfloat16)
            assert copy is not q and _build.aligned16(copy)
    # the resident layout's (B, T, S, H, D) views of (B, T, S, 3, H, D)
    qkv = torch.zeros(2, 5, 7, 3, H, 61, dtype=torch.bfloat16)
    _build._check("temporal_resident_fwd", qkv.unbind(3), 16, ndim=5)


@pytest.fixture(scope="module")
def d61_pair():
    """The tiny card at 2 heads of D 61 (d_model 122), in both packages."""
    return build_pair(d_model=122, num_heads=2)


def test_d61_card_logits_match_jax(d61_pair):
    jm, params, tm, tokens, actions = d61_pair
    assert tm.decoder.layers[0].spatial_attn.head_dim == 61
    # jitted: eager flax runs the model op by op, several times slower here
    want, _ = jax.jit(functools.partial(jm.apply, method=JaxSTMaskGIT.compute_logits))(
        params, tokens, actions, jnp.asarray(0, jnp.int32))
    with torch.no_grad():
        got, _ = tm.compute_logits(to_torch(tokens), to_torch(actions), 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def _assert_tree_close(got: dict, want: dict, rel: float, what: str):
    assert set(got) == set(want), what
    for n, w in want.items():
        err = (got[n].detach() - w).abs().max().item()
        scale = w.abs().max().item()
        assert err <= rel * scale + 1e-8, f"{what} {n}: max|d| {err:.3e}, max|want| {scale:.3e}"


def test_d61_card_training_step_matches_jax(d61_pair):
    jm, params, tm, tokens, actions = d61_pair
    rng = np.random.default_rng(7)
    V = jm.config.image_vocab_size
    mask = rng.random(tokens.shape) < 0.5
    mask[:, 0] = False
    labels = np.minimum(tokens, V - 1).astype(np.int32)
    inp = np.where(mask, V, labels).astype(np.int32)
    batch = {"input_ids": inp, "labels": labels, "action_ids": actions,
             "domain_id": np.int32(0)}
    sched = jax_step.custom_cosine_schedule(LR, 1, 10)
    tx = jax_step.make_optimizer(sched, WD, eps=EPS, params_template=params)
    step = jax.jit(jax_step.make_train_step(jm, tx))
    state = jax_step.TrainState(params, jax.jit(tx.init)(params), jnp.asarray(0))
    state, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                          jax.random.PRNGKey(0))

    cfg = tm.config
    ptx = port_step.make_optimizer(tm, port_step.custom_cosine_schedule(LR, 1, 10), WD,
                                   eps=EPS)
    got = port_step.make_train_step(tm, ptx)(
        {"input_ids": to_torch(inp), "labels": to_torch(labels),
         "action_ids": to_torch(actions), "domain_id": 0})
    assert got["skipped"].item() == 0.0
    np.testing.assert_allclose(got["loss"].item(), float(metrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"].item(), float(metrics["grad_norm"]),
                               rtol=1e-5)
    adam = state.opt_state[1][0]  # chain(clip, adamw(scale_by_adam, ...))
    _assert_tree_close(ptx.m, params_from_jax(adam.mu, cfg), 2e-5, "m")
    _assert_tree_close(dict(tm.named_parameters()), params_from_jax(state.params, cfg),
                       1e-5, "params")
