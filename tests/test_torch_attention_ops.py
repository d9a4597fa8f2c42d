"""Port attention ops on the CPU: the plain versions of K1' and K3' against
the Pallas kernels in interpret mode and against `_attend` (fp32), K1''s in
bf16 against Pallas K1's rounding of the probs, and the decode step against
hma_tpu's. Also at the head dims of the d128 cards (16) and the magvit d512
card (61): K3' at D 16 against Pallas K3, K1' at D 16 and both at D 61
against `_attend` (hma_tpu runs those on XLA). The CUDA kernels themselves
are held to these plain versions in tests/test_torch_kernels_gpu.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hma_tpu.models import attention as jax_attention
from hma_tpu.ops import fused_attention as jax_fa
from hma_tpu.ops import temporal_attention as jax_ta
from hma_tpu_torch.models.attention import SelfAttention, _attend
from hma_tpu_torch.ops.fused_attention import fused_attention, fused_attention_plain
from hma_tpu_torch.ops.temporal_attention import (
    fused_temporal_attention,
    fused_temporal_attention_plain,
)

TOL = dict(atol=2e-5, rtol=2e-5)


def _make(shape, seed=0):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=shape) * 0.2).astype(np.float32)
    k = rng.normal(size=shape).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    return q, k, v


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("causal", [False, True])
def test_spatial_plain_matches_pallas_and_attend(causal):
    q, k, v = _make((3, 40, 4, 32))
    out, lse = fused_attention_plain(*_t(q, k, v), causal)
    want = jax_fa.fused_attention(q, k, v, causal, True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
    want_attend = jax_attention._attend(q, k, v, causal=causal, dtype=jnp.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_attend), **TOL)
    got_attend = _attend(*_t(q, k, v), causal=causal, dtype=torch.float32)
    np.testing.assert_allclose(out.numpy(), got_attend.numpy(), **TOL)
    tr = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3)
    _, want_lse = jax_fa._fwd(tr(q), tr(k), tr(v), causal, True)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **TOL)
    # the wrapper takes the plain version for CPU tensors
    out2, lse2 = fused_attention(*_t(q, k, v), causal)
    assert torch.equal(out2, out) and torch.equal(lse2, lse)


@pytest.mark.parametrize("causal", [False, True])
def test_spatial_fwd_plain_rounds_probs_like_pallas_bf16(causal):
    """K1''s arbiter in bf16: the plain spatial forward (probs normalised in
    fp32 and rounded to bf16 before p v) equals Pallas K1 in interpret mode
    on >= 99 % of outputs, and its lse to 1e-5; keeping the probs fp32, as
    a kernel that skipped the rounding would, moves far more of them."""
    q, k, v = _make((2, 64, 2, 32), seed=3)
    tr = lambda x: jnp.asarray(x, jnp.bfloat16).transpose(0, 2, 1, 3)
    want, want_lse = jax_fa._fwd(tr(q), tr(k), tr(v), causal, True)
    want = np.asarray(want.astype(jnp.float32)).transpose(0, 2, 1, 3)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    out, lse = fused_attention_plain(tq, tk, tv, causal)
    assert out.dtype == torch.bfloat16
    assert (out.float().numpy() != want).mean() <= 0.01
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=1e-5, rtol=1e-5)
    unrounded, _ = fused_attention_plain(tq, tk, tv, causal, dtype=torch.float32)
    assert (unrounded.float().numpy() != want).mean() > 0.1


@pytest.mark.parametrize("shape,pallas", [((256, 6, 2, 32), True), ((64, 1, 2, 64), False),
                                          ((64, 16, 2, 64), False), ((256, 6, 2, 16), True),
                                          ((64, 12, 2, 61), False)],
                         ids=["T6-pallas", "T1-D64", "T16-D64", "T6-D16-pallas", "T12-D61"])
def test_temporal_plain_matches_pallas_and_attend(shape, pallas):
    """K3''s plain version against `_attend` (XLA) and its lse against the
    log-sum-exp of the causal logits; at T 6 also against Pallas K3 in
    interpret mode. T 1 and 16 (MAX_T) are the kernels' edges; interpret
    mode's unrolled T x T loops would take tens of seconds there."""
    q, k, v = _make(shape, seed=1)
    out, lse = fused_temporal_attention_plain(*_t(q, k, v))
    want_attend = jax_attention._attend(q, k, v, causal=True, dtype=jnp.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_attend), **TOL)
    logits = jnp.einsum("nthd,nshd->nhts", q, k)
    T = shape[1]
    logits = jnp.where(jnp.tril(jnp.ones((T, T), bool)), logits, -jnp.inf)
    want_lse = jax.nn.logsumexp(logits, axis=-1)  # (N, H, T)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **TOL)
    if pallas:
        want = jax_ta.fused_temporal_attention(q, k, v, True)
        np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
        kl = lambda x: jnp.asarray(x).transpose(2, 1, 3, 0)  # (H, T, D, N)
        _, pallas_lse = jax_ta._fwd(kl(q), kl(k), kl(v), True)  # (H, T, N)
        np.testing.assert_allclose(lse.numpy(), np.asarray(pallas_lse).transpose(2, 0, 1),
                                   **TOL)
    out2, _ = fused_temporal_attention(*_t(q, k, v))
    assert torch.equal(out2, out)


@pytest.mark.parametrize("D", [16, 61])
@pytest.mark.parametrize("causal", [False, True])
def test_spatial_plain_matches_attend_at_other_head_dims(causal, D):
    """K1''s plain version at the d128 cards' D 16 and the magvit d512
    card's D 61, where hma_tpu's spatial pass is the XLA `_attend` (Pallas K1
    takes D 32, 64 and 128): out against `_attend`, lse against the
    log-sum-exp of the logits."""
    q, k, v = _make((3, 40, 4, D), seed=4)
    out, lse = fused_attention_plain(*_t(q, k, v), causal)
    want = jax_attention._attend(q, k, v, causal=causal, dtype=jnp.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
    logits = jnp.einsum("bnhd,bmhd->bhnm", q, k)
    if causal:
        logits = jnp.where(jnp.tril(jnp.ones((40, 40), bool)), logits, -jnp.inf)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jax.nn.logsumexp(logits, -1)), **TOL)


def test_attend_kv_mask_and_end_aligned_causal_match_jax():
    rng = np.random.default_rng(2)
    q = (rng.normal(size=(2, 3, 2, 16)) * 0.3).astype(np.float32)
    k = rng.normal(size=(2, 7, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 7, 2, 16)).astype(np.float32)
    mask = rng.random((2, 7)) > 0.3
    mask[:, -1] = True
    for causal in (False, True):
        want = jax_attention._attend(q, k, v, causal=causal, kv_mask=mask,
                                     dtype=jnp.float32)
        got = _attend(*_t(q, k, v), causal=causal, kv_mask=torch.from_numpy(mask),
                      dtype=torch.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("t", [0, 3, 5])
def test_decode_step_matches_jax(t):
    N, T, H, D = 12, 6, 2, 16
    jmod = jax_attention.SelfAttention(num_heads=H, d_model=H * D, qk_norm=False,
                                       use_mup=False, dtype=jnp.float32)
    rng = np.random.default_rng(t)
    x = rng.normal(size=(N, 1, H * D)).astype(np.float32)
    kc = rng.normal(size=(N, T, H, D)).astype(np.float32)
    vc = rng.normal(size=(N, T, H, D)).astype(np.float32)
    params = jmod.init(jax.random.PRNGKey(0), x)
    want, wk, wv = jmod.apply(params, x, kc, vc, jnp.asarray(t, jnp.int32),
                              method=jax_attention.SelfAttention.decode_step)
    tmod = SelfAttention(H, H * D, qk_norm=False, use_mup=False,
                         dtype=torch.float32, device="cpu")
    p = params["params"]
    with torch.no_grad():
        tmod.qkv.weight.copy_(torch.from_numpy(np.array(p["qkv"]["kernel"]).T))
        tmod.proj.weight.copy_(torch.from_numpy(np.array(p["proj"]["kernel"]).T))
        tmod.proj.bias.copy_(torch.from_numpy(np.array(p["proj"]["bias"])))
        got, gk, gv = tmod.decode_step(*_t(x, kc, vc), t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=1e-5, rtol=1e-5)
