"""Port attention ops on the CPU: the plain versions of K1' and K3' against
the Pallas kernels in interpret mode and against `_attend` (fp32), and the
decode step against hma_tpu's. The CUDA kernels themselves are held to
these plain versions in tests/test_torch_kernels_gpu.py."""

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


def test_temporal_plain_matches_pallas_and_attend():
    q, k, v = _make((256, 6, 2, 32), seed=1)
    out, lse = fused_temporal_attention_plain(*_t(q, k, v))
    want = jax_ta.fused_temporal_attention(q, k, v, True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
    want_attend = jax_attention._attend(q, k, v, causal=True, dtype=jnp.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_attend), **TOL)
    kl = lambda x: jnp.asarray(x).transpose(2, 1, 3, 0)  # (H, T, D, N)
    _, want_lse = jax_ta._fwd(kl(q), kl(k), kl(v), True)  # (H, T, N)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse).transpose(2, 0, 1),
                               **TOL)
    out2, _ = fused_temporal_attention(*_t(q, k, v))
    assert torch.equal(out2, out)


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
