"""Port attention backward on the CPU: the plain versions of K2' and K4'
against the Pallas backward kernels in interpret mode (`_bwd`) and against
`jax.vjp` of `hma_tpu.models.attention._attend`; the K3' repair (fp32 probs)
against Pallas K3 in bf16; and the autograd.Functions against the plain
backwards. The CUDA kernels themselves are held to these plain versions in
tests/test_torch_kernels_gpu.py and chip_smoke.py.

Tolerances: fp32 allclose 2e-5 (summation order only). bf16: at most 1 % of
the outputs may differ from the Pallas kernel at all; a version with the
other kernel's rounding of p and ds moves far more of them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hma_tpu.models import attention as jax_attention
from hma_tpu.ops import fused_attention as jax_fa
from hma_tpu.ops import temporal_attention as jax_ta
from hma_tpu_torch.ops.fused_attention import (
    FusedAttention,
    attention_bwd_plain,
    fused_attention_bwd_plain,
    fused_attention_plain,
)
from hma_tpu_torch.ops.temporal_attention import (
    FusedTemporalAttention,
    fused_temporal_attention_bwd_plain,
    fused_temporal_attention_plain,
)

TOL = dict(atol=2e-5, rtol=2e-5)
MISMATCH_LIMIT = 0.01


def _inputs(shape, seed):
    """q (pre-scaled), k, v, dout as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=shape) * 0.3).astype(np.float32)
    k, v, dout = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    return q, k, v, dout


def _np(x):
    """A jax array (fp32 or bf16) as float32 numpy."""
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x, np.float32)).to(dtype)


def _share_differing(got, want_np):
    return (got.float().numpy() != want_np).mean()


def _spatial_pallas(q, k, v, dout, causal, dtype):
    """Pallas K1 forward and K2 backward in interpret mode, public layout:
    (out, lse (B,H,S), (dq, dk, dv)) as float32 numpy."""
    tr = lambda x: jnp.asarray(x, dtype).transpose(0, 2, 1, 3)
    qt, kt, vt = tr(q), tr(k), tr(v)
    out, lse = jax_fa._fwd(qt, kt, vt, causal, True)
    grads = jax_fa._bwd(qt, kt, vt, out, lse, tr(dout), causal, True)
    back = lambda x: _np(x.transpose(0, 2, 1, 3))
    return back(out), _np(lse), [back(g) for g in grads]


def _temporal_pallas(q, k, v, dout, dtype):
    """Pallas K3 forward and K4 backward in interpret mode, public layout:
    (out, lse (N,H,T), (dq, dk, dv)) as float32 numpy."""
    kl = lambda x: jnp.asarray(x, dtype).transpose(2, 1, 3, 0)  # (H, T, D, N)
    back = lambda x: _np(x.transpose(3, 1, 0, 2))
    qt, kt, vt = kl(q), kl(k), kl(v)
    out, lse = jax_ta._fwd(qt, kt, vt, True)
    grads = jax_ta._bwd(qt, kt, vt, out, lse, kl(dout), True)
    return back(out), _np(lse).transpose(2, 0, 1), [back(g) for g in grads]


@pytest.mark.parametrize("causal", [False, True])
def test_spatial_bwd_plain_matches_pallas_fp32(causal):
    q, k, v, dout = _inputs((2, 40, 2, 32), seed=0)
    out, lse, want = _spatial_pallas(q, k, v, dout, causal, jnp.float32)
    got = fused_attention_bwd_plain(*map(_t, (q, k, v, out, lse, dout)), causal)
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g.numpy(), w, **TOL, err_msg=f"d{name}")


def test_temporal_bwd_plain_matches_pallas_fp32():
    q, k, v, dout = _inputs((256, 6, 2, 32), seed=1)
    out, lse, want = _temporal_pallas(q, k, v, dout, jnp.float32)
    got = fused_temporal_attention_bwd_plain(*map(_t, (q, k, v, out, lse, dout)))
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g.numpy(), w, **TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("kernel", ["K2", "K4"])
def test_bwd_plain_matches_pallas_bf16(kernel):
    """Same out/lse/dout into both backwards, bf16: the plain version with
    the kernel's own rounding differs on <= 1 % of outputs, the one with
    the other kernel's rounding (the negative control) on more."""
    bf = torch.bfloat16
    if kernel == "K2":
        q, k, v, dout = _inputs((2, 64, 2, 32), seed=2)
        out, lse, want = _spatial_pallas(q, k, v, dout, True, jnp.bfloat16)
        args = [_t(x, bf) for x in (q, k, v, out)] + [_t(lse), _t(dout, bf)]
        got = fused_attention_bwd_plain(*args, True)
        control = attention_bwd_plain(*args, True, False)
    else:
        q, k, v, dout = _inputs((256, 12, 2, 32), seed=3)
        out, lse, want = _temporal_pallas(q, k, v, dout, jnp.bfloat16)
        args = [_t(x, bf) for x in (q, k, v, out)] + [_t(lse), _t(dout, bf)]
        got = fused_temporal_attention_bwd_plain(*args)
        control = attention_bwd_plain(*args, True, True)
    for g, c, w, name in zip(got, control, want, "qkv"):
        assert g.dtype == bf
        share = _share_differing(g, w)
        assert share <= MISMATCH_LIMIT, f"d{name}: {share:.4%} differ"
        np.testing.assert_allclose(g.float().numpy(), w, atol=2e-2, rtol=2e-2)
    # dq and dk depend on ds, whose rounding is what the kernels differ in
    assert max(_share_differing(c, w) for c, w in zip(control[:2], want[:2])) \
        > MISMATCH_LIMIT


@pytest.mark.parametrize("causal", [False, True])
def test_bwd_plain_matches_jax_grad_of_attend(causal):
    """fp32: the plain backward from the plain forward's out and lse equals
    jax.vjp of the XLA attention `_attend`."""
    shape = (256, 5, 2, 32) if causal else (2, 24, 2, 32)
    q, k, v, dout = _inputs(shape, seed=4)
    _, vjp = jax.vjp(lambda a, b, c: jax_attention._attend(
        a, b, c, causal=causal, dtype=jnp.float32), q, k, v)
    want = vjp(jnp.asarray(dout))
    tq, tk, tv, tdo = map(_t, (q, k, v, dout))
    if causal:
        out, lse = fused_temporal_attention_plain(tq, tk, tv)
        got = fused_temporal_attention_bwd_plain(tq, tk, tv, out, lse, tdo)
    else:
        out, lse = fused_attention_plain(tq, tk, tv, False)
        got = fused_attention_bwd_plain(tq, tk, tv, out, lse, tdo, False)
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g.numpy(), _np(w), **TOL, err_msg=f"d{name}")


def test_temporal_fwd_plain_keeps_fp32_probs_like_pallas_bf16():
    """The K3' repair: in bf16 the plain temporal forward (fp32 probs, p v
    from the upcast v) equals Pallas K3 on >= 99 % of outputs; rounding the
    probs to bf16 first, as K1 does, moves a third of them."""
    q, k, v, _ = _inputs((256, 12, 2, 32), seed=5)
    want, want_lse, _ = _temporal_pallas(q, k, v, np.zeros_like(q), jnp.bfloat16)
    tq, tk, tv = (_t(x, torch.bfloat16) for x in (q, k, v))
    out, lse = fused_temporal_attention_plain(tq, tk, tv)
    assert out.dtype == torch.bfloat16
    assert _share_differing(out, want) <= MISMATCH_LIMIT
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=1e-5, rtol=1e-5)
    rounded, _ = fused_attention_plain(tq, tk, tv, True)
    assert _share_differing(rounded, want) > 10 * MISMATCH_LIMIT


@pytest.mark.parametrize("temporal", [False, True])
def test_autograd_function_grads_reach_qkv_views(temporal):
    """Through the autograd.Function, gradients of a loss reach a fused qkv
    tensor via its unit-stride views and equal the plain backward's."""
    rng = np.random.default_rng(6)
    lead, L, H, D = (64, 6, 2, 16) if temporal else (3, 20, 2, 16)
    qkv = torch.from_numpy(rng.normal(size=(lead, L, 3, H, D)).astype(np.float32))
    qkv.requires_grad_(True)
    dout = torch.from_numpy(rng.normal(size=(lead, L, H, D)).astype(np.float32))
    q, k, v = qkv.unbind(2)
    out = (FusedTemporalAttention.apply(q, k, v) if temporal
           else FusedAttention.apply(q, k, v, False))
    (out * dout).sum().backward()
    with torch.no_grad():
        q, k, v = qkv.unbind(2)
        if temporal:
            o, lse = fused_temporal_attention_plain(q, k, v)
            want = fused_temporal_attention_bwd_plain(q, k, v, o, lse, dout)
        else:
            o, lse = fused_attention_plain(q, k, v, False)
            want = fused_attention_bwd_plain(q, k, v, o, lse, dout, False)
    torch.testing.assert_close(out.detach(), o, atol=0, rtol=0)
    torch.testing.assert_close(qkv.grad, torch.stack(want, 2), atol=0, rtol=0)
