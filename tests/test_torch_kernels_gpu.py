"""The CUDA kernels against their plain PyTorch versions, at the main path's
shapes and one ragged shape each, fp32 and bf16: K1' and K3' (forward: out
and lse), K2' and K4' (backward: dq, dk, dv from the same out, lse and a
strided dout), and the autograd.Functions' launches. Marked gpu: they need
a card and skip elsewhere. This file imports no JAX, so on a machine
without it run it alone, without the JAX-side conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py
"""

import pytest
import torch

from hma_tpu_torch.ops.fused_attention import (
    FusedAttention,
    fused_attention,
    fused_attention_bwd,
    fused_attention_bwd_plain,
    fused_attention_plain,
)
from hma_tpu_torch.ops.temporal_attention import (
    FusedTemporalAttention,
    fused_temporal_attention,
    fused_temporal_attention_bwd,
    fused_temporal_attention_bwd_plain,
    fused_temporal_attention_plain,
)

# Backward limits on dq, dk, dv against the plain version, as chip_smoke.py
# sets them from H100 readings: fp32 atol = rtol = 1e-4; bf16 atol = rtol =
# 1e-2 and at most 1 % of the outputs differing at all.
BWD_FP32_TOL = 1e-4
BWD_BF16_TOL = {"K2'": 1e-2, "K4'": 1e-2}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")


def _strided_qkv(lead, H, D, dtype, seed):
    """q, k, v as the unit-stride-D views that SelfAttention._qkv makes."""
    g = torch.Generator("cuda").manual_seed(seed)
    qkv = torch.randn(*lead, 3, H, D, generator=g, device="cuda").to(dtype)
    q, k, v = qkv.unbind(-3)
    return q * 0.2, k, v


def _assert_matches(out, lse, want, want_lse, tol):
    """out to `tol`, the fp32 lse to 1e-5; in bf16 at most 1 % of the
    outputs may differ from the plain version (an output that skipped the
    bf16 rounding of the probs would move ~30-40 % of them)."""
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-5)
    if out.dtype == torch.bfloat16:
        assert (out != want).float().mean().item() <= 0.01


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 4e-3)])
@pytest.mark.parametrize("shape,causal", [((8, 320, 8, 32), False),
                                          ((3, 77, 4, 64), True)])
def test_spatial_kernel_matches_plain(dtype, tol, shape, causal):
    _need_card()
    B, S, H, D = shape
    q, k, v = _strided_qkv((B, S), H, D, dtype, seed=0)
    out, lse = fused_attention(q, k, v, causal)
    _assert_matches(out, lse, *fused_attention_plain(q, k, v, causal), tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("shape", [(2560, 12, 8, 32), (1000, 5, 3, 64)])
def test_temporal_kernel_matches_plain(dtype, tol, shape):
    _need_card()
    N, T, H, D = shape
    q, k, v = _strided_qkv((N, T), H, D, dtype, seed=1)
    out, lse = fused_temporal_attention(q, k, v)
    _assert_matches(out, lse, *fused_temporal_attention_plain(q, k, v), tol)


def _strided_dout(lead, H, D, dtype, seed):
    """dout as a view with a unit D stride and larger strides elsewhere."""
    g = torch.Generator("cuda").manual_seed(seed)
    return torch.randn(*lead, 2, H, D, generator=g, device="cuda").to(dtype)[..., 0, :, :]


def _assert_grads_match(got, want, tol):
    torch.cuda.synchronize()
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == w.dtype and g.is_contiguous()
        torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=tol,
                                   msg=lambda m: f"{name}: {m}")
        if g.dtype == torch.bfloat16:
            share = (g != w).float().mean().item()
            assert share <= 0.01, f"{name}: {share:.4%} of outputs differ"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,causal", [((96, 320, 8, 32), False),
                                          ((3, 77, 4, 64), True)])
def test_spatial_bwd_kernel_matches_plain(dtype, shape, causal):
    _need_card()
    B, S, H, D = shape
    q, k, v = _strided_qkv((B, S), H, D, dtype, seed=2)
    out, lse = fused_attention(q, k, v, causal)
    dout = _strided_dout((B, S), H, D, dtype, seed=3)
    tol = BWD_FP32_TOL if dtype == torch.float32 else BWD_BF16_TOL["K2'"]
    _assert_grads_match(fused_attention_bwd(q, k, v, out, lse, dout, causal),
                        fused_attention_bwd_plain(q, k, v, out, lse, dout, causal),
                        tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2560, 12, 8, 32), (1000, 5, 3, 64)])
def test_temporal_bwd_kernel_matches_plain(dtype, shape):
    _need_card()
    N, T, H, D = shape
    q, k, v = _strided_qkv((N, T), H, D, dtype, seed=4)
    out, lse = fused_temporal_attention(q, k, v)
    dout = _strided_dout((N, T), H, D, dtype, seed=5)
    tol = BWD_FP32_TOL if dtype == torch.float32 else BWD_BF16_TOL["K4'"]
    _assert_grads_match(fused_temporal_attention_bwd(q, k, v, out, lse, dout),
                        fused_temporal_attention_bwd_plain(q, k, v, out, lse, dout),
                        tol)


@pytest.mark.gpu
@pytest.mark.parametrize("temporal", [False, True])
def test_autograd_function_launches_fwd_and_bwd_kernels(temporal):
    """One forward and backward through the autograd.Function launches the
    forward kernel once and the backward kernel once, and the grads reach
    the fused qkv tensor."""
    _need_card()
    fwd, bwd = ((fused_temporal_attention, fused_temporal_attention_bwd) if temporal
                else (fused_attention, fused_attention_bwd))
    lead = (64, 12) if temporal else (4, 320)
    qkv = torch.randn(*lead, 3, 8, 32, device="cuda").requires_grad_(True)
    q, k, v = qkv.unbind(-3)
    fwd.launches = bwd.launches = 0
    out = FusedTemporalAttention.apply(q, k, v) if temporal else \
        FusedAttention.apply(q, k, v, False)
    out.square().sum().backward()
    torch.cuda.synchronize()
    assert (fwd.launches, bwd.launches) == (1, 1)
    assert qkv.grad is not None and torch.isfinite(qkv.grad).all()
