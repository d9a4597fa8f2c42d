"""The CUDA kernels K1' and K3' against their plain PyTorch versions, at the
main path's shapes and one ragged shape each, fp32 and bf16. Marked gpu:
they need a card and skip elsewhere. This file imports no JAX, so on a
machine without it run it alone, without the JAX-side conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py
"""

import pytest
import torch

from hma_tpu_torch.ops.fused_attention import fused_attention, fused_attention_plain
from hma_tpu_torch.ops.temporal_attention import (
    fused_temporal_attention,
    fused_temporal_attention_plain,
)


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
