"""The CUDA kernels against their plain PyTorch versions, at the main path's
shapes and one ragged shape each, fp32 and bf16: K1' and K3' (forward: out
and lse), K2' and K4' (backward: dq, dk, dv from the same out, lse and a
strided dout), K1'/K2' also at edge shapes (S 1, 17, 1024) with their
negative controls, K3'/K4' at T 1 and 16, a ragged last site tile and 3
heads, K1'-K5' on misaligned rows, the autograd.Functions' launches, K5'
(the resident layout's forward and backward, against the plain version and
bit for bit against K3'/K4' on the same values regrouped, also at T 1 and
16), K6' (the fused denoise loop), and the MLP dropout under remat on the
card. K1'-K5' also at the head dims of the other shipped cards: D 16 (the
aligned path) and D 61 (the ragged path, zero-padded to 64 inside the
kernel), and on the ragged path at each padded width: D 12 (to 16), 20, 24
and 27 (to 32); the ragged path takes rows at any alignment. K1'-K5' at
the head count a tp 2 rank gives them (H 4 of the cards' 8). Marked gpu:
they need a card and skip elsewhere. This file imports no JAX, so on a
machine without it run it alone, without the JAX-side conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py
"""

import math

import pytest
import torch

from hma_tpu_torch.diffusion.gaussian import make_schedule
from hma_tpu_torch.ops.diffusion_sampler import (
    fused_denoise_loop,
    fused_denoise_loop_plain,
    schedule_table,
)
from hma_tpu_torch.ops.fused_attention import (
    FusedAttention,
    attention_bwd_plain,
    fused_attention,
    fused_attention_bwd,
    fused_attention_bwd_plain,
    fused_attention_plain,
)
from hma_tpu_torch.ops.temporal_attention import (
    FusedTemporalAttention,
    FusedTemporalResident,
    fused_temporal_attention,
    fused_temporal_attention_bwd,
    fused_temporal_attention_bwd_plain,
    fused_temporal_attention_plain,
    fused_temporal_attention_resident,
    fused_temporal_attention_resident_bwd,
    temporal_resident_bwd_plain,
    temporal_resident_plain,
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
                                          ((24, 320, 8, 32), False),
                                          ((3, 77, 4, 64), True),
                                          ((8, 320, 8, 16), False), ((8, 320, 8, 61), False),
                                          ((3, 77, 4, 12), True), ((3, 77, 4, 61), True),
                                          ((2, 17, 3, 24), False), ((40, 128, 4, 24), True),
                                          ((3, 77, 4, 20), True), ((40, 128, 4, 27), False)])
def test_spatial_kernel_matches_plain(dtype, tol, shape, causal):
    _need_card()
    B, S, H, D = shape
    q, k, v = _strided_qkv((B, S), H, D, dtype, seed=0)
    out, lse = fused_attention(q, k, v, causal)
    _assert_matches(out, lse, *fused_attention_plain(q, k, v, causal), tol)


# K3'/K4' shapes (N, T, H, D): the d256 card's, a ragged one, then the
# edges: one frame, MAX_T frames, a last site tile left ragged, 3 heads;
# then the magvit d128 and d512 cards' (D 16 and 61) and the ragged path
# padded to 16 (D 12) and to 32 (D 24, 20 and 27).
TEMPORAL_SHAPES = [(2560, 12, 8, 32), (1000, 5, 3, 64), (77, 1, 8, 32), (77, 16, 8, 64),
                   (45, 16, 3, 32), (45, 1, 3, 64), (2560, 12, 8, 16), (2560, 12, 8, 61),
                   (45, 16, 3, 61), (45, 5, 3, 12), (45, 12, 3, 24), (77, 16, 8, 20),
                   (45, 5, 3, 27)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("shape", TEMPORAL_SHAPES)
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
                                          ((3, 77, 4, 64), True),
                                          ((96, 320, 8, 16), False), ((96, 320, 8, 61), False),
                                          ((3, 77, 4, 12), True), ((3, 77, 4, 61), True),
                                          ((2, 17, 3, 24), False), ((40, 128, 4, 24), True),
                                          ((3, 77, 4, 20), True), ((40, 128, 4, 27), False)])
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


# K1'/K2' edge shapes: one key, a partial 16-row and 8-key fragment, 16 key
# tiles; causal and not, D 32 and 64 (as chip_smoke.py's SPATIAL_EDGES)
SPATIAL_EDGES = [((2, 1, 2, 32), False), ((2, 1, 2, 64), True),
                 ((2, 17, 3, 64), True), ((2, 17, 3, 32), False),
                 ((1, 1024, 2, 32), True), ((1, 1024, 2, 64), False)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 4e-3)])
@pytest.mark.parametrize("shape,causal", SPATIAL_EDGES)
def test_spatial_kernel_edge_shapes(dtype, tol, shape, causal):
    """K1' at the edge shapes; in bf16 the plain version without the bf16
    rounding of the probs (the negative control) must differ from the plain
    version on more than 1 % of outputs, but for one key, where p is 1."""
    _need_card()
    B, S, H, D = shape
    q, k, v = _strided_qkv((B, S), H, D, dtype, seed=8)
    out, lse = fused_attention(q, k, v, causal)
    want, want_lse = fused_attention_plain(q, k, v, causal)
    _assert_matches(out, lse, want, want_lse, tol)
    if dtype == torch.bfloat16 and S > 1:
        control = fused_attention_plain(q, k, v, causal, dtype=torch.float32)[0]
        assert (control != want).float().mean().item() > 0.01


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,causal", SPATIAL_EDGES)
def test_spatial_bwd_kernel_edge_shapes(dtype, shape, causal):
    """K2' at the edge shapes; in bf16 the plain backward that keeps p and ds
    fp32 (the negative control) must differ on more than 1 % of dq, dk and
    dv, but for one key (p is 1, ds 0)."""
    _need_card()
    B, S, H, D = shape
    q, k, v = _strided_qkv((B, S), H, D, dtype, seed=9)
    out, lse = fused_attention(q, k, v, causal)
    dout = _strided_dout((B, S), H, D, dtype, seed=10)
    tol = BWD_FP32_TOL if dtype == torch.float32 else BWD_BF16_TOL["K2'"]
    want = fused_attention_bwd_plain(q, k, v, out, lse, dout, causal)
    _assert_grads_match(fused_attention_bwd(q, k, v, out, lse, dout, causal), want, tol)
    if dtype == torch.bfloat16 and S > 1:
        control = attention_bwd_plain(q, k, v, out, lse, dout, causal, False)
        for c, w in zip(control, want):
            assert (c != w).float().mean().item() > 0.01


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, (1e-5, BWD_FP32_TOL)),
                                       (torch.bfloat16, (4e-3, BWD_BF16_TOL["K2'"]))])
def test_spatial_kernels_on_misaligned_rows(dtype, tol):
    """Rows that do not start 16-byte aligned (views one element into a
    buffer): K1' raises ValueError, and on copies equals the plain version on
    the views; K2' copies a misaligned dout itself and equals the plain
    backward."""
    _need_card()
    lead, H, D = (3, 77), 4, 64
    n = 3 * 77 * H * D
    g = torch.Generator("cuda").manual_seed(11)
    flat = (torch.randn(3 * n + 1, generator=g, device="cuda") * 0.4).to(dtype)
    q, k, v = flat[1:].view(*lead, 3, H, D).unbind(-3)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fused_attention(q, k, v)
    copies = [x.clone(memory_format=torch.contiguous_format) for x in (q, k, v)]
    out, lse = fused_attention(*copies)
    _assert_matches(out, lse, *fused_attention_plain(q, k, v), tol[0])
    dout = torch.randn(n + 1, generator=g, device="cuda").to(dtype)[1:].view(*lead, H, D)
    _assert_grads_match(fused_attention_bwd(*copies, out, lse, dout),
                        fused_attention_bwd_plain(q, k, v, out, lse, dout), tol[1])


def _misaligned(lead, H, D, dtype, seed):
    """q, k, v as views one element into one buffer of (*lead, 3, H, D), and
    a dout one element into another."""
    n = math.prod(lead) * H * D
    g = torch.Generator("cuda").manual_seed(seed)
    flat = (torch.randn(3 * n + 1, generator=g, device="cuda") * 0.4).to(dtype)
    q, k, v = flat[1:].view(*lead, 3, H, D).unbind(-3)
    dout = torch.randn(n + 1, generator=g, device="cuda").to(dtype)[1:].view(*lead, H, D)
    return q, k, v, dout


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, (1e-5, BWD_FP32_TOL)),
                                       (torch.bfloat16, (4e-3, BWD_BF16_TOL["K2'"]))])
def test_spatial_kernels_take_ragged_rows_at_any_alignment(dtype, tol):
    """At D 61 (the magvit d512 card's head dim) the rows of the
    (..., 3, H, 61) projection start 2-byte aligned: K1' and K2' take such
    views as they are (the ragged path copies each row's covering
    16-byte-aligned chunks and shifts the row into place) and equal the
    plain versions."""
    _need_card()
    q, k, v, dout = _misaligned((3, 77), 4, 61, dtype, seed=13)
    out, lse = fused_attention(q, k, v)
    _assert_matches(out, lse, *fused_attention_plain(q, k, v), tol[0])
    _assert_grads_match(fused_attention_bwd(q, k, v, out, lse, dout),
                        fused_attention_bwd_plain(q, k, v, out, lse, dout), tol[1])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", TEMPORAL_SHAPES)
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
@pytest.mark.parametrize("resident", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, (1e-5, BWD_FP32_TOL)),
                                       (torch.bfloat16, (1e-2, BWD_BF16_TOL["K4'"]))])
def test_temporal_kernels_on_misaligned_rows(dtype, tol, resident):
    """Rows that do not start 16-byte aligned (views one element into a
    buffer): K3' and K5' raise ValueError, and on copies equal the plain
    version on the views; K4' and K5''s backward copy a misaligned dout
    themselves and equal the plain backward."""
    _need_card()
    lead, H, D = ((2, 5, 7) if resident else (35, 5)), 3, 64
    n = math.prod(lead) * H * D
    g = torch.Generator("cuda").manual_seed(12)
    flat = (torch.randn(3 * n + 1, generator=g, device="cuda") * 0.4).to(dtype)
    q, k, v = flat[1:].view(*lead, 3, H, D).unbind(-3)
    fwd, bwd, plain, bwd_plain = (
        (fused_temporal_attention_resident, fused_temporal_attention_resident_bwd,
         temporal_resident_plain, temporal_resident_bwd_plain) if resident else
        (fused_temporal_attention, fused_temporal_attention_bwd,
         fused_temporal_attention_plain, fused_temporal_attention_bwd_plain))
    with pytest.raises(ValueError, match="16-byte aligned"):
        fwd(q, k, v)
    copies = [x.clone(memory_format=torch.contiguous_format) for x in (q, k, v)]
    out, lse = fwd(*copies)
    _assert_matches(out, lse, *plain(q, k, v), tol[0])
    dout = torch.randn(n + 1, generator=g, device="cuda").to(dtype)[1:].view(*lead, H, D)
    got, want = bwd(*copies, out, lse, dout), bwd_plain(q, k, v, out, lse, dout)
    if resident:
        got, want = ([x.contiguous() for x in y.unbind(3)] for y in (got, want))
    _assert_grads_match(got, want, tol[1])


@pytest.mark.gpu
@pytest.mark.parametrize("resident", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, (1e-5, BWD_FP32_TOL)),
                                       (torch.bfloat16, (1e-2, BWD_BF16_TOL["K4'"]))])
def test_temporal_kernels_take_ragged_rows_at_any_alignment(dtype, tol, resident):
    """At D 61, K3'/K4' and K5' take views that start 2-byte aligned as they
    are and equal the plain versions."""
    _need_card()
    q, k, v, dout = _misaligned((2, 5, 7) if resident else (35, 5), 3, 61, dtype, seed=14)
    fwd, bwd, plain, bwd_plain = (
        (fused_temporal_attention_resident, fused_temporal_attention_resident_bwd,
         temporal_resident_plain, temporal_resident_bwd_plain) if resident else
        (fused_temporal_attention, fused_temporal_attention_bwd,
         fused_temporal_attention_plain, fused_temporal_attention_bwd_plain))
    out, lse = fwd(q, k, v)
    _assert_matches(out, lse, *plain(q, k, v), tol[0])
    got, want = bwd(q, k, v, out, lse, dout), bwd_plain(q, k, v, out, lse, dout)
    if resident:
        got, want = ([x.contiguous() for x in y.unbind(3)] for y in (got, want))
    _assert_grads_match(got, want, tol[1])


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


def _resident_qkv(shape, dtype, seed):
    """q (scaled, contiguous), k, v (views) as FusedTemporalResident hands
    them to K5': from one (B, T, S, 3, H, D) projection."""
    B, T, S, H, D = shape
    g = torch.Generator("cuda").manual_seed(seed)
    qkv = torch.randn(B, T, S, 3, H, D, generator=g, device="cuda").to(dtype)
    return qkv[..., 0, :, :] * 0.2, qkv[..., 1, :, :], qkv[..., 2, :, :]


# K5' shapes (B, T, S, H, D): the d512 card's, a ragged one, one frame and
# MAX_T frames with an S that leaves the last site tile ragged; the mar
# d128 card's (D 16), the magvit d512 card's D 61 with a ragged S, and the
# ragged path at DP 16 and 32 (D 12, 24, 20, 27).
RESIDENT_SHAPES = [(8, 12, 128, 8, 64), (3, 5, 7, 3, 32), (2, 1, 11, 8, 64),
                   (2, 16, 13, 3, 32), (8, 12, 128, 8, 16), (2, 12, 13, 8, 61),
                   (3, 5, 7, 3, 12), (2, 12, 13, 3, 24), (2, 16, 11, 8, 20),
                   (3, 5, 7, 3, 27)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("shape", RESIDENT_SHAPES)
def test_resident_kernel_matches_plain(dtype, tol, shape):
    _need_card()
    q, k, v = _resident_qkv(shape, dtype, seed=6)
    out, lse = fused_temporal_attention_resident(q, k, v)
    assert out.is_contiguous() and out.shape == q.shape
    _assert_matches(out, lse, *temporal_resident_plain(q, k, v), tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", RESIDENT_SHAPES)
def test_resident_bwd_kernel_matches_plain(dtype, shape):
    _need_card()
    q, k, v = _resident_qkv(shape, dtype, seed=7)
    out, lse = fused_temporal_attention_resident(q, k, v)
    dout = torch.randn(*shape[:3], 2, *shape[3:], device="cuda").to(dtype)[..., 0, :, :]
    got = fused_temporal_attention_resident_bwd(q, k, v, out, lse, dout)
    want = temporal_resident_bwd_plain(q, k, v, out, lse, dout)
    assert got.is_contiguous() and got.shape == (*shape[:3], 3, *shape[3:])
    tol = BWD_FP32_TOL if dtype == torch.float32 else BWD_BF16_TOL["K4'"]
    _assert_grads_match([g.contiguous() for g in got.unbind(3)],
                        [w.contiguous() for w in want.unbind(3)], tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", RESIDENT_SHAPES)
def test_resident_kernel_equals_transposed_kernels_bit_for_bit(dtype, shape):
    """K5' shares K3'/K4''s bodies: on the same values regrouped to
    (B*S, T, H, D) it gives the same out, lse, dq, dk and dv, bit for bit."""
    _need_card()
    B, T, S, H, D = shape
    q, k, v = _resident_qkv(shape, dtype, seed=8)
    dout = torch.randn(B, T, S, H, D, device="cuda").to(dtype)
    sites = [x.transpose(1, 2).reshape(B * S, T, H, D) for x in (q, k, v, dout)]
    out, lse = fused_temporal_attention_resident(q, k, v)
    out3, lse3 = fused_temporal_attention(*sites[:3])
    assert torch.equal(out.transpose(1, 2).reshape(B * S, T, H, D), out3)
    assert torch.equal(lse, lse3)
    dqkv = fused_temporal_attention_resident_bwd(q, k, v, out, lse, dout)
    grads3 = fused_temporal_attention_bwd(*sites[:3], out3, lse3, sites[3])
    for g, g3 in zip(dqkv.unbind(3), grads3):
        assert torch.equal(g.transpose(1, 2).reshape(B * S, T, H, D), g3)


@pytest.mark.gpu
@pytest.mark.parametrize("normed", [False, True])
def test_resident_function_launches_k5_and_hands_qkv_its_gradient(normed):
    """FusedTemporalResident launches K5''s forward and backward once each,
    and its qkv gradient (and q's and k's under qk_norm) equals the plain
    version's, with the Function's scaling of the q slot and, under qk_norm,
    its moving of the q and k slots out.

    The plain version runs on the card (fp32 products: TF32 is off for
    matmuls). On the card host's CPU its first call in a process read up to
    1.1e-3 off its later calls in 2 of 20 fresh processes, failing this
    limit, while K5''s gradient read 1.57e-5 off the later calls in all 20,
    bit for bit alike."""
    _need_card()
    assert not torch.backends.cuda.matmul.allow_tf32
    B, T, S, H, D, scale = 2, 12, 16, 8, 64, 0.125
    g = torch.Generator().manual_seed(9)
    base = torch.randn(B, T, S, 3, H, D, generator=g).cuda()
    qkv = base.clone().requires_grad_(True)
    qk = ([x.clone().requires_grad_(True) for x in base.unbind(3)[:2]]
          if normed else [None, None])
    fused_temporal_attention_resident.launches = 0
    fused_temporal_attention_resident_bwd.launches = 0
    out = FusedTemporalResident.apply(qkv, scale, *qk)
    out.square().sum().backward()
    torch.cuda.synchronize()
    assert (fused_temporal_attention_resident.launches,
            fused_temporal_attention_resident_bwd.launches) == (1, 1)
    got = [x.grad for x in [qkv, *qk] if x is not None]
    q, k, v = base[..., 0, :, :] * scale, base[..., 1, :, :], base[..., 2, :, :]
    ref_out, lse = temporal_resident_plain(q, k, v)
    dqkv = temporal_resident_bwd_plain(q, k, v, ref_out, lse, 2 * ref_out)
    dqkv[..., 0, :, :] *= scale
    want = [dqkv]
    if normed:
        want += [dqkv[..., 0, :, :].clone(), dqkv[..., 1, :, :].clone()]
        dqkv[..., :2, :, :] = 0
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["transpose", "resident"])
def test_dropout_masks_are_redrawn_alike_under_remat_on_the_card(layout):
    """A training forward with MLP dropout draws its per-block masks from
    seeds taken before each block, so remat's recompute on the card draws
    the same masks: the grads with remat equal those without, while another
    dropout seed moves them."""
    _need_card()
    from hma_tpu_torch.config import DiffusionGenieConfig
    from hma_tpu_torch.models.st_mar import STMAR

    cfg = DiffusionGenieConfig(
        num_layers=2, num_heads=2, d_model=64, T=4, S=16, vae_embed_dim=4,
        patch_size=2, diffloss_d=2, diffloss_w=128, action_token_size=8,
        action_network="concat+modulate", use_actions=True, action_domains=["a"],
        d_actions=[4], action_stats=[[[0.1, -0.2], [1.5, 0.5]]], qk_norm=False,
        mlp_drop=0.3)
    g = torch.Generator().manual_seed(0)
    lat = torch.randn(2, 4, 4, 4, 4, generator=g).cuda()
    actions = torch.randn(2, 4, 4, generator=g).cuda()
    mask = (torch.rand(2, 4, 4, 4, generator=g) < 0.5).int().cuda()
    draws = {"t": torch.randint(0, 1000, (8 * 4,), generator=g).cuda(),
             "noise": torch.randn(8 * 4, 16, generator=g).cuda()}
    base = STMAR(cfg, dtype=torch.float32, device="cpu", generator=g)
    with torch.no_grad():  # wake the zero-init heads, so the trunk gets grads
        for prm in base.parameters():
            prm.add_(0.02 * torch.randn(prm.shape, generator=g))
    grads = []
    for remat, seed in ((False, 1), (True, 1), (True, 2)):
        model = STMAR(cfg, dtype=torch.float32, device="cuda", remat=remat,
                      temporal_layout=layout)
        model.load_state_dict(base.state_dict())
        out = model(lat, lat, actions, 0, mask, dropout=torch.Generator().manual_seed(seed),
                    draws=draws)
        out["loss"].backward()
        grads.append({n: p.grad for n, p in model.named_parameters() if p.grad is not None})
    for n in grads[0]:
        torch.testing.assert_close(grads[1][n], grads[0][n], atol=1e-6, rtol=1e-5, msg=n)
    # another seed moves the grads ten times past that limit at least
    moved = max((grads[2][n] - grads[0][n]).abs().max().item() for n in grads[0])
    scale = max(g.abs().max().item() for g in grads[0].values())
    assert moved > 10 * (1e-6 + 1e-5 * scale)


# K6' against its plain version, max |x - plain| / max |plain| after all K
# steps, as chip_smoke.py sets the limits from H100 readings.
K6_FP32_TOL = 1e-5
K6_BF16_TOL = 2e-2
# one bf16 step: how many times nearer to the plain version than the control,
# by depth; chip_smoke.py says where the numbers come from
K6_STEP_MARGIN = {1: 10.0, 4: 3.0}


def _denoise_inputs(K, N, C, H, depth, dtype, seed):
    g = torch.Generator("cuda").manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    def linear(i, o, scale=1.0):
        return {"kernel": randn(i, o, scale=scale / math.sqrt(i)).to(dtype),
                "bias": randn(o, scale=0.1).to(dtype)}

    fc = {"input_proj": linear(C, H), "final_linear": linear(H, 2 * C, 0.3)}
    for j in range(depth):
        fc[f"res_{j}_fc1"] = linear(H, H)
        fc[f"res_{j}_fc2"] = linear(H, H)
        fc[f"res_{j}_ln"] = {"scale": 1 + randn(H, scale=0.1), "bias": randn(H, scale=0.1)}
    sched = torch.from_numpy(schedule_table(make_schedule("cosine", 1000, str(K)))).cuda()
    return dict(x_noise=randn(N, C), zs=randn(K, N, C),
                mods=randn(K, N, depth * 3 * H + 2 * H, scale=0.5).to(dtype),
                sched_tbl=sched, fc_params=fc)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, K6_FP32_TOL),
                                       (torch.bfloat16, K6_BF16_TOL)])
@pytest.mark.parametrize("shape,domain_ln,n_half,cfg,clip", [
    ((100, 48, 16, 1024, 4), False, 0, 1.0, True),
    # bf16: 7 passes of 80 rows, the last of 32; fp32: 11 tiles of 48, the last of 32
    ((100, 512, 16, 1024, 4), False, 0, 1.0, True),
    ((100, 45, 16, 1024, 4), True, 20, 2.0, True),
    ((20, 6, 5, 128, 2), True, 3, 2.0, False),
    ((20, 6, 5, 128, 0), False, 3, 2.0, True),  # no residual block
    # the two ends of the shared-memory budget, each over more than one bf16
    # pass with a ragged last one: 80 + 20 rows (one m16 tile of 4 rows) at
    # H 1152 (144 column tiles: 12 blocks take two); 80 + 80 + 10 at H 128
    ((20, 100, 16, 1152, 2), True, 0, 1.0, True),
    ((20, 170, 5, 128, 2), False, 37, 2.0, True)])
def test_denoise_loop_kernel_matches_plain(dtype, tol, shape, domain_ln, n_half, cfg, clip):
    _need_card()
    inp = _denoise_inputs(*shape, dtype, seed=6)
    kw = dict(depth=shape[4], temperature=0.8, clip_denoised=clip, domain_ln=domain_ln,
              n_half=n_half, cfg=cfg, dtype=dtype)
    fused_denoise_loop.launches = 0
    got = fused_denoise_loop(**inp, **kw)
    torch.cuda.synchronize()
    assert fused_denoise_loop.launches == 1
    want = fused_denoise_loop_plain(**inp, **kw)
    assert got.dtype == torch.float32 and got.shape == want.shape
    err = ((got - want).abs().max() / want.abs().max()).item()
    assert err <= tol, err


@pytest.mark.gpu
@pytest.mark.parametrize("depth", [1, 4])
@pytest.mark.parametrize("N,domain_ln,n_half,cfg", [
    (48, False, 0, 1.0), (512, False, 0, 1.0), (45, True, 20, 2.0)])
def test_denoise_loop_kernel_rounds_where_plain_does(N, domain_ln, n_half, cfg, depth):
    """One bf16 step at a mid-schedule row, so that no flipped rounding is
    carried on by a later step (and fewest at depth 1): the kernel is
    K6_STEP_MARGIN times nearer to the plain version, by the mean error,
    than the plain version computed in fp32 on the same bf16 inputs is."""
    _need_card()
    inp = _denoise_inputs(100, N, 16, 1024, depth, torch.bfloat16, seed=8)
    one = {**inp, "zs": inp["zs"][:1], "mods": inp["mods"][50:51],
           "sched_tbl": inp["sched_tbl"][50:51]}
    kw = dict(depth=depth, temperature=0.8, clip_denoised=True, domain_ln=domain_ln,
              n_half=n_half, cfg=cfg)
    got = fused_denoise_loop(**one, dtype=torch.bfloat16, **kw)
    want = fused_denoise_loop_plain(**one, dtype=torch.bfloat16, **kw)
    in_fp32 = fused_denoise_loop_plain(**one, dtype=torch.float32, **kw)
    err, control = (got - want).abs().mean().item(), (in_fp32 - want).abs().mean().item()
    assert K6_STEP_MARGIN[depth] * err <= control, (err, control)


@pytest.mark.gpu
def test_denoise_loop_raises_on_what_the_kernel_does_not_take():
    _need_card()
    inp = _denoise_inputs(4, 6, 5, 128, 1, torch.float32, seed=7)
    kw = dict(depth=1, temperature=1.0, clip_denoised=True, domain_ln=False)
    with pytest.raises(ValueError, match="n_half"):
        fused_denoise_loop(**inp, n_half=4, dtype=torch.float32, **kw)
    with pytest.raises(ValueError, match="dtype"):
        fused_denoise_loop(**inp, dtype=torch.float16, **kw)
    bad = _denoise_inputs(4, 6, 5, 96, 1, torch.float32, seed=7)  # H % 128 != 0
    with pytest.raises(ValueError, match="H % 128"):
        fused_denoise_loop(**bad, dtype=torch.float32, **kw)
    wide = _denoise_inputs(4, 6, 5, 1280, 1, torch.float32, seed=7)  # H > 1152
    with pytest.raises(ValueError, match="H <= 1152"):
        fused_denoise_loop(**wide, dtype=torch.float32, **kw)


# The shapes a tp 2 rank gives K1'-K5' (chip_smoke.py phase 25): the d256
# step's spatial (B*T, S, H / 2, D) and temporal (B*S, T, H / 2, D) calls,
# and the d512 STMAR card's resident (B, T, S, H / 2, D) call.
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["K1'", "K2'", "K3'", "K4'", "K5' fwd", "K5' bwd"])
def test_kernels_at_tp2_heads_match_plain(dtype, kernel):
    _need_card()
    fp32 = dtype == torch.float32
    if kernel.startswith("K5'"):
        shape = (8, 12, 128, 4, 64)
        q, k, v = _resident_qkv(shape, dtype, seed=40)
        out, lse = fused_temporal_attention_resident(q, k, v)
        if kernel == "K5' fwd":
            _assert_matches(out, lse, *temporal_resident_plain(q, k, v), 1e-5 if fp32 else 1e-2)
            return
        dout = torch.randn(*shape[:3], 2, *shape[3:], device="cuda").to(dtype)[..., 0, :, :]
        got = fused_temporal_attention_resident_bwd(q, k, v, out, lse, dout)
        want = temporal_resident_bwd_plain(q, k, v, out, lse, dout)
        _assert_grads_match([g.contiguous() for g in got.unbind(3)],
                            [w.contiguous() for w in want.unbind(3)],
                            BWD_FP32_TOL if fp32 else BWD_BF16_TOL["K4'"])
        return
    spatial = kernel in ("K1'", "K2'")
    lead, H, D = ((96, 320) if spatial else (2560, 12)), 4, 32
    q, k, v = _strided_qkv(lead, H, D, dtype, seed=41)
    if spatial:
        fwd, plain = (lambda *a: fused_attention(*a, False),
                      lambda *a: fused_attention_plain(*a, False))
        bwd, bwd_plain = (lambda *a: fused_attention_bwd(*a, False),
                          lambda *a: fused_attention_bwd_plain(*a, False))
    else:
        fwd, plain = fused_temporal_attention, fused_temporal_attention_plain
        bwd, bwd_plain = fused_temporal_attention_bwd, fused_temporal_attention_bwd_plain
    out, lse = fwd(q, k, v)
    if kernel in ("K1'", "K3'"):
        _assert_matches(out, lse, *plain(q, k, v),
                        1e-5 if fp32 else (4e-3 if spatial else 1e-2))
        return
    dout = _strided_dout(lead, H, D, dtype, seed=42)
    _assert_grads_match(bwd(q, k, v, out, lse, dout), bwd_plain(q, k, v, out, lse, dout),
                        BWD_FP32_TOL if fp32 else BWD_BF16_TOL["K2'" if spatial else "K4'"])
