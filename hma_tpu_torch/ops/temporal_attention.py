"""Causal tiny-T temporal attention: forward kernel K3'
(csrc/temporal_attention_fwd.cu) and backward kernel K4'
(csrc/temporal_attention_bwd.cu), joined by the autograd.Function
`FusedTemporalAttention`.

Replaces the Pallas TPU kernel `hma_tpu/ops/temporal_attention.py:_fwd_kernel`
(entered through `_fwd` and `fused_temporal_attention`): at each of N sites
and for each head, causal attention over T <= 16 frames, q pre-scaled, plus
the fp32 `lse`. The ST transformer's full forward runs it at N = B * S_tot =
2560, T = 12, H = 8, D = 32; the KV-cached rollout never does (its temporal
pass is `SelfAttention.decode_step`).

What bounds it on an H100: bytes. It reads q, k, v and writes out, 64 MB at
the full-forward shape (~19 us at 3.35 TB/s), for only 78 causal (t, s)
pairs of D-long dot products per (site, head). The TPU kernel's
sites-on-lanes (H, T, D, N) layout exists only for the TPU's (8, 128)
tiling; here the kernel reads (N, T, H, D) as it is:
  - one warp per (site, head), lanes over D, so every load and store is a
    D-contiguous coalesced row and no transpose is needed;
  - q, k, v of all frames sit in registers; scores are warp-shuffle sums
    over the causal pairs s <= t only;
  - fp32 softmax statistics and probs, p v accumulated in fp32 from the
    upcast v, only out rounded to the compute dtype, as the TPU kernel
    does (`temporal_attention.py:49-60`; unlike K1, which rounds probs).
Any N works: the last block's surplus warps leave at once.

K4' replaces `_bwd_kernel` (entered through `_bwd` and `_vjp_bwd`). Every
intermediate is fp32 (p, dp, delta, ds and the accumulators); only dq, dk,
dv are rounded. Bound by bytes: it reads q, k, v, out, dout and writes dq,
dk, dv, 127 MB at N = 2560 (~38 us at 3.35 TB/s). The same design as K3':
one warp per (site, head), lanes over D, q, k, v and dout of all frames in
registers (out only for delta), two warp-shuffle dot products per causal
pair, dk and dv accumulated in registers.

Public layout (N, T, H, D) with any strides on the first three axes and a
unit stride on D; `out` comes back contiguous, `lse` as (N, H, T) fp32.
"""

from __future__ import annotations

import torch

from hma_tpu_torch.ops._build import launch_attention, launch_attention_bwd
from hma_tpu_torch.ops.fused_attention import attention_bwd_plain, fused_attention_plain

MAX_T = 16


def fused_temporal_attention_plain(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor):
    """Plain PyTorch version: (out (N,T,H,D) in q.dtype, lse (N,H,T) fp32),
    K1''s plain version with the causal mask over T and fp32 probs."""
    return fused_attention_plain(q, k, v, True, dtype=torch.float32)


def fused_temporal_attention_bwd_plain(q, k, v, out, lse, dout):
    """K4''s plain version: `attention_bwd_plain`, causal, all fp32 inside."""
    return attention_bwd_plain(q, k, v, out, lse, dout, True, False)


def fused_temporal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Causal attention over the T axis at every site; returns (out, lse).

    CPU tensors take the plain version; CUDA tensors launch K3' or raise.
    """
    if q.device.type == "cpu":
        return fused_temporal_attention_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"fused_temporal_attention: unsupported device {q.device}")
    out = launch_attention("temporal_attention_fwd", q, k, v, MAX_T)
    fused_temporal_attention.launches += 1
    return out


fused_temporal_attention.launches = 0


def fused_temporal_attention_bwd(q, k, v, out, lse, dout):
    """(dq, dk, dv) of `fused_temporal_attention` from its out and lse.

    CPU tensors take the plain version; CUDA tensors launch K4' or raise.
    dout is cast to q.dtype and made contiguous only when its D stride is
    not 1.
    """
    if q.device.type == "cpu":
        return fused_temporal_attention_bwd_plain(q, k, v, out, lse, dout)
    if q.device.type != "cuda":
        raise ValueError(f"fused_temporal_attention_bwd: unsupported device {q.device}")
    dout = dout.to(q.dtype)
    if dout.stride(-1) != 1:
        dout = dout.contiguous()
    grads = launch_attention_bwd("temporal_attention_bwd", q, k, v, out, lse,
                                 dout, MAX_T)
    fused_temporal_attention_bwd.launches += 1
    return grads


fused_temporal_attention_bwd.launches = 0


class FusedTemporalAttention(torch.autograd.Function):
    """Causal attention over T through K3' forward and K4' backward (their
    plain versions for CPU tensors). Saves (q, k, v, out, lse) as given,
    views included, with no copy."""

    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = fused_temporal_attention(q, k, v)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        return fused_temporal_attention_bwd(*ctx.saved_tensors, dout)
