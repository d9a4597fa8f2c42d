"""Whole-block softmax attention: forward kernel K1'
(csrc/fused_attention_fwd.cu) and backward kernel K2'
(csrc/fused_attention_bwd.cu), joined by the autograd.Function
`FusedAttention`.

K1' replaces the Pallas TPU kernel `hma_tpu/ops/fused_attention.py:_fwd_kernel`
(entered through `_fwd` and `fused_attention`): out = softmax(q k^T
[causal]) v for each (batch, head), q pre-scaled, plus the fp32 row
log-sum-exp `lse` that the backward needs. The ST transformer runs it as the
bidirectional spatial pass over the 320 tokens of a frame (B = 8 per cached
frame, B = 96 on a full forward; H = 8, D = 32).

What bounds it on an H100: bytes. At B = 96 it must move 64 MB (q, k, v,
out in bf16 plus lse) for 10 GFLOP, ~19 us at 3.35 TB/s against ~10 us of
bf16 tensor-core time. The TPU kernel keeps the whole 320 x 320 fp32 score
block of a head in VMEM (400 KB); a Hopper block has at most 227 KB of
shared memory, so the design changes:
  - one block per (64-query tile, head, batch element), one thread per
    query row holding its q row and fp32 output accumulator in registers;
  - keys and values stream through shared memory in 64-key tiles (fp32,
    read as warp-wide broadcasts), so any S works and the score block never
    exists in memory;
  - two sweeps over the keys: the first finds each row's max and sum, the
    second forms the exact normalised probabilities, rounds them to the
    compute dtype (as `fused_attention.py:73` does) and accumulates p v.
It runs on CUDA cores, not tensor cores: right and simple first
(wgmma/TMA are later work); PERF.md has its time beside the bound.

K2' replaces `_bwd_kernel` (entered through `_bwd` and `_vjp_bwd`), with its
numerics: p = exp(q k^T - lse) in fp32, dv = round(p)^T dout, delta =
rowsum(dout * out), ds = round(p (dout v^T - delta)), dq = ds k, dk = ds^T q
(round = to the compute dtype; fp32 accumulation). It is bound by bytes as
well: it reads q, k, v, out, dout and writes dq, dk, dv, 127 MB at B = 96
(~38 us at 3.35 TB/s; its 25 GFLOP take ~25 us of bf16 tensor-core time).
The TPU kernel holds the S x S score block again; K2' runs two passes
without one and without atomics: a dq pass (one thread per query row, which
also stores delta) and a dk/dv pass (one thread per key row), each
recomputing the scores from q, k and lse.

Public layout (B, S, H, D) with any strides on the first three axes and a
unit stride on D; `out` comes back contiguous, `lse` as (B, H, S) fp32.
"""

from __future__ import annotations

from typing import Optional

import torch

from hma_tpu_torch.ops._build import launch_attention, launch_attention_bwd

NEG_INF = -1e30  # the Pallas kernel's mask value
MAX_S = 1024


def fused_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = False, *,
                          kv_mask: Optional[torch.Tensor] = None, dtype=None):
    """Plain PyTorch version: (out (B,N,H,D), lse (B,H,N) fp32).

    q: (B, N, H, D) pre-scaled, k, v: (B, M, H, D). fp32 logits and
    softmax; probs cast to `dtype` (default q.dtype) before the PV product.
    The causal diagonal is aligned to the end of the kv axis, so a
    single-query step attends to every key; kv_mask (B, M) drops keys.
    With dtype=float32 the probs stay fp32 and v is upcast, as K3 does;
    out comes back in q.dtype. The one plain attention of the port: K3''s
    plain version and `models.attention._attend` are this function.
    """
    logits = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float())
    if causal:
        n, m = logits.shape[-2:]
        row = torch.arange(n, device=q.device)[:, None]
        col = torch.arange(m, device=q.device)[None, :]
        logits = logits.masked_fill(col - (m - n) > row, NEG_INF)
    if kv_mask is not None:
        logits = logits.masked_fill(~kv_mask[:, None, None, :], NEG_INF)
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    s = p.sum(-1, keepdim=True)
    lse = (m + torch.log(s))[..., 0]
    probs = (p / s).to(dtype or q.dtype)
    out = torch.einsum("bhnm,bmhd->bnhd", probs, v.to(probs.dtype))
    return out.to(q.dtype), lse


def attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                        causal: bool, round_p_ds: bool):
    """Plain PyTorch backward from `lse`: (dq, dk, dv), each (B, N, H, D) in
    q.dtype, for q, k, v, out, dout (B, N, H, D) and lse (B, H, N) fp32.

    p = exp(q k^T - lse), dp = dout v^T, delta = rowsum(dout * out) and
    ds = p (dp - delta) in fp32; dv = p^T dout, dq = ds k, dk = ds^T q with
    fp32 accumulation. `round_p_ds` is what separates the two TPU kernels:
    K2 rounds p (for dv) and ds to the compute dtype before the products,
    K4 keeps both fp32. dout is cast to q.dtype first, as both `_vjp_bwd`s do.
    """
    dt = q.dtype
    dout = dout.to(dt).float()
    qf, kf, vf = q.float(), k.float(), v.float()
    p = torch.exp(torch.einsum("bnhd,bmhd->bhnm", qf, kf) - lse[..., None])
    if causal:
        n = p.shape[-1]
        row = torch.arange(n, device=q.device)[:, None]
        col = torch.arange(n, device=q.device)[None, :]
        p = p.masked_fill(col > row, 0.0)
    # dp = dout v^T and delta = rowsum(dout * out) from one product over
    # [v | out], so that the two sum their D terms in one order, as each
    # kernel does: where out equals v (a row that attends to one key),
    # dp - delta is then exactly 0, as it is in the kernels
    m = k.shape[1]
    both = torch.einsum("bnhd,bmhd->bhnm", dout, torch.cat([vf, out.float()], 1))
    dp = both[..., :m]
    delta = both[..., m:].diagonal(dim1=-2, dim2=-1)  # (B, H, N)
    ds = p * (dp - delta[..., None])
    if round_p_ds:
        p, ds = p.to(dt).float(), ds.to(dt).float()
    dv = torch.einsum("bhnm,bnhd->bmhd", p, dout)
    dq = torch.einsum("bhnm,bmhd->bnhd", ds, kf)
    dk = torch.einsum("bhnm,bnhd->bmhd", ds, qf)
    return dq.to(dt), dk.to(dt), dv.to(dt)


def fused_attention_bwd_plain(q, k, v, out, lse, dout, causal: bool = False):
    """K2''s plain version: `attention_bwd_plain` with p and ds rounded."""
    return attention_bwd_plain(q, k, v, out, lse, dout, causal, True)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False):
    """softmax(q k^T [causal]) v with q pre-scaled; returns (out, lse).

    CPU tensors take the plain version; CUDA tensors launch K1' or raise.
    """
    if q.device.type == "cpu":
        return fused_attention_plain(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention: unsupported device {q.device}")
    out = launch_attention("fused_attention_fwd", q, k, v, MAX_S, int(causal))
    fused_attention.launches += 1
    return out


fused_attention.launches = 0


def fused_attention_bwd(q, k, v, out, lse, dout, causal: bool = False):
    """(dq, dk, dv) of `fused_attention` from its out and lse.

    CPU tensors take the plain version; CUDA tensors launch K2' or raise.
    dout is cast to q.dtype and made contiguous only when its D stride is
    not 1; q, k, v, out and dout may have any other strides.
    """
    if q.device.type == "cpu":
        return fused_attention_bwd_plain(q, k, v, out, lse, dout, causal)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention_bwd: unsupported device {q.device}")
    dout = dout.to(q.dtype)
    if dout.stride(-1) != 1:
        dout = dout.contiguous()
    grads = launch_attention_bwd("fused_attention_bwd", q, k, v, out, lse, dout,
                                 MAX_S, int(causal), delta=True)
    fused_attention_bwd.launches += 1
    return grads


fused_attention_bwd.launches = 0


class FusedAttention(torch.autograd.Function):
    """out = softmax(q k^T [causal]) v through K1' forward and K2' backward
    (their plain versions for CPU tensors). Saves (q, k, v, out, lse) as
    the tensors it was given, views included, with no copy."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool = False):
        out, lse = fused_attention(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return (*fused_attention_bwd(q, k, v, out, lse, dout, ctx.causal), None)
