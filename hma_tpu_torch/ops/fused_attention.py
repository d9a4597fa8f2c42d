"""Whole-block softmax attention forward: kernel K1' (csrc/fused_attention_fwd.cu).

Replaces the Pallas TPU kernel `hma_tpu/ops/fused_attention.py:_fwd_kernel`
(entered through `_fwd` and `fused_attention`): out = softmax(q k^T
[causal]) v for each (batch, head), q pre-scaled, plus the fp32 row
log-sum-exp `lse` that a backward needs. The ST transformer runs it as the
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

Public layout (B, S, H, D) with any strides on the first three axes and a
unit stride on D; `out` comes back contiguous, `lse` as (B, H, S) fp32.
"""

from __future__ import annotations

from typing import Optional

import torch

from hma_tpu_torch.ops._build import launch_attention

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
    The one plain attention of the port: K3''s plain version and
    `models.attention._attend` are this function.
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
    return torch.einsum("bhnm,bmhd->bnhd", probs, v), lse


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
