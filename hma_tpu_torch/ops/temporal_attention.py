"""Causal tiny-T temporal attention forward: kernel K3'
(csrc/temporal_attention_fwd.cu).

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
  - fp32 softmax statistics, probs rounded to the compute dtype before
    p v, as the XLA path (`hma_tpu.models.attention._attend`) does.
Any N works: the last block's surplus warps leave at once.

Public layout (N, T, H, D) with any strides on the first three axes and a
unit stride on D; `out` comes back contiguous, `lse` as (N, H, T) fp32.
"""

from __future__ import annotations

import torch

from hma_tpu_torch.ops._build import launch_attention
from hma_tpu_torch.ops.fused_attention import fused_attention_plain

MAX_T = 16


def fused_temporal_attention_plain(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor):
    """Plain PyTorch version: (out (N,T,H,D) in q.dtype, lse (N,H,T) fp32),
    K1''s plain version with the causal mask over T."""
    return fused_attention_plain(q, k, v, True)


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
