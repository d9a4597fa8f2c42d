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

K5' (csrc/temporal_resident_{fwd,bwd}.cu) replaces the kernel-layout entry
`hma_tpu/ops/temporal_attention.py:fused_temporal_attention_kl`, which the
resident ST block (`temporal_layout="resident"`) feeds without transposing
its (B, T, S, C) residual stream. It computes what K3'/K4' compute, with
their warp-per-(site, head) body (`csrc/temporal_attention.cuh`), on q, k, v
where the qkv projection leaves them: (B, T, S, H, D) views of the (B, T,
S, 3, H, D) projection, whose site n = b S + s has a stride for b and
another for s, with T between them, which three strides per tensor cannot
express. So K5' takes (b, t, s, h) strides, writes out contiguous (B, T, S,
H, D) (the (B, T, S, C) the output projection reads) and, in the backward,
dq, dk, dv into the three slots of one (B, T, S, 3, H, D) buffer, the
gradient of the projection's output as one tensor. `FusedTemporalResident`
joins the two and owns the scaling of q (a plain product rounded to the
compute dtype before the kernel reads it, never folded into the kernel), so
that buffer reaches the projection as it is. Its plain version is K3'/K4''s
after an explicit regroup to (B*S, T, H, D), as `hma_tpu`'s off-TPU branch
of `SelfAttention.temporal_resident` regroups.
"""

from __future__ import annotations

import torch

from hma_tpu_torch.ops._build import (
    launch_attention,
    launch_attention_bwd,
    launch_temporal_resident,
    launch_temporal_resident_bwd,
)
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


def _sites(x: torch.Tensor) -> torch.Tensor:
    """(B, T, S, H, D) -> (B*S, T, H, D): the sites as one axis."""
    B, T, S, H, D = x.shape
    return x.permute(0, 2, 1, 3, 4).reshape(B * S, T, H, D)


def _frames(x: torch.Tensor, B: int, S: int) -> torch.Tensor:
    """(B*S, T, ...) -> (B, T, S, ...) contiguous: the inverse of `_sites`."""
    return x.reshape(B, S, *x.shape[1:]).transpose(1, 2).contiguous()


def temporal_resident_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """K5''s plain version: (out (B, T, S, H, D), lse (B*S, H, T) fp32) from
    (B, T, S, H, D) q, k, v, through K3''s plain version on the regrouped
    sites."""
    B, _, S = q.shape[:3]
    out, lse = fused_temporal_attention_plain(_sites(q), _sites(k), _sites(v))
    return _frames(out, B, S), lse


def temporal_resident_bwd_plain(q, k, v, out, lse, dout) -> torch.Tensor:
    """K5''s plain backward: dq, dk, dv as the slots of one (B, T, S, 3, H, D),
    through K4''s plain version on the regrouped sites."""
    B, _, S = q.shape[:3]
    grads = fused_temporal_attention_bwd_plain(
        *(_sites(x) for x in (q, k, v, out)), lse, _sites(dout))
    return _frames(torch.stack(grads, 2), B, S)


def fused_temporal_attention_resident(q: torch.Tensor, k: torch.Tensor,
                                      v: torch.Tensor):
    """Causal attention over T at every (b, s) site of (B, T, S, H, D) q, k,
    v (q pre-scaled, any strides with a unit one on D); returns (out
    (B, T, S, H, D) contiguous, lse (B*S, H, T) fp32).

    CPU tensors take the plain version; CUDA tensors launch K5' or raise.
    """
    if q.device.type == "cpu":
        return temporal_resident_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"fused_temporal_attention_resident: unsupported device {q.device}")
    out = launch_temporal_resident(q, k, v, MAX_T)
    fused_temporal_attention_resident.launches += 1
    return out


fused_temporal_attention_resident.launches = 0


def fused_temporal_attention_resident_bwd(q, k, v, out, lse, dout) -> torch.Tensor:
    """dq, dk, dv of `fused_temporal_attention_resident` from its out and
    lse, as the slots of one contiguous (B, T, S, 3, H, D).

    CPU tensors take the plain version; CUDA tensors launch K5' or raise.
    dout is cast to q.dtype and made contiguous only when its D stride is
    not 1.
    """
    if q.device.type == "cpu":
        return temporal_resident_bwd_plain(q, k, v, out, lse, dout)
    if q.device.type != "cuda":
        raise ValueError(f"fused_temporal_attention_resident_bwd: unsupported "
                         f"device {q.device}")
    dout = dout.to(q.dtype)
    if dout.stride(-1) != 1:
        dout = dout.contiguous()
    dqkv = launch_temporal_resident_bwd(q, k, v, out, lse, dout, MAX_T)
    fused_temporal_attention_resident_bwd.launches += 1
    return dqkv


fused_temporal_attention_resident_bwd.launches = 0


class FusedTemporalResident(torch.autograd.Function):
    """The resident layout's causal pass: forward(qkv, scale, q=None, k=None)
    -> out (B, T, S, H, D), through K5' forward and backward (their plain
    versions for CPU tensors).

    qkv: the (B, T, S, 3, H, D) projection; v is its slot 2, and q and k its
    slots 0 and 1 unless given (qk_norm passes the normalised q and k, each
    (B, T, S, H, D)). q * scale is rounded to qkv's dtype before the kernel
    reads it. The backward's (B, T, S, 3, H, D) buffer, its q slot times
    scale, is the gradient of qkv as it is; with q and k given, their slots
    are moved out to them and zeroed in the buffer."""

    @staticmethod
    def forward(ctx, qkv, scale, q=None, k=None):
        given = q is not None
        q = (qkv[..., 0, :, :] if q is None else q) * scale
        k = qkv[..., 1, :, :] if k is None else k
        v = qkv[..., 2, :, :]
        out, lse = fused_temporal_attention_resident(q, k, v)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.given = scale, given
        return out

    @staticmethod
    def backward(ctx, dout):
        dqkv = fused_temporal_attention_resident_bwd(*ctx.saved_tensors, dout)
        dqkv[..., 0, :, :].mul_(ctx.scale)
        if not ctx.given:
            return dqkv, None, None, None
        dq, dk = dqkv[..., 0, :, :].clone(), dqkv[..., 1, :, :].clone()
        dqkv[..., :2, :, :].zero_()
        return dqkv, None, dq, dk
