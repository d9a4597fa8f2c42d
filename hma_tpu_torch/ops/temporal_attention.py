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
pairs of D-long dot products per (site, head): the fp32 arithmetic is about
a sixth of that. The TPU kernel puts the SITE axis on lanes
(`hma_tpu/ops/temporal_attention.py:9-14`) so that every elementwise and
reduce op runs on dense site vectors and the (T, T) scores of a site are
exactly their natural size. The reason holds on a GPU too: a design with
lanes over D makes every score a cross-lane reduction and runs each softmax
scalar (max, sum, exp, p, ds) on all 32 lanes. So the kernels
(`csrc/temporal_attention.cuh`) put sites over threads, as the TPU kernel
puts them over lanes:
  - a thread owns one query row (site, head, frame t) and runs its dot
    products over D in fp32 in the thread; every softmax scalar is computed
    once, by its owner;
  - a block takes a tile of R (site, head) rows with all their frames (R =
    32, or 16, 8, 4 with F = 32 / R frames a warp where a tile of 32 rows
    does not fit the shared-memory budget) and stages q, k, v into shared
    memory in 16-byte cp.async pieces, whatever the strides, every global
    read a full line; q and k arrive first, v while the scores are computed;
  - out goes back through shared memory as 16-byte stores of whole rows;
  - fp32 softmax statistics and probs, p v accumulated in fp32 from the
    upcast v, only out rounded to the compute dtype, as the TPU kernel does
    (`temporal_attention.py:49-60`; unlike K1, which rounds probs).
At D 16, 32 and 64 the rows must start 16-byte aligned (the copies are 16
bytes); q, k, v that do not raise ValueError. The main path's views of the
qkv projection always do there. Any other D up to 64 (61 on the magvit d512
card) runs the same bodies at the next of 16, 32, 64, at any 2-byte
alignment: the 16-byte-aligned chunks that cover each row are copied with
cp.async (at most 15 bytes on either side of the row, inside its
16-byte-aligned extent), then the row is shifted into place and zero-padded
in shared memory (the extra terms of every dot product and axpy are 0), and
only the D real elements are stored. D past 64 raises ValueError.

K4' replaces `_bwd_kernel` (entered through `_bwd` and `_vjp_bwd`). Every
intermediate is fp32 (p, dp, delta, ds and the accumulators); only dq, dk,
dv are rounded. Bound by bytes: it reads q, k, v, out, dout and writes dq,
dk, dv, 127 MB at N = 2560 (~38 us at 3.35 TB/s). The same tiles, staged the
same way, in two phases in one block, with no atomics and one exp a pair:
(a) the thread of (row, t) computes delta_t, then p and ds of its causal row
into shared memory (fp32) and dq_t; (b) after a barrier the thread of (row,
j) sums dk_j and dv_j over t >= j. A dout whose rows are not 16-byte aligned
is copied first.

Public layout (N, T, H, D) with any strides on the first three axes and a
unit stride on D; `out` comes back contiguous, `lse` as (N, H, T) fp32.

K5' (csrc/temporal_resident_{fwd,bwd}.cu) replaces the kernel-layout entry
`hma_tpu/ops/temporal_attention.py:fused_temporal_attention_kl`, which the
resident ST block (`temporal_layout="resident"`) feeds without transposing
its (B, T, S, C) residual stream. It computes what K3'/K4' compute, with
their bodies (`csrc/temporal_attention.cuh`), on q, k, v where the qkv
projection leaves them: (B, T, S, H, D) views of the (B, T, S, 3, H, D)
projection, whose site n = b S + s has a stride for b and another for s,
with T between them, which three strides per tensor cannot express. So K5'
takes (b, t, s, h) strides, writes out contiguous (B, T, S, H, D) (the (B,
T, S, C) the output projection reads) and, in the backward, dq, dk, dv into
the three slots of one (B, T, S, 3, H, D) buffer, the gradient of the
projection's output as one tensor. `FusedTemporalResident` joins the two and
owns the scaling of q (a plain product rounded to the compute dtype before
the kernel reads it, never folded into the kernel), so that buffer reaches
the projection as it is. Its plain version is K3'/K4''s after an explicit
regroup to (B*S, T, H, D), as `hma_tpu`'s off-TPU branch of
`SelfAttention.temporal_resident` regroups.
"""

from __future__ import annotations

import torch

from hma_tpu_torch.ops._build import (
    launch_attention,
    launch_attention_bwd,
    launch_temporal_resident,
    launch_temporal_resident_bwd,
    rows16,
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

    CPU tensors take the plain version; CUDA tensors launch K3' or raise,
    also for D past 64 and, at D 16, 32 or 64, when a row of q, k or v does
    not start 16-byte aligned (the kernel stages those rows with 16-byte
    asynchronous copies).
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
    dout is cast to q.dtype and copied only when its D stride is not 1 or,
    at D 16, 32 or 64, a row is not 16-byte aligned; q, k, v and out need
    16-byte-aligned rows there.
    """
    if q.device.type == "cpu":
        return fused_temporal_attention_bwd_plain(q, k, v, out, lse, dout)
    if q.device.type != "cuda":
        raise ValueError(f"fused_temporal_attention_bwd: unsupported device {q.device}")
    dout = rows16(dout, q.dtype)
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

    CPU tensors take the plain version; CUDA tensors launch K5' or raise,
    also for D past 64 and, at D 16, 32 or 64, when a row of q, k or v does
    not start 16-byte aligned.
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
    dout is cast to q.dtype and copied only when its D stride is not 1 or,
    at D 16, 32 or 64, a row is not 16-byte aligned; q, k, v and out need
    16-byte-aligned rows there.
    """
    if q.device.type == "cpu":
        return temporal_resident_bwd_plain(q, k, v, out, lse, dout)
    if q.device.type != "cuda":
        raise ValueError(f"fused_temporal_attention_resident_bwd: unsupported "
                         f"device {q.device}")
    dout = rows16(dout, q.dtype)
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
