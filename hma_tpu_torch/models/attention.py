"""Attention primitives for the ST transformer
(counterpart of hma_tpu/models/attention.py).

- `Dense` and `LayerNorm` reproduce flax's `nn.Dense` (fp32 params cast to
  the compute dtype at use) and `nn.LayerNorm` (fp32, E[x^2] - E[x]^2
  variance) so converted weights give the same numbers.
- `SelfAttention.forward` sends the bidirectional (spatial) pass to
  `ops.fused_attention.FusedAttention` (K1' forward, K2' backward) and the
  causal (temporal) pass to `ops.temporal_attention.FusedTemporalAttention`
  (K3' forward, K4' backward). Each launches its CUDA kernels for a CUDA
  tensor and uses their plain versions only for a CPU tensor; gradients
  reach the fused qkv projection through the q/k/v views.
- `SelfAttention.temporal_resident` is the causal pass of the resident
  layout (`temporal_layout="resident"`): the (B, T, S, C) stream is never
  transposed; `ops.temporal_attention.FusedTemporalResident` (K5') reads
  q, k, v where the qkv projection leaves them and hands the projection
  its gradient as one (B, T, S, 3, H, D) buffer.
- `SelfAttention.decode_step` is one timestep against a read-only temporal
  KV cache; it is plain PyTorch, as its JAX counterpart is plain XLA, and
  rounds its probs to the compute dtype as `_attend` does.
- `SelfAttention.decode_window` is F consecutive timesteps against the
  same cache, causal within the window: plain PyTorch as well (its JAX
  counterpart is XLA einsums), scores in fp32, probs rounded to the
  compute dtype before p v.

Under tensor parallelism (`parallel.tensor_parallel.split_model`) `Dense`
runs its split as the rank's part ("col": the rank's output features,
"row": a partial product over its input features, summed over the group,
the bias added once after; "whole": the weight gathered) and
`SelfAttention` runs on the rank's H / tp heads: `qkv` gives their q, k, v
in (3, H / tp, D) order, K1'-K5' and the decode paths take them as they
take all heads in one process, and `proj` is row-split.

Under sequence parallelism (`parallel.sequence_parallel.enable`) x holds
the rank's tokens of each frame: the spatial pass sends q, k, v of its
tokens and all of its heads through `tokens_to_heads` (an all-to-all) to
every token of H / sp heads, runs K1'/K2' there, and `heads_to_tokens`
brings the output back before `proj`; the causal passes are per site and
need no exchange.

`CrossAttention` is not ported yet. `attn_drop` is not
an argument: `hma_tpu`'s attention builds its dropout and never calls it, a
quirk of the reference, so it is a no-op there.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from hma_tpu_torch.ops.fused_attention import FusedAttention, fused_attention_plain
from hma_tpu_torch.ops.temporal_attention import (
    FusedTemporalAttention,
    FusedTemporalResident,
)
from hma_tpu_torch.parallel import sequence_parallel as seqp
from hma_tpu_torch.parallel import tensor_parallel as tpar

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)  # the decode paths' mask value


def split_linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], module,
                 matmul, in_width: int) -> torch.Tensor:
    """`matmul(x, w, b)` under `module`'s tp mode "col" or "row" (see
    `Dense`): w is the rank's part (`in_width` input features), b (whole)
    is sliced ("col") or added after the sum ("row"), and a "row" input of
    whole width is sliced first."""
    tp = module.tp
    if module.tp_mode == "col":
        b = None if b is None else tpar.copy(b, tp)[..., module.tp_index]
        return matmul(tpar.copy(x, tp), w, b)
    if x.shape[-1] != in_width:
        x = tpar.scatter(x, tp)
    y = tpar.reduce(matmul(x, w, None), tp)
    return y if b is None else y + b


class Dense(nn.Linear):
    """nn.Linear whose fp32 parameters are cast to `dtype` at use.

    Under tp (`tensor_parallel.split_model` sets `tp`, `tp_mode`, `tp_part`
    and, for "col", `tp_index`), mode "col" holds the rank's output features
    and takes the replicated input, "row" its input features and sums its
    partial product over the group, "whole" a part that is gathered at use."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype=torch.bfloat16, device="cuda"):
        super().__init__(in_features, out_features, bias=bias, device=device)
        self.dtype = dtype
        self.tp = self.tp_mode = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(self.dtype)
        w = self.weight
        if self.tp_mode in (None, "whole"):
            if self.tp_mode == "whole":
                w = tpar.gather(w, self.tp, self.tp_part.dim)
            return F.linear(x.to(self.dtype), w.to(self.dtype), b)
        return split_linear(x.to(self.dtype), w.to(self.dtype), b, self, F.linear,
                            w.shape[1])


class LayerNorm(nn.Module):
    """flax `nn.LayerNorm(dtype=float32)`: var = E[x^2] - E[x]^2 in fp32."""

    def __init__(self, features: int, eps: float = 1e-5, device="cuda"):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.tp = None  # set where it normalises a tp rank's heads alone

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean, min=0.0)
        w, b = tpar.copy(self.weight, self.tp), tpar.copy(self.bias, self.tp)
        return (x - mean) * (torch.rsqrt(var + self.eps) * w) + b


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
            kv_mask: Optional[torch.Tensor] = None,
            dtype=torch.bfloat16) -> torch.Tensor:
    """Scaled dot-product attention, q,k,v: (B, N|M, H, D), q pre-scaled.

    fp32 logits and softmax; probs cast to `dtype` before the PV product;
    the causal diagonal is aligned to the END of the kv axis so a
    single-query step attends to every key. It is K1''s plain version.
    """
    return fused_attention_plain(q, k, v, causal, kv_mask=kv_mask, dtype=dtype)[0]


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched product with fp32 output and accumulation (JAX's
    `preferred_element_type=float32`) without upcasting the operands."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    return torch.bmm(a, b, out_dtype=torch.float32)


class SelfAttention(nn.Module):
    """Self-attention with fused QKV and an optional shared fp32 qk-LayerNorm."""

    def __init__(self, num_heads: int, d_model: int, qkv_bias: bool = False,
                 proj_bias: bool = True, qk_norm: bool = True,
                 use_mup: bool = True, dtype=torch.bfloat16, device="cuda"):
        super().__init__()
        self.num_heads = num_heads
        self.d_model = d_model
        self.head_dim = d_model // num_heads
        self.dtype = dtype
        raw = 8.0 / self.head_dim if use_mup else self.head_dim**-0.5
        # JAX multiplies by the scale cast to the compute dtype
        self.scale = float(torch.tensor(raw, dtype=dtype))
        self.qkv = Dense(d_model, 3 * d_model, qkv_bias, dtype, device)
        self.proj = Dense(d_model, d_model, proj_bias, dtype, device)
        self.norm = LayerNorm(self.head_dim, device=device) if qk_norm else None
        self.sp = None

    def enable_tp(self, tp) -> None:
        """Run on this rank's H / tp heads (`tensor_parallel.split_model`
        has split qkv by head and proj by input feature); the shared qk
        LayerNorm's gradient is then summed over the group."""
        if not tpar.split_mode(self.qkv, self.proj):
            return
        if self.num_heads % tp.size:
            raise NotImplementedError(f"tp {tp.size} does not divide {self.num_heads} heads")
        self.num_heads //= tp.size
        if self.norm is not None:
            self.norm.tp = tp

    def enable_sp(self, sp) -> None:
        """Take the rank's tokens: the spatial pass exchanges them for whole
        frames of H / sp of this rank's heads (after tp's split)."""
        if self.num_heads % sp.size:
            raise NotImplementedError(
                f"sp {sp.size} does not divide the {self.num_heads} heads a rank attends with")
        self.sp = sp

    def _qkv(self, x: torch.Tensor):
        B, N, _ = x.shape
        qkv = self.qkv(x).view(B, N, 3, self.num_heads, self.head_dim)
        q, k, v = qkv.unbind(2)
        if self.norm is not None:
            q = self.norm(q).to(self.dtype)
            k = self.norm(k).to(self.dtype)
        return q * self.scale, k, v

    def forward(self, x: torch.Tensor, causal: bool = False) -> torch.Tensor:
        """Full pass over x: (B, N, C); causal runs K3'/K4', otherwise K1'/K2'
        (under sp on whole frames of H / sp heads, between the exchanges)."""
        B, N, _ = x.shape
        q, k, v = self._qkv(x)
        if causal:
            out = FusedTemporalAttention.apply(q, k, v)
        elif self.sp is None:
            out = FusedAttention.apply(q, k, v, False)
        else:
            q, k, v = seqp.tokens_to_heads(torch.stack([q, k, v], 2), self.sp).unbind(2)
            out = FusedAttention.apply(q, k, v, False)
            out = seqp.heads_to_tokens(out[:, :, None], self.sp)[:, :, 0]
        return self.proj(out.reshape(B, N, -1))

    def temporal_resident(self, x_BTSC: torch.Tensor) -> torch.Tensor:
        """Causal attention over T at every (b, s) site of x: (B, T, S, C),
        without leaving that layout. q, k, v stay (B, T, S, H, D) views of
        the (B, T, S, 3, H, D) projection (q and k normalised first under
        qk_norm); K5''s out (B, T, S, H, D) feeds `proj` as (B, T, S, C)."""
        B, T, S, _ = x_BTSC.shape
        qkv = self.qkv(x_BTSC).view(B, T, S, 3, self.num_heads, self.head_dim)
        q = k = None
        if self.norm is not None:
            q = self.norm(qkv[..., 0, :, :]).to(self.dtype)
            k = self.norm(qkv[..., 1, :, :]).to(self.dtype)
        out = FusedTemporalResident.apply(qkv, self.scale, q, k)
        return self.proj(out.view(B, T, S, -1))

    def decode_step(self, x_t: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, t: int):
        """Causal attention for timestep t against a read-only KV cache.

        x_t: (N, 1, C); k_cache/v_cache: (N, T_max, H, D) holding timesteps
        < t (slots >= t are ignored). Returns (out (N, 1, C), k_t, v_t) with
        this timestep's (N, 1, H, D) slices for the caller to write or drop.

        The cache is never concatenated with k_t/v_t or copied: the scores
        over the cache and over the current position are taken separately
        and one softmax runs over the joined (N, H, T_max + 1) scores. To read
        the (N, T_max, H*D) cache rows in place with one batched product, q
        enters as a block-diagonal (N, H, H*D) matrix (row h holds q[:, h]
        in head h's columns); the PV product likewise yields (N, H, H*D), of
        which the diagonal blocks are each head's output.
        """
        N = x_t.shape[0]
        H, D = self.num_heads, self.head_dim
        q, k, v = self._qkv(x_t)  # (N, 1, H, D)
        t_max = k_cache.shape[1]
        eye = torch.eye(H, dtype=q.dtype, device=q.device)
        q_bd = (eye[None, :, :, None] * q[:, 0, None]).reshape(N, H, H * D)
        scores = _bmm_f32(q_bd, k_cache.reshape(N, t_max, H * D).transpose(1, 2))
        stale = torch.arange(t_max, device=q.device) >= t
        scores = scores.masked_fill(stale, NEG_INF)
        score_t = (q.float() * k.float()).sum(-1).transpose(1, 2)  # (N, H, 1)
        probs = torch.softmax(torch.cat([scores, score_t], -1), -1).to(self.dtype)
        pv = _bmm_f32(probs[..., :t_max], v_cache.reshape(N, t_max, H * D))
        heads = torch.arange(H, device=q.device)
        out = pv.view(N, H, H, D)[:, heads, heads]  # (N, H, D)
        out = out + probs[..., t_max:].float() * v[:, 0].float()
        return self.proj(out.to(self.dtype).reshape(N, 1, H * D)), k, v

    def decode_window(self, x: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, t0: int):
        """Causal attention for the F timesteps [t0, t0+F) against a
        read-only KV cache holding timesteps < t0.

        x: (N, F, C); k_cache/v_cache: (N, T_max, H, D). Returns (out (N, F,
        C), k_w, v_w) with the window's (N, F, H, D) slices for the caller
        to write. Cache slots below t0 are valid, window slot j sees window
        slots <= j; scores and softmax in fp32, probs cast to the compute
        dtype before the p v product.
        """
        N, F_, _ = x.shape
        q, k, v = self._qkv(x)  # (N, F, H, D)
        t_max = k_cache.shape[1]
        k_all = torch.cat([k_cache, k], 1)  # (N, T_max + F, H, D)
        v_all = torch.cat([v_cache, v], 1)
        col = torch.arange(t_max + F_, device=x.device)[None, :]
        row = torch.arange(F_, device=x.device)[:, None]
        valid = torch.where(col < t_max, col < t0, col - t_max <= row)
        scores = torch.einsum("bnhd,bmhd->bhnm", q.float(), k_all.float())
        probs = torch.softmax(scores.masked_fill(~valid, NEG_INF), -1).to(self.dtype)
        out = torch.einsum("bhnm,bmhd->bnhd", probs, v_all.to(self.dtype))
        return self.proj(out.reshape(N, F_, -1)), k, v
