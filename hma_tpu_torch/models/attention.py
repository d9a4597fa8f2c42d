"""Attention primitives for the ST transformer
(counterpart of hma_tpu/models/attention.py).

- `Dense` and `LayerNorm` reproduce flax's `nn.Dense` (fp32 params cast to
  the compute dtype at use) and `nn.LayerNorm` (fp32, E[x^2] - E[x]^2
  variance) so converted weights give the same numbers.
- `SelfAttention.forward` sends the bidirectional (spatial) pass to K1'
  (`ops.fused_attention`) and the causal (temporal) pass to K3'
  (`ops.temporal_attention`). Both wrappers launch their CUDA kernel for a
  CUDA tensor and use their plain version only for a CPU tensor.
- `SelfAttention.decode_step` is one timestep against a read-only temporal
  KV cache; it is plain PyTorch, as its JAX counterpart is plain XLA.

`temporal_resident`, `decode_window` and `CrossAttention` are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from hma_tpu_torch.ops.fused_attention import fused_attention, fused_attention_plain
from hma_tpu_torch.ops.temporal_attention import fused_temporal_attention

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)  # decode_step's mask value


class Dense(nn.Linear):
    """nn.Linear whose fp32 parameters are cast to `dtype` at use."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype=torch.bfloat16, device="cuda"):
        super().__init__(in_features, out_features, bias=bias, device=device)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), b)


class LayerNorm(nn.Module):
    """flax `nn.LayerNorm(dtype=float32)`: var = E[x^2] - E[x]^2 in fp32."""

    def __init__(self, features: int, eps: float = 1e-5, device="cuda"):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean, min=0.0)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


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

    def _qkv(self, x: torch.Tensor):
        B, N, _ = x.shape
        qkv = self.qkv(x).view(B, N, 3, self.num_heads, self.head_dim)
        q, k, v = qkv.unbind(2)
        if self.norm is not None:
            q = self.norm(q).to(self.dtype)
            k = self.norm(k).to(self.dtype)
        return q * self.scale, k, v

    def forward(self, x: torch.Tensor, causal: bool = False) -> torch.Tensor:
        """Full pass over x: (B, N, C); causal runs K3', otherwise K1'."""
        B, N, C = x.shape
        q, k, v = self._qkv(x)
        if causal:
            out, _ = fused_temporal_attention(q, k, v)
        else:
            out, _ = fused_attention(q, k, v)
        return self.proj(out.reshape(B, N, C))

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
