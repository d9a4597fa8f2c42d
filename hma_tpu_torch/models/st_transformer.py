"""Spatiotemporal factorized transformer
(counterpart of hma_tpu/models/st_transformer.py).

Per block: bidirectional spatial self-attention over the S (+ action)
tokens of each frame, per-domain action injection, causal temporal
self-attention over T at each spatial site, MLP. Only the default
`temporal_layout="transpose"` is ported; `window_step`, remat and
`scan_layers` are not (the converter unstacks a `layers_scan` tree).

With `qk_norm=True`, norm1/norm2 are Identity, a quirk kept from the
reference: the only normalisation is the qk-LayerNorm inside attention.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from hma_tpu_torch.models.action_stems import DomainModulate
from hma_tpu_torch.models.attention import Dense, LayerNorm, SelfAttention


class Mlp(nn.Module):
    """Dense -> exact GELU -> Dense."""

    def __init__(self, d_model: int, mlp_ratio: float = 4.0, mlp_bias: bool = True,
                 dtype=torch.bfloat16, device="cuda"):
        super().__init__()
        hidden = int(d_model * mlp_ratio)
        self.fc1 = Dense(d_model, hidden, mlp_bias, dtype, device)
        self.fc2 = Dense(hidden, d_model, mlp_bias, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class STBlock(nn.Module):
    """One spatiotemporal block."""

    def __init__(self, num_heads: int, d_model: int, qkv_bias: bool = False,
                 proj_bias: bool = True, qk_norm: bool = True, use_mup: bool = True,
                 mlp_ratio: float = 4.0, mlp_bias: bool = True,
                 action_processing: str = "mlp", num_domains: int = 0,
                 dtype=torch.bfloat16, device="cuda"):
        super().__init__()
        if num_domains > 0 and "cross_attention" in action_processing:
            raise NotImplementedError(
                "cross_attention action injection is not ported yet "
                "(ROADMAP.md Queue A: DomainCrossAttention)")
        attn_kw = dict(num_heads=num_heads, d_model=d_model, qkv_bias=qkv_bias,
                       proj_bias=proj_bias, qk_norm=qk_norm, use_mup=use_mup,
                       dtype=dtype, device=device)
        self.dtype = dtype
        self.action_processing = action_processing
        self.spatial_attn = SelfAttention(**attn_kw)
        self.temporal_attn = SelfAttention(**attn_kw)
        self.mlp = Mlp(d_model, mlp_ratio, mlp_bias, dtype, device)
        self.norm1 = None if qk_norm else LayerNorm(d_model, device=device)
        self.norm2 = None if qk_norm else LayerNorm(d_model, device=device)
        self.action_projector = (
            DomainModulate(num_domains, d_model, dtype, device)
            if num_domains > 0 and "modulate" in action_processing else None)
        self.inject = num_domains > 0

    def _pre(self, norm: Optional[LayerNorm], x: torch.Tensor) -> torch.Tensor:
        return x if norm is None else norm(x).to(self.dtype)

    def _inject(self, x: torch.Tensor, cond: torch.Tensor,
                domain_id: int) -> torch.Tensor:
        """Add the action conditioning; cond broadcasts against x."""
        if "mlp" in self.action_processing:
            return x + cond
        if self.action_projector is not None:
            return x + self.action_projector(x, cond, domain_id)
        return x

    def forward(self, x_TSC: torch.Tensor, action_emb: Optional[torch.Tensor] = None,
                domain_id: int = 0) -> torch.Tensor:
        """Full forward. x_TSC: (B, T, S, C); action_emb: (B, T, C)."""
        B, T, S, C = x_TSC.shape
        x_SC = x_TSC.reshape(B * T, S, C)
        x_SC = x_SC + self.spatial_attn(self._pre(self.norm1, x_SC))
        x_BSTC = x_SC.reshape(B, T, S, C).transpose(1, 2)  # (B, S, T, C)
        if action_emb is not None and self.inject:
            x_BSTC = self._inject(x_BSTC, action_emb[:, None, :T], domain_id)
        x_TC = x_BSTC.reshape(B * S, T, C)
        x_TC = x_TC + self.temporal_attn(x_TC, causal=True)
        x_TC = x_TC + self.mlp(self._pre(self.norm2, x_TC))
        return x_TC.reshape(B, S, T, C).transpose(1, 2)

    def frame_step(self, x_SC: torch.Tensor, t: int, k_cache: torch.Tensor,
                   v_cache: torch.Tensor, action_emb: Optional[torch.Tensor] = None,
                   domain_id: int = 0):
        """Single-frame decode of frame t. x_SC: (B, S, C); k/v_cache:
        (B*S, T_max, H, D), read-only. Returns (x_SC, k_t, v_t)."""
        B, S, C = x_SC.shape
        x_SC = x_SC + self.spatial_attn(self._pre(self.norm1, x_SC))
        if action_emb is not None and self.inject:
            x_SC = self._inject(x_SC, action_emb[:, t:t + 1], domain_id)
        x_TC = x_SC.reshape(B * S, 1, C)
        attn_out, k_t, v_t = self.temporal_attn.decode_step(x_TC, k_cache, v_cache, t)
        x_TC = x_TC + attn_out
        x_TC = x_TC + self.mlp(self._pre(self.norm2, x_TC))
        return x_TC.reshape(B, S, C), k_t, v_t


class STTransformerDecoder(nn.Module):
    """Stack of STBlocks (loop layout: `layers.<i>`)."""

    def __init__(self, num_layers: int, **block_kw):
        super().__init__()
        self.layers = nn.ModuleList(STBlock(**block_kw) for _ in range(num_layers))

    def forward(self, x_TSC: torch.Tensor, action_emb: Optional[torch.Tensor] = None,
                domain_id: int = 0) -> torch.Tensor:
        for layer in self.layers:
            x_TSC = layer(x_TSC, action_emb, domain_id)
        return x_TSC

    def frame_step(self, x_SC: torch.Tensor, t: int, k_cache: torch.Tensor,
                   v_cache: torch.Tensor, action_emb: Optional[torch.Tensor] = None,
                   domain_id: int = 0, update_cache: bool = True):
        """x_SC: (B, S, C); k/v_cache: (L, B*S, T_max, H, D).

        With update_cache, each layer's frame-t KV slice is written in place
        into slot t of the caches; otherwise the caches are not touched.
        Returns (x_SC, k_cache, v_cache), the caches being the same tensors.
        """
        for i, layer in enumerate(self.layers):
            x_SC, k_t, v_t = layer.frame_step(x_SC, t, k_cache[i], v_cache[i],
                                              action_emb, domain_id)
            if update_cache:
                k_cache[i, :, t] = k_t[:, 0]
                v_cache[i, :, t] = v_t[:, 0]
        return x_SC, k_cache, v_cache
