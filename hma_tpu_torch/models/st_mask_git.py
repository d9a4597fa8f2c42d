"""STMaskGIT: discrete spatiotemporal masked-autoregressive video model
(counterpart of hma_tpu/models/st_mask_git.py).

Ported: `compute_logits` (full forward), the training loss (`forward`,
`compute_video_loss_and_acc`, `smoothed_ce_floor`), `init_cache` and
`frame_logits` (one frame against the temporal KV cache). The pooled
action readout and action loss (`jointly_predict_actions`) and
`window_logits` are not ported yet.

Parameters are fp32 and are cast to the compute `dtype` at use, as in the
JAX model, so a converted `hma_tpu` tree (`convert.params_from_jax`) loads
with `load_state_dict` and gives the same numbers.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from hma_tpu_torch.config import GenieConfig
from hma_tpu_torch.models.action_stems import (
    ActionStemMLP,
    DomainDense,
    build_action_stat_tables,
    normalize_actions,
)
from hma_tpu_torch.models.attention import Dense
from hma_tpu_torch.models.factorization import FactorizedEmbedding, factorize_labels
from hma_tpu_torch.models.st_transformer import STTransformerDecoder

LABEL_SMOOTHING = 0.01


def smoothed_ce_floor(num_factored_vocabs: int, factored_vocab_size: int,
                      smooth: float = LABEL_SMOOTHING) -> float:
    """Analytic minimum of the label-smoothed factored CE: the entropy of
    q = (1 - eps) onehot + eps / K, summed over the factors (~0.2363 for
    the 2 x 512 card). A model at acc 1.0 never goes below it."""
    eps, K = smooth, factored_vocab_size
    q_correct = (1.0 - eps) + eps / K
    q_other = eps / K
    h = -(q_correct * np.log(q_correct) + (K - 1) * q_other * np.log(q_other))
    return float(num_factored_vocabs * h)


class STMaskGIT(nn.Module):
    """Discrete masked-transformer world model.

    `remat` checkpoints every STBlock in a forward that records gradients
    (`STTransformerDecoder`; only the "full" `remat_policy`)."""

    def __init__(self, config: GenieConfig, dtype=torch.bfloat16, device="cuda",
                 generator: Optional[torch.Generator] = None, remat: bool = False,
                 remat_policy: str = "full"):
        super().__init__()
        cfg = config
        if cfg.jointly_predict_actions:
            raise NotImplementedError(
                "jointly_predict_actions needs ActionReadout, not ported yet "
                "(ROADMAP.md Queue A)")
        self.config = cfg
        self.dtype = dtype
        self.mask_token_id = cfg.image_vocab_size
        self.decoder = STTransformerDecoder(
            cfg.num_layers, num_heads=cfg.num_heads, d_model=cfg.d_model,
            qkv_bias=cfg.qkv_bias, proj_bias=cfg.proj_bias, qk_norm=cfg.qk_norm,
            use_mup=cfg.use_mup, mlp_ratio=cfg.mlp_ratio, mlp_bias=cfg.mlp_bias,
            action_processing=cfg.action_network, num_domains=cfg.num_domains,
            dtype=dtype, device=device, remat=remat, remat_policy=remat_policy)
        self.pos_embed_TSC = nn.Parameter(torch.zeros(
            1, cfg.T, cfg.S + cfg.action_token_size, cfg.d_model, device=device))
        self.token_embed = FactorizedEmbedding(
            cfg.factored_vocab_size, cfg.num_factored_vocabs, cfg.d_model,
            self.mask_token_id, dtype, device)
        self.out_x_proj = Dense(cfg.d_model,
                                cfg.factored_vocab_size * cfg.num_factored_vocabs,
                                True, dtype, device)
        # muP readout multipliers folded into one constant (base width 256)
        self.readout_scale = (256.0 / cfg.d_model) if cfg.use_mup else 1.0
        self.action_mask_tokens = nn.Parameter(
            torch.zeros(1, cfg.T, 1, cfg.d_model, device=device))
        if cfg.num_domains > 0 and (cfg.use_actions or cfg.init_actions):
            mean, std = build_action_stat_tables(cfg.d_actions, cfg.action_stats,
                                                 cfg.max_d_action)
            self.register_buffer("action_mean_table", torch.from_numpy(mean).to(device),
                                 persistent=False)
            self.register_buffer("action_std_table", torch.from_numpy(std).to(device),
                                 persistent=False)
            self.action_stem = ActionStemMLP(cfg.num_domains, cfg.max_d_action,
                                             cfg.d_model, dtype, device)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Random init with the JAX model's distributions: decoder linears
        xavier-uniform(gain 0.1), readout torch's Linear default, domain
        tables xavier-uniform over flax's fans (gain 0.01 stem / 0.1
        modulate), embeddings N(0, 1), zero biases and zero learned tokens."""
        def uniform(p, bound):
            p.uniform_(-bound, bound, generator=generator)

        for name, mod in self.named_modules():
            if isinstance(mod, Dense):
                fan_out, fan_in = mod.weight.shape
                if name == "out_x_proj":
                    uniform(mod.weight, math.sqrt(1.0 / fan_in))
                else:
                    uniform(mod.weight, 0.1 * math.sqrt(6.0 / (fan_in + fan_out)))
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, DomainDense):
                nd, fan_in, fan_out = mod.kernel.shape
                uniform(mod.kernel, mod.init_gain * math.sqrt(
                    6.0 / (nd * fan_in + nd * fan_out)))
            elif isinstance(mod, nn.Embedding):
                mod.weight.normal_(generator=generator)

    # ------------------------------------------------------------------

    def _action_embedding(self, action_ids: torch.Tensor,
                          domain_id: int) -> torch.Tensor:
        """Raw (B, T, max_da) actions -> (B, T, d_model) stem output."""
        action_ids = normalize_actions(action_ids, domain_id,
                                       self.action_mean_table, self.action_std_table)
        return self.action_stem(action_ids.to(self.dtype), domain_id)

    def compute_logits(self, x_TS: torch.Tensor,
                       action_ids: Optional[torch.Tensor] = None,
                       domain_id: int = 0):
        """Full-stack forward.

        x_TS: (B, T, S) int token ids (mask_token_id where masked);
        action_ids: (B, T, max_d_action) fp32 raw actions, or None.
        Returns (logits (B, nv*fv, T, h, w) fp32, None).
        """
        cfg = self.config
        B, T, S = x_TS.shape
        h = w = math.isqrt(S)
        x_TSC = self.token_embed(x_TS)
        action_emb = None
        if action_ids is not None and cfg.num_domains > 0:
            action_emb = self._action_embedding(action_ids, domain_id)
            if "concat" in cfg.action_network:
                cond = action_emb[:, :T, None, :].expand(
                    B, T, cfg.action_token_size, cfg.d_model)
                x_TSC = torch.cat([x_TSC, cond.to(self.dtype)], dim=2)
        S_tot = x_TSC.shape[2]
        x_TSC = x_TSC + self.pos_embed_TSC[:, :T, :S_tot].to(self.dtype)
        x_TSC = self.decoder(x_TSC, action_emb, domain_id)
        logits = self.out_x_proj(x_TSC[:, :, :S] * self.readout_scale).float()
        return logits.reshape(B, T, h, w, -1).permute(0, 4, 1, 2, 3), None

    def forward(self, input_ids: torch.Tensor, labels: torch.Tensor,
                action_ids: Optional[torch.Tensor] = None, domain_id: int = 0):
        """Masked-token factored cross-entropy and exact-token accuracy.

        input_ids/labels: (B, T, S) int ids (mask_token_id where masked in
        input_ids); the loss runs over the masked tokens of frames 1..T-1.
        Returns {"loss", "acc"}, 0-d fp32 tensors.
        """
        B, T, S = input_ids.shape
        h = w = math.isqrt(S)
        logits_CTHW, _ = self.compute_logits(input_ids, action_ids, domain_id)
        relevant = input_ids.reshape(B, T, h, w)[:, 1:] == self.mask_token_id
        loss, acc = self.compute_video_loss_and_acc(
            logits_CTHW, labels.reshape(B, T, h, w), relevant)
        return {"loss": loss, "acc": acc}

    def compute_video_loss_and_acc(self, logits_CTHW: torch.Tensor,
                                   targets_THW: torch.Tensor,
                                   relevant_mask_THW: torch.Tensor):
        """Factored CE with label smoothing 0.01 and exact-token accuracy,
        averaged over the relevant (masked) tokens of frames 1..; logits
        (B, nv*fv, T, H, W), targets (B, T, H, W), mask (B, T-1, H, W)."""
        cfg = self.config
        fv, nv = cfg.factored_vocab_size, cfg.num_factored_vocabs
        logits = logits_CTHW[:, :, 1:]
        targets = targets_THW[:, 1:]
        B, _, Tm1, H, W = logits.shape
        fl = logits.reshape(B, nv, fv, Tm1, H, W)
        ft = factorize_labels(targets.long(), nv, fv)  # (B, nv, T-1, H, W)
        logp = F.log_softmax(fl.float(), dim=2)
        onehot_ll = logp.gather(2, ft[:, :, None])[:, :, 0]
        smooth = LABEL_SMOOTHING
        ce = -(1 - smooth) * onehot_ll - (smooth / fv) * logp.sum(2)
        loss_THW = ce.sum(1)  # over the factored vocabs
        acc_THW = (fl.argmax(2) == ft).all(1)
        m = relevant_mask_THW.float()
        num = torch.clamp(m.sum(), min=1.0)
        return (loss_THW * m).sum() / num, (acc_THW * m).sum() / num

    def init_cache(self, batch_size: int, with_actions: bool = True):
        """Zeroed temporal KV caches, (L, B*S_tot, T, H, Dh) each."""
        cfg = self.config
        concat = (with_actions and "concat" in cfg.action_network
                  and cfg.num_domains > 0)
        S_tot = cfg.S + (cfg.action_token_size if concat else 0)
        shape = (cfg.num_layers, batch_size * S_tot, cfg.T, cfg.num_heads,
                 cfg.d_model // cfg.num_heads)
        device = self.pos_embed_TSC.device
        return (torch.zeros(shape, dtype=self.dtype, device=device),
                torch.zeros(shape, dtype=self.dtype, device=device))

    def frame_logits(self, tokens_S: torch.Tensor, t: int, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, action_ids: Optional[torch.Tensor] = None,
                     domain_id: int = 0, update_cache: bool = True):
        """Forward for the single frame t against the temporal KV cache.

        tokens_S: (B, S) ids of frame t. Returns (logits (B, S, nv, fv)
        fp32, k_cache, v_cache); with update_cache the caches' slot t is
        written in place, otherwise the caches are left bit-identical.
        Equal to the full forward's frame t when the caches hold frames < t.
        """
        cfg = self.config
        B, S = tokens_S.shape
        x_SC = self.token_embed(tokens_S)
        action_emb = None
        if action_ids is not None and cfg.num_domains > 0:
            action_emb = self._action_embedding(action_ids, domain_id)
            if "concat" in cfg.action_network:
                cond = action_emb[:, t, None, :].expand(
                    B, cfg.action_token_size, cfg.d_model)
                x_SC = torch.cat([x_SC, cond.to(self.dtype)], dim=1)
        S_tot = x_SC.shape[1]
        x_SC = x_SC + self.pos_embed_TSC[:, t, :S_tot].to(self.dtype)
        x_SC, k_cache, v_cache = self.decoder.frame_step(
            x_SC, t, k_cache, v_cache, action_emb, domain_id, update_cache)
        logits = self.out_x_proj(x_SC[:, :S] * self.readout_scale).float()
        return (logits.reshape(B, S, cfg.num_factored_vocabs,
                               cfg.factored_vocab_size), k_cache, v_cache)
