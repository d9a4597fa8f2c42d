"""STMAR: continuous spatiotemporal masked-autoregressive model with a
per-token diffusion head (counterpart of hma_tpu/models/st_mar.py).

The same ST-transformer trunk as STMaskGIT, over continuous VAE latents
(B, T, h, w, C): masked positions hold a learned latent mask token, frames
are patchified (patch_size p), embedded linearly, and the trunk's per-token
outputs condition a `DiffLoss` head that models each patch's latent
distribution. Ported: the training loss (`forward`: masked diffusion loss
over the patch rows, the action-suffix mask and the action head's loss on
`jointly_predict_actions` cards), `compute_latents` (full forward),
`init_cache` and `frame_latents` (one frame against the temporal KV cache),
`sample_tokens` and `sample_actions` (the head's sampler).

Training draws (the action-suffix start, the diffusion timesteps and noise,
the trunk's dropout) come from explicit generators or are handed in as
tensors (`forward`'s `draws`), as `hma_tpu` takes them from its
"action_drop", "diffusion" and "dropout" keys.

Parameters are fp32 and are cast to the compute `dtype` at use, so a
converted `hma_tpu` tree (`convert.params_from_jax`) loads with
`load_state_dict` and gives the same numbers.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from hma_tpu_torch.config import DiffusionGenieConfig
from hma_tpu_torch.models.action_stems import (
    ActionStemMLP,
    DomainDense,
    build_action_stat_tables,
    normalize_actions,
)
from hma_tpu_torch.models.attention import Dense, LayerNorm
from hma_tpu_torch.models.diffloss import DiffLoss
from hma_tpu_torch.models.st_transformer import STTransformerDecoder
from hma_tpu_torch.parallel.distributed import draw_rows
from hma_tpu_torch.parallel.sequence_parallel import local_count


def patchify(x: torch.Tensor, p: int) -> torch.Tensor:
    """(B, T, H, W, C) -> (B, T, H/p, W/p, C*p*p), C fastest within a patch."""
    B, T, H, W, C = x.shape
    x = x.reshape(B, T, H // p, p, W // p, p, C).permute(0, 1, 2, 4, 3, 5, 6)
    return x.reshape(B, T, H // p, W // p, C * p * p)


def unpatchify(x: torch.Tensor, p: int, c: int) -> torch.Tensor:
    """Inverse of `patchify`."""
    B, T, H, W, _ = x.shape
    x = x.reshape(B, T, H, W, p, p, c).permute(0, 1, 2, 4, 3, 5, 6)
    return x.reshape(B, T, H * p, W * p, c)


class STMAR(nn.Module):
    """Continuous masked-AR world model with diffusion decoding."""

    def __init__(self, config: DiffusionGenieConfig, dtype=torch.bfloat16,
                 device="cuda", generator: Optional[torch.Generator] = None,
                 remat: bool = False, remat_policy: str = "full",
                 temporal_layout: str = "transpose"):
        super().__init__()
        cfg = config
        self.config = cfg
        self.dtype = dtype
        self.patch_dim = cfg.vae_embed_dim * cfg.patch_size**2
        self.seq_len = cfg.S // cfg.patch_size**2
        self.decoder = STTransformerDecoder(
            cfg.num_layers, num_heads=cfg.num_heads, d_model=cfg.d_model,
            qkv_bias=cfg.qkv_bias, proj_bias=cfg.proj_bias, qk_norm=cfg.qk_norm,
            use_mup=cfg.use_mup, mlp_ratio=cfg.mlp_ratio, mlp_bias=cfg.mlp_bias,
            mlp_drop=cfg.mlp_drop, action_processing=cfg.action_network,
            num_domains=cfg.num_domains, temporal_layout=temporal_layout,
            cross_attention_compat=cfg.cross_attention_compat,
            dtype=dtype, device=device, remat=remat, remat_policy=remat_policy)
        self.pos_embed_TSC = nn.Parameter(torch.zeros(
            1, cfg.T, self.seq_len + cfg.action_token_size, cfg.d_model, device=device))
        self.diffusion_pos_embed_learned = nn.Parameter(torch.zeros(
            1, self.seq_len * cfg.T, cfg.d_model, device=device))
        self.mask_token = nn.Parameter(torch.zeros(1, 1, cfg.vae_embed_dim, device=device))
        self.action_mask_tokens = nn.Parameter(
            torch.zeros(1, cfg.T, 1, cfg.d_model, device=device))
        self.token_embed = Dense(self.patch_dim, cfg.d_model, False, dtype, device)
        self.out_x_proj = Dense(cfg.d_model, cfg.d_model, True, dtype, device)
        # muP readout multipliers folded into one constant (base width 256)
        self.readout_scale = (256.0 / cfg.d_model) if cfg.use_mup else 1.0
        self.decoder_norm = LayerNorm(cfg.d_model, eps=1e-6, device=device)
        self.z_proj_ln = LayerNorm(cfg.d_model, eps=1e-6, device=device)
        self.diffloss = DiffLoss(self.patch_dim, cfg.d_model, cfg.diffloss_d,
                                 cfg.diffloss_w, cfg.num_sampling_steps,
                                 dtype=dtype, device=device)
        if cfg.num_domains > 0 and (cfg.use_actions or cfg.init_actions):
            mean, std = build_action_stat_tables(cfg.d_actions, cfg.action_stats,
                                                 cfg.max_d_action)
            self.register_buffer("action_mean_table", torch.from_numpy(mean).to(device),
                                 persistent=False)
            self.register_buffer("action_std_table", torch.from_numpy(std).to(device),
                                 persistent=False)
            self.action_stem = ActionStemMLP(cfg.num_domains, cfg.max_d_action,
                                             cfg.d_model, dtype, device)
            if cfg.jointly_predict_actions:
                self.action_diff_loss = DiffLoss(
                    cfg.max_d_action, cfg.d_model, cfg.diffloss_d, cfg.diffloss_w,
                    cfg.num_sampling_steps, num_domains=cfg.num_domains,
                    dtype=dtype, device=device)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Random init with the JAX model's distributions: trunk linears
        xavier-uniform(gain 0.1), token_embed / out_x_proj / the diffusion
        position embedding N(0, 0.02), domain tables xavier-uniform over
        flax's fans, the heads as `DiffLoss.reset_parameters`, zero biases
        and zero learned tokens."""
        if self.pos_embed_TSC.is_meta:
            return  # shapes only: nothing to draw
        for name, mod in self.named_modules():
            if name.split(".")[0] in ("diffloss", "action_diff_loss"):
                continue  # the heads, below
            if isinstance(mod, Dense):
                fan_out, fan_in = mod.weight.shape
                if name in ("token_embed", "out_x_proj"):
                    mod.weight.normal_(0.0, 0.02, generator=generator)
                else:
                    b = 0.1 * math.sqrt(6.0 / (fan_in + fan_out))
                    mod.weight.uniform_(-b, b, generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, DomainDense):
                mod.reset_parameters(generator)
        self.diffusion_pos_embed_learned.normal_(0.0, 0.02, generator=generator)
        self.diffloss.reset_parameters(generator)
        if hasattr(self, "action_diff_loss"):
            self.action_diff_loss.reset_parameters(generator)

    # ------------------------------------------------------------------

    def _action_embedding(self, action_ids: torch.Tensor, domain_id: int,
                          skip_normalization: bool = False) -> torch.Tensor:
        """Raw (B, T, max_da) actions -> (B, T, d_model) stem output."""
        if not skip_normalization:
            action_ids = normalize_actions(action_ids, domain_id,
                                           self.action_mean_table, self.action_std_table)
        return self.action_stem(action_ids.to(self.dtype), domain_id)

    def _readout(self, x_states: torch.Tensor) -> torch.Tensor:
        return self.decoder_norm(self.out_x_proj(x_states * self.readout_scale).float())

    def compute_latents(self, x_TSC_in: torch.Tensor,
                        action_ids: Optional[torch.Tensor] = None, domain_id: int = 0,
                        action_mask: Optional[torch.Tensor] = None,
                        skip_normalization: bool = False, dropout=None):
        """Full-stack forward. x_TSC_in: patchified latents (B, T, h_, w_,
        patch_dim) or (B, T, S_p, patch_dim); action_mask: optional
        (B, T, 1, 1), 1 where the action tokens are replaced by the learned
        action mask tokens (`jointly_predict_actions` cards); dropout: the
        trunk's MLP dropout (`STTransformerDecoder.forward`), None in every
        forward but training's.

        Returns (z (B, T, S_p, d_model) fp32, pooled action latents
        (B, T, d_model) fp32 or None).
        """
        cfg = self.config
        if x_TSC_in.ndim == 5:
            x_TSC_in = x_TSC_in.flatten(2, 3)
        B, T, S, _ = x_TSC_in.shape
        x_TSC = self.token_embed(x_TSC_in)
        ats = cfg.action_token_size
        action_emb = None
        if action_ids is not None and cfg.num_domains > 0:
            action_emb = self._action_embedding(action_ids, domain_id, skip_normalization)
            if "concat" in cfg.action_network:
                cond = action_emb[:, :T, None, :].expand(B, T, ats, cfg.d_model).to(self.dtype)
                if action_mask is not None and cfg.jointly_predict_actions:
                    mask_tok = self.action_mask_tokens[:, :T].to(self.dtype)
                    m = action_mask[:, :T].to(self.dtype)
                    cond = m * mask_tok + (1 - m) * cond
                x_TSC = torch.cat([x_TSC, cond], dim=2)
        elif cfg.jointly_predict_actions:
            cond = self.action_mask_tokens[:, :T].to(self.dtype).expand(
                B, T, ats, cfg.d_model)
            x_TSC = torch.cat([x_TSC, cond], dim=2)

        S_tot = x_TSC.shape[2]
        x_TSC = self.z_proj_ln(
            x_TSC + self.pos_embed_TSC[:, :T, :S_tot].to(self.dtype)).to(self.dtype)
        x_TSC = self.decoder(x_TSC, action_emb, domain_id, dropout)

        action_latents = None
        if cfg.jointly_predict_actions:
            action_latents = x_TSC[:, :, -ats:].mean(dim=2).float()
        z = self._readout(x_TSC[:, :, :S])
        dpe = self.diffusion_pos_embed_learned.view(1, cfg.T, self.seq_len, cfg.d_model)
        return z + dpe[:, :T, :S], action_latents

    def forward(self, input_ids: torch.Tensor, labels: torch.Tensor,
                action_ids: Optional[torch.Tensor] = None, domain_id: int = 0,
                masked_tokens_indicator: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, dropout=None,
                draws: Optional[dict] = None, group=None) -> dict:
        """Diffusion training loss over the masked patch rows.

        input_ids/labels: (B, T, h, w, C) float latents (already times
        SVD_SCALE); masked_tokens_indicator: (B, T, h, w), > 0 where a
        latent is masked. dropout: the trunk's MLP dropout (a generator or
        per-block masks; None is `hma_tpu`'s deterministic forward).

        Draws, in this order from `generator` unless `draws` holds them:
        "action_t0" (B,) the first masked action frame (joint cards with
        actions), "t" (R,) and "noise" (R, patch_dim) for the R = rows x
        diffusion_batch_mul patch rows, "action_t" and "action_noise" for
        the action head's rows.

        Returns {"loss", "acc" (0)} and, on joint cards with actions,
        "action_loss" and "actions" (the pooled action latents). group: a
        data-parallel process group holding the rest of the global batch;
        the masked means' counts are then the global batch's.
        """
        cfg = self.config
        B, T = input_ids.shape[:2]
        if masked_tokens_indicator is None:
            raise ValueError("STMAR training requires masked_tokens_indicator")
        draws = draws or {}
        dev = input_ids.device
        mask = masked_tokens_indicator
        x = torch.where(mask[..., None] > 0, self.mask_token[None].to(input_ids.dtype),
                        input_ids)
        x = patchify(x, cfg.patch_size)

        action_mask = None
        if action_ids is not None and cfg.jointly_predict_actions:
            t0 = draws.get("action_t0")
            if t0 is None:
                t0 = draw_rows(lambda m, g: torch.randint(0, T, (m,), generator=g,
                                                          device=dev), B, generator)
            action_mask = (torch.arange(T, device=dev)[None, :] >= t0.reshape(B, 1))
            action_mask = action_mask.to(self.dtype)[..., None, None]

        # the class's function: under fsdp the instance's compute_latents is
        # FSDP2's gathering wrapper (parallel.mesh.shard_model), which must
        # not nest inside forward's (it would reduce the root's grads before
        # mask_token's arrives)
        z, action_latents = type(self).compute_latents(self, x, action_ids, domain_id,
                                                       action_mask, dropout=dropout)
        target = patchify(labels, cfg.patch_size)
        patch_mask = (patchify(mask[..., None].float(), cfg.patch_size).sum(-1) > 0).float()
        rows_z = z.reshape(-1, cfg.d_model)
        rows_t = target.reshape(-1, self.patch_dim).float()
        rows_m = patch_mask.reshape(-1)
        mul = cfg.diffusion_batch_mul  # torch's .repeat tiles along rows, as jnp.tile
        if mul > 1:
            rows_z, rows_t, rows_m = rows_z.repeat(mul, 1), rows_t.repeat(mul, 1), rows_m.repeat(mul)
        loss = self.diffloss.loss(rows_t, rows_z, rows_m, generator=generator,
                                  t=draws.get("t"), noise=draws.get("noise"), group=group,
                                  blocks=mul)
        out = {"loss": loss, "acc": torch.zeros((), device=dev)}
        if action_latents is not None and action_ids is not None:
            dim_mask = (torch.arange(cfg.max_d_action, device=dev)
                        < cfg.d_actions[domain_id]).float()
            a_rows_z = action_latents.reshape(-1, cfg.d_model)
            a_rows_t = action_ids.reshape(-1, cfg.max_d_action).float()
            a_rows_m = action_mask[..., 0, 0].reshape(-1)
            if mul > 1:
                a_rows_z, a_rows_t = a_rows_z.repeat(mul, 1), a_rows_t.repeat(mul, 1)
                a_rows_m = a_rows_m.repeat(mul)
            out["action_loss"] = self.action_diff_loss.loss(
                a_rows_t, a_rows_z, a_rows_m, domain_id, dim_mask, generator,
                t=draws.get("action_t"), noise=draws.get("action_noise"), group=group,
                blocks=mul)
            out["actions"] = action_latents
        return out

    # ------------------------------------------------------------------
    # Incremental (KV-cached) path
    # ------------------------------------------------------------------

    def init_cache(self, batch_size: int, with_actions: bool = True):
        """Zeroed temporal KV caches, (L, B*S_tot, T, H, Dh) each (a rank's
        S_tot / sp sites of each row under sp, its H / tp heads under tp)."""
        cfg = self.config
        concat = (with_actions and "concat" in cfg.action_network
                  and cfg.num_domains > 0) or cfg.jointly_predict_actions
        S_tot = self.seq_len + (cfg.action_token_size if concat else 0)
        # the heads this rank attends with (H / tp under tensor parallelism)
        heads = self.decoder.layers[0].temporal_attn.num_heads
        sites = batch_size * local_count(S_tot, self.decoder.sp)
        shape = (cfg.num_layers, sites, cfg.T, heads,
                 cfg.d_model // cfg.num_heads)
        device = self.pos_embed_TSC.device
        return (torch.zeros(shape, dtype=self.dtype, device=device),
                torch.zeros(shape, dtype=self.dtype, device=device))

    def frame_latents(self, patches_S: torch.Tensor, t: int, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, action_ids: Optional[torch.Tensor] = None,
                      domain_id: int = 0, skip_normalization: bool = False,
                      update_cache: bool = True,
                      action_live: Optional[torch.Tensor] = None):
        """Conditioning latents of the single frame t against the temporal
        KV cache. patches_S: (B, S_p, patch_dim) patchified latents of frame t.

        Returns (z (B, S_p, d_model) fp32, action latent (B, d_model) fp32 or
        None, k_cache, v_cache); with update_cache the caches' slot t is
        written in place, otherwise they are left bit-identical. action_live:
        optional (B,) float; rows with 0 take the no-actions branch (the
        learned action mask tokens, no per-layer injection), which is what
        classifier-free guidance runs as its unconditional half.
        """
        cfg = self.config
        B, S, _ = patches_S.shape
        x_SC = self.token_embed(patches_S)
        ats = cfg.action_token_size
        action_emb = None
        if action_ids is not None and cfg.num_domains > 0:
            action_emb = self._action_embedding(action_ids, domain_id, skip_normalization)
            if "concat" in cfg.action_network:
                cond = action_emb[:, t, None, :].expand(B, ats, cfg.d_model).to(self.dtype)
                if action_live is not None:
                    mask_t = self.action_mask_tokens[:, t].to(self.dtype)
                    live = action_live[:, None, None].to(self.dtype)
                    cond = live * cond + (1 - live) * mask_t
                x_SC = torch.cat([x_SC, cond], dim=1)
        elif cfg.jointly_predict_actions:
            cond = self.action_mask_tokens[:, t].to(self.dtype).expand(B, ats, cfg.d_model)
            x_SC = torch.cat([x_SC, cond], dim=1)

        S_tot = x_SC.shape[1]
        x_SC = self.z_proj_ln(
            x_SC + self.pos_embed_TSC[:, t, :S_tot].to(self.dtype)).to(self.dtype)
        x_SC, k_cache, v_cache = self.decoder.frame_step(
            x_SC, t, k_cache, v_cache, action_emb, domain_id, update_cache, action_live)

        action_latent = None
        if cfg.jointly_predict_actions:
            action_latent = x_SC[:, -ats:].mean(dim=1).float()
        z = self._readout(x_SC[:, :S])
        dpe = self.diffusion_pos_embed_learned.view(1, cfg.T, self.seq_len, cfg.d_model)
        return z + dpe[:, t], action_latent, k_cache, v_cache

    # the diffusion heads' samplers (used by rollout/mar.py)
    def sample_tokens(self, z_rows: torch.Tensor,
                      generator: Optional[torch.Generator] = None,
                      temperature: float = 1.0, cfg_scale: float = 1.0,
                      clip_denoised: bool = True, **draws):
        return self.diffloss.sample(z_rows, generator, temperature, cfg_scale,
                                    clip_denoised, **draws)

    def sample_actions(self, z_rows: torch.Tensor,
                       generator: Optional[torch.Generator], domain_id: int,
                       temperature: float = 1.0, cfg_scale: float = 1.0,
                       clip_denoised: bool = True, **draws):
        return self.action_diff_loss.sample(z_rows, generator, temperature, cfg_scale,
                                            clip_denoised, domain_id=domain_id, **draws)
