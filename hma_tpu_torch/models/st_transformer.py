"""Spatiotemporal factorized transformer
(counterpart of hma_tpu/models/st_transformer.py).

Per block: bidirectional spatial self-attention over the S (+ action)
tokens of each frame, per-domain action injection, causal temporal
self-attention over T at each spatial site, MLP. Both temporal layouts are
ported: "transpose" (the default: (B, T, S, C) <-> (B, S, T, C) around the
temporal half) and "resident" (the stream stays (B, T, S, C) and the causal
pass reads the qkv projection in place, K5'); so is remat of every block
("full" policy), and both cached decode paths: `frame_step` (one frame)
and `window_step` (frames [t0, t0+F) in one pass, spatial attention through
K1' over all B*F frames, the temporal half through
`SelfAttention.decode_window`). `scan_layers` is not ported (the converter
unstacks a `layers_scan` tree).

Action injection: "mlp" adds the frame's action embedding, "modulate" runs
the adaLN `DomainModulate`, "cross_attention" runs `DomainCrossAttention`
(its queries the block's tokens, its keys and values the action embedding of
every frame). As in `hma_tpu`, cross-attention raises in the resident layout
and, with `cross_attention_compat="reference"` (whose injection mixes
timesteps), in the cached decode paths: that card rolls out by full
recompute (`rollout.maskgit.generate_tokens_full`).

MLP dropout (`mlp_drop`, after the GELU and after fc2, as `hma_tpu`'s Mlp)
runs only in a training forward that is handed `dropout`: a generator, from
which the decoder draws one seed per block before the block runs (the masks
are drawn from that seed inside the block, so remat's recompute draws the
same ones), or the masks themselves. Every other forward, the rollouts'
`frame_step` among them, is deterministic, as in `hma_tpu`.

Under tensor parallelism (`parallel.tensor_parallel.split_model`) both
attentions run on the rank's H / tp heads and the temporal KV caches hold
them; the MLP's fc1 is column-split and fc2 row-split, and its hidden
dropout mask is drawn at the whole hidden width (what one process draws)
and sliced to the rank's features.

Under sequence parallelism (`parallel.sequence_parallel.enable`) the
decoder keeps the rank's contiguous chunk of every frame's tokens before
the first block and joins the ranks' outputs after the last, in the full
forward and in both cached steps; the blocks run on the chunk (spatial
attention through the all-to-all of `SelfAttention`, the temporal passes on
the rank's sites, whose KV caches they hold). The MLP's dropout masks are
drawn at the whole frame's shape and cut to the rank's tokens of each
batch row.

With `qk_norm=True`, norm1/norm2 are Identity, a quirk kept from the
reference: the only normalisation is the qk-LayerNorm inside attention.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from hma_tpu_torch.models.action_stems import DomainCrossAttention, DomainModulate
from hma_tpu_torch.models.attention import Dense, LayerNorm, SelfAttention
from hma_tpu_torch.parallel import sequence_parallel as seqp
from hma_tpu_torch.parallel import tensor_parallel as tpar
from hma_tpu_torch.parallel.distributed import RankRows, draw_rows, source


# One block's MLP dropout: None (deterministic), an int seed from which
# both masks are drawn (or a `RankRows` of one: a data-parallel rank's rows
# of them), or the two boolean keep-masks (hidden, output).
BlockDropout = Union[None, int, RankRows, Sequence[torch.Tensor]]


def _dropout(x: torch.Tensor, keep: float, mask: torch.Tensor) -> torch.Tensor:
    """flax's `nn.Dropout`: select(mask, x / keep_prob, 0), keep_prob
    rounded to x's dtype as a JAX weak-typed float is."""
    scaled = x / float(torch.tensor(keep, dtype=x.dtype))
    return torch.where(mask, scaled, torch.zeros((), dtype=x.dtype, device=x.device))


class Mlp(nn.Module):
    """Dense -> exact GELU -> dropout -> Dense -> dropout."""

    def __init__(self, d_model: int, mlp_ratio: float = 4.0, mlp_bias: bool = True,
                 mlp_drop: float = 0.0, dtype=torch.bfloat16, device="cuda"):
        super().__init__()
        self.hidden = int(d_model * mlp_ratio)
        self.mlp_drop = mlp_drop
        self.fc1 = Dense(d_model, self.hidden, mlp_bias, dtype, device)
        self.fc2 = Dense(self.hidden, d_model, mlp_bias, dtype, device)
        self.tp = self.sp = None

    def enable_tp(self, tp) -> None:
        """fc1 column-split, fc2 row-split: the rank's hidden features."""
        if tpar.split_mode(self.fc1, self.fc2):
            self.tp = tp

    def enable_sp(self, sp) -> None:
        """x holds the rank's tokens: the masks are cut to them."""
        self.sp = sp

    def forward(self, x: torch.Tensor, dropout: BlockDropout = None,
                tokens: int = 1) -> torch.Tensor:
        """`dropout`: see `BlockDropout`; ignored when mlp_drop is 0. The
        masks are laid out as x's leading dimensions (given masks of the
        same elements are reshaped to them); under sp they are the whole
        frame's (drawn or given), `tokens` being the dimension of x that
        holds the rank's tokens, and are cut to them. The hidden mask is the
        whole hidden width's, sliced to the rank's features under tp."""
        h = F.gelu(self.fc1(x), approximate="none")
        if dropout is None or self.mlp_drop == 0.0:
            return self.fc2(h)
        keep = 1.0 - self.mlp_drop
        lead = list(h.shape[:-1])
        if self.sp is not None:
            lead[tokens] *= self.sp.size
        if isinstance(source(dropout), int):
            g = torch.Generator(x.device).manual_seed(source(dropout))
            if isinstance(dropout, RankRows):
                g = dropout._replace(source=g)
            masks = [draw_rows(lambda m, g, s=shape: torch.rand(
                         (m, *s[1:]), generator=g, device=x.device), shape[0], g) < keep
                     for shape in ((*lead, self.hidden), (*lead, self.fc2.out_features))]
        else:
            masks = [m.reshape(*lead, m.shape[-1]) for m in dropout]
        masks = [seqp.split_tokens(m, self.sp, tokens) for m in masks]
        if self.tp is not None and masks[0].shape[-1] == self.hidden:
            masks[0] = tpar.rank_slice(masks[0], self.tp, masks[0].ndim - 1)
        return _dropout(self.fc2(_dropout(h, keep, masks[0])), keep, masks[1])


class STBlock(nn.Module):
    """One spatiotemporal block."""

    def __init__(self, num_heads: int, d_model: int, qkv_bias: bool = False,
                 proj_bias: bool = True, qk_norm: bool = True, use_mup: bool = True,
                 mlp_ratio: float = 4.0, mlp_bias: bool = True, mlp_drop: float = 0.0,
                 action_processing: str = "mlp", num_domains: int = 0,
                 temporal_layout: str = "transpose",
                 cross_attention_compat: str = "fixed", dtype=torch.bfloat16,
                 device="cuda"):
        super().__init__()
        if temporal_layout not in ("transpose", "resident"):
            raise ValueError(f"temporal_layout={temporal_layout!r}")
        attn_kw = dict(num_heads=num_heads, d_model=d_model, qkv_bias=qkv_bias,
                       proj_bias=proj_bias, qk_norm=qk_norm, use_mup=use_mup,
                       dtype=dtype, device=device)
        self.dtype = dtype
        self.action_processing = action_processing
        self.temporal_layout = temporal_layout
        self.spatial_attn = SelfAttention(**attn_kw)
        self.temporal_attn = SelfAttention(**attn_kw)
        self.mlp = Mlp(d_model, mlp_ratio, mlp_bias, mlp_drop, dtype, device)
        self.norm1 = None if qk_norm else LayerNorm(d_model, device=device)
        self.norm2 = None if qk_norm else LayerNorm(d_model, device=device)
        self.action_projector = None
        # "mlp" takes precedence, then "cross_attention", as in hma_tpu
        self.cross = (num_domains > 0 and "mlp" not in action_processing
                      and "cross_attention" in action_processing)
        if self.cross:
            self.action_projector = DomainCrossAttention(
                num_domains, 8, d_model, dtype, cross_attention_compat, device)
        elif num_domains > 0 and "modulate" in action_processing:
            self.action_projector = DomainModulate(num_domains, d_model, dtype, device)
        self.inject = num_domains > 0

    def _pre(self, norm: Optional[LayerNorm], x: torch.Tensor) -> torch.Tensor:
        return x if norm is None else norm(x).to(self.dtype)

    def _refuse_cached_reference(self) -> None:
        if self.cross and self.action_projector.compat == "reference":
            raise NotImplementedError(
                "cross_attention_compat='reference' mixes timesteps (the "
                "scrambled head/time reshape of the reference's cross-attention), "
                "so cached decode cannot be exact: use the full-recompute rollout "
                "(rollout.maskgit.generate_tokens_full)")

    def _cross(self, x: torch.Tensor, action_emb: torch.Tensor, domain_id: int,
               live=None) -> torch.Tensor:
        """Cross-attention injection of x (B, ..., C) against every frame of
        action_emb (B, M, C), gated by `live` where given; each query row
        attends on its own, so their order does not matter."""
        B, C = x.shape[0], x.shape[-1]
        out = self.action_projector(x.reshape(B, -1, C), action_emb, domain_id)
        out = out.view(x.shape)
        return x + (out if live is None else out * live)

    def _inject(self, x: torch.Tensor, cond: torch.Tensor, domain_id: int,
                live=1.0) -> torch.Tensor:
        """Add the action conditioning; cond broadcasts against x and `live`
        gates it."""
        if "mlp" in self.action_processing:
            return x + cond * live
        if self.action_projector is not None:
            return x + self.action_projector(x, cond, domain_id) * live
        return x

    def forward(self, x_TSC: torch.Tensor, action_emb: Optional[torch.Tensor] = None,
                domain_id: int = 0, dropout: BlockDropout = None) -> torch.Tensor:
        """Full forward. x_TSC: (B, T, S, C); action_emb: (B, T, C);
        dropout: the MLP's (`BlockDropout`), masks shaped like its hidden and
        output activations in this block's layout: (B, S, T, .) (or
        (B*S, T, .)) for "transpose", (B, T, S, .) for "resident"."""
        B, T, S, C = x_TSC.shape
        x_SC = x_TSC.reshape(B * T, S, C)
        x_SC = x_SC + self.spatial_attn(self._pre(self.norm1, x_SC))
        if self.temporal_layout == "resident":
            x = x_SC.reshape(B, T, S, C)
            if action_emb is not None and self.inject:
                if self.cross:
                    raise NotImplementedError(
                        f"temporal_layout='resident' with {self.action_processing}")
                x = self._inject(x, action_emb[:, :T, None], domain_id)
            x = x + self.temporal_attn.temporal_resident(x)
            return x + self.mlp(self._pre(self.norm2, x), dropout, tokens=2)
        x_BSTC = x_SC.reshape(B, T, S, C).transpose(1, 2)  # (B, S, T, C)
        if action_emb is not None and self.cross:
            if self.action_projector.compat == "reference":
                # the reference's row pairing needs the (B, S, T, C) view
                x_BSTC = x_BSTC + self.action_projector(x_BSTC, action_emb[:, :T],
                                                        domain_id)
            else:
                x_BSTC = self._cross(x_BSTC, action_emb[:, :T], domain_id)
        elif action_emb is not None and self.inject:
            x_BSTC = self._inject(x_BSTC, action_emb[:, None, :T], domain_id)
        x_TC = x_BSTC.reshape(B * S, T, C)
        x_BSTC = (x_TC + self.temporal_attn(x_TC, causal=True)).view(B, S, T, C)
        x_BSTC = x_BSTC + self.mlp(self._pre(self.norm2, x_BSTC), dropout, tokens=1)
        return x_BSTC.transpose(1, 2)

    def frame_step(self, x_SC: torch.Tensor, t: int, k_cache: torch.Tensor,
                   v_cache: torch.Tensor, action_emb: Optional[torch.Tensor] = None,
                   domain_id: int = 0, action_live: Optional[torch.Tensor] = None):
        """Single-frame decode of frame t. x_SC: (B, S, C); k/v_cache:
        (B*S, T_max, H, D), read-only. Returns (x_SC, k_t, v_t).

        action_live: optional (B,) float gate on the action injection: rows
        with 0 get no action conditioning, as with action_emb=None (the MAR
        rollout's classifier-free guidance runs [cond | uncond] halves of
        one doubled batch this way)."""
        B, S, C = x_SC.shape
        x_SC = x_SC + self.spatial_attn(self._pre(self.norm1, x_SC))
        if action_emb is not None and self.inject:
            live = (1.0 if action_live is None
                    else action_live[:, None, None].to(x_SC.dtype))
            if self.cross:
                self._refuse_cached_reference()
                x_SC = self._cross(x_SC, action_emb, domain_id, live)
            else:
                x_SC = self._inject(x_SC, action_emb[:, t:t + 1], domain_id, live)
        x_TC = x_SC.reshape(B * S, 1, C)
        attn_out, k_t, v_t = self.temporal_attn.decode_step(x_TC, k_cache, v_cache, t)
        x_TC = x_TC + attn_out
        x_TC = x_TC + self.mlp(self._pre(self.norm2, x_TC))
        return x_TC.reshape(B, S, C), k_t, v_t

    def window_step(self, x_FSC: torch.Tensor, t0: int, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, action_emb: Optional[torch.Tensor] = None,
                    domain_id: int = 0):
        """Decode of the frames [t0, t0+F) in one pass. x_FSC: (B, F, S, C);
        k/v_cache: (B*S, T_max, H, D) holding frames < t0, read-only.
        Returns (x_FSC, k_w, v_w) with the window's (B*S, F, H, D) slices."""
        B, F_, S, C = x_FSC.shape
        x_SC = x_FSC.reshape(B * F_, S, C)
        x_SC = x_SC + self.spatial_attn(self._pre(self.norm1, x_SC))
        x_FSC = x_SC.reshape(B, F_, S, C)
        if action_emb is not None and self.cross:
            self._refuse_cached_reference()
            x_FSC = self._cross(x_FSC, action_emb, domain_id)
        elif action_emb is not None and self.inject:
            x_FSC = self._inject(x_FSC, action_emb[:, t0:t0 + F_, None], domain_id)
        x_TC = x_FSC.transpose(1, 2).reshape(B * S, F_, C)
        attn_out, k_w, v_w = self.temporal_attn.decode_window(x_TC, k_cache, v_cache, t0)
        x_TC = x_TC + attn_out
        x_TC = x_TC + self.mlp(self._pre(self.norm2, x_TC))
        return x_TC.reshape(B, S, F_, C).transpose(1, 2), k_w, v_w


class STTransformerDecoder(nn.Module):
    """Stack of STBlocks (loop layout: `layers.<i>`).

    With `remat`, each block of a forward that records gradients runs
    under `torch.utils.checkpoint` (non-reentrant): only its input is kept
    and the block is recomputed in the backward (JAX's `nn.remat` with no
    saveable policy, "full"). The checkpoint restores only the default
    CPU and CUDA RNG states, never a `torch.Generator`, so a block draws
    nothing from one: its dropout seed (or masks) is drawn before the block
    and handed in, and the recompute draws the same masks from it, as JAX's
    remat does with its dropout key.
    """

    def __init__(self, num_layers: int, remat: bool = False,
                 remat_policy: str = "full", **block_kw):
        super().__init__()
        if remat and remat_policy != "full":
            raise NotImplementedError(
                f"remat_policy={remat_policy!r}: only 'full' is ported "
                "(ROADMAP.md Queue A)")
        self.remat = remat
        self.layers = nn.ModuleList(STBlock(**block_kw) for _ in range(num_layers))
        self.sp = None

    def enable_sp(self, sp) -> None:
        """Run the blocks on the rank's tokens of every frame (see the
        module docstring)."""
        self.sp = sp

    def forward(self, x_TSC: torch.Tensor, action_emb: Optional[torch.Tensor] = None,
                domain_id: int = 0,
                dropout: Union[None, torch.Generator, RankRows, Sequence[BlockDropout]] = None
                ) -> torch.Tensor:
        """dropout: None (deterministic), a generator or a `RankRows` of one
        (one seed per block is drawn from it, on its device, before the
        blocks run) or one `BlockDropout` per block."""
        remat = self.remat and torch.is_grad_enabled()
        x_TSC = seqp.split_tokens(x_TSC, self.sp, 2)
        if isinstance(source(dropout), torch.Generator):
            g = source(dropout)
            seeds = torch.randint(0, 2**62, (len(self.layers),), generator=g,
                                  device=g.device).tolist()
            dropout = [dropout._replace(source=s) if isinstance(dropout, RankRows) else s
                       for s in seeds]
        for i, layer in enumerate(self.layers):
            drop = None if dropout is None else dropout[i]
            if remat:
                x_TSC = checkpoint(layer, x_TSC, action_emb, domain_id, drop,
                                   use_reentrant=False, preserve_rng_state=False)
            else:
                x_TSC = layer(x_TSC, action_emb, domain_id, drop)
        return seqp.gather_tokens(x_TSC, self.sp, 2)

    def frame_step(self, x_SC: torch.Tensor, t: int, k_cache: torch.Tensor,
                   v_cache: torch.Tensor, action_emb: Optional[torch.Tensor] = None,
                   domain_id: int = 0, update_cache: bool = True,
                   action_live: Optional[torch.Tensor] = None):
        """x_SC: (B, S, C); k/v_cache: (L, B*S, T_max, H, D) (B*S/sp sites
        under sp: the rank's tokens of each row); action_live: optional (B,)
        gate on each layer's action injection.

        With update_cache, each layer's frame-t KV slice is written in place
        into slot t of the caches; otherwise the caches are not touched.
        Returns (x_SC, k_cache, v_cache), the caches being the same tensors.
        """
        x_SC = seqp.split_tokens(x_SC, self.sp, 1)
        for i, layer in enumerate(self.layers):
            x_SC, k_t, v_t = layer.frame_step(x_SC, t, k_cache[i], v_cache[i],
                                              action_emb, domain_id, action_live)
            if update_cache:
                k_cache[i, :, t] = k_t[:, 0]
                v_cache[i, :, t] = v_t[:, 0]
        return seqp.gather_tokens(x_SC, self.sp, 1), k_cache, v_cache

    def window_step(self, x_FSC: torch.Tensor, t0: int, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, action_emb: Optional[torch.Tensor] = None,
                    domain_id: int = 0, write_frames: int = 0):
        """x_FSC: (B, F, S, C) for the frames [t0, t0+F); k/v_cache: (L, B*S,
        T_max, H, D) (B*S/sp sites under sp). The first `write_frames`
        frames' KV slices are written in place into slots [t0,
        t0+write_frames) of the caches, layer by layer; with 0 the caches are
        not touched. Returns (x_FSC, k_cache, v_cache), the caches being the
        same tensors."""
        x_FSC = seqp.split_tokens(x_FSC, self.sp, 2)
        for i, layer in enumerate(self.layers):
            x_FSC, k_w, v_w = layer.window_step(x_FSC, t0, k_cache[i], v_cache[i],
                                                action_emb, domain_id)
            if write_frames > 0:
                k_cache[i, :, t0:t0 + write_frames] = k_w[:, :write_frames]
                v_cache[i, :, t0:t0 + write_frames] = v_w[:, :write_frames]
        return seqp.gather_tokens(x_FSC, self.sp, 2), k_cache, v_cache
