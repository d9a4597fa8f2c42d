"""Per-embodiment ("domain") action conditioning as stacked parameter tables
(counterpart of hma_tpu/models/action_stems.py).

Every per-domain module holds parameters with a leading `num_domains` axis
and an integer `domain_id` selects the row, so one set of modules serves
all embodiments. Action vectors are zero-padded to `max_d_action`.
The cross-attention and the readout are plain PyTorch products, as their
JAX counterparts are XLA einsums.

Under tensor parallelism (`parallel.tensor_parallel.split_model`) a
`DomainDense` runs as `attention.Dense` does ("col", "row", "whole"); the
stem gathers its features around its LayerNorm, the modulation its hidden
features between `ada_fc1` and `ada_fc2` and takes the rank's shift and
scale, and the cross-attention runs on the rank's 8 / tp heads.

Under sequence parallelism every module here runs per token on the rank's
tokens; the cross-attention's compat="reference" row pairing reads each
query's global token index.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from hma_tpu_torch.models.attention import split_linear
from hma_tpu_torch.parallel import tensor_parallel as tpar


def build_action_stat_tables(d_actions: Sequence[int],
                             action_stats: Sequence[Sequence[Sequence[float]]],
                             max_d_action: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-domain tiled (mean, std) tables of width max_d_action.

    Each domain's stats are per *base* action dim; the model input is the
    stride-concatenated window, so the stats tile `stride` times. Padding
    uses mean=0 / std=1 so padded dims pass through as zeros.
    """
    n = len(d_actions)
    means = np.zeros((n, max_d_action), dtype=np.float32)
    stds = np.ones((n, max_d_action), dtype=np.float32)
    for i, (width, stat) in enumerate(zip(d_actions, action_stats)):
        mean = np.asarray(stat[0], dtype=np.float32)
        std = np.asarray(stat[1], dtype=np.float32)
        reps = width // len(mean)
        if reps * len(mean) != width:
            raise ValueError(f"domain {i}: width {width} is not a multiple "
                             f"of {len(mean)} stats")
        means[i, :width] = np.tile(mean, reps)
        stds[i, :width] = np.tile(std, reps)
    return means, stds


def normalize_actions(actions: torch.Tensor, domain_id: int,
                      mean_table: torch.Tensor, std_table: torch.Tensor) -> torch.Tensor:
    """(x - mean) / (std + 1e-10) with per-domain tiled stats; padded dims -> 0."""
    return (actions - mean_table[domain_id]) / (std_table[domain_id] + 1e-10)


def take_domain(table: torch.Tensor, domain_id: int) -> torch.Tensor:
    """A domain's row of a stacked PARAM table; a table with a leading axis
    of 1 is a pre-sliced single-domain view and always yields row 0."""
    return table[domain_id if table.shape[0] != 1 else 0]


def _var_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    """fp32 (x - mean) * rsqrt(var + eps), with var = mean((x - mean)^2),
    as `jnp.var` computes it."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    return (x32 - mu) * torch.rsqrt(var + eps)


class DomainDense(nn.Module):
    """Dense layer with a stacked (num_domains, in, out) kernel and, with
    `use_bias`, a (num_domains, out) bias.

    `init_gain` g draws the kernel xavier-uniform(g) over flax's fans of a
    stacked kernel (fan_in = num_domains * in, fan_out = num_domains * out);
    None draws torch's Linear default, uniform of variance 1 / (3 fan_in)."""

    def __init__(self, num_domains: int, in_features: int, out_features: int,
                 init_gain: Optional[float] = 0.01, use_bias: bool = True,
                 dtype=torch.bfloat16, device="cuda"):
        super().__init__()
        self.init_gain = init_gain
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(num_domains, in_features,
                                               out_features, device=device))
        self.bias = (nn.Parameter(torch.zeros(num_domains, out_features, device=device))
                     if use_bias else None)
        self.tp = self.tp_mode = None

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        nd, fan_in, fan_out = self.kernel.shape
        if self.init_gain is None:
            bound = math.sqrt(1.0 / (nd * fan_in))
        else:
            bound = self.init_gain * math.sqrt(6.0 / (nd * fan_in + nd * fan_out))
        self.kernel.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor, domain_id: int) -> torch.Tensor:
        kernel = self.kernel
        if self.tp_mode == "whole":
            kernel = tpar.gather(kernel, self.tp, self.tp_part.dim)
        w = take_domain(kernel, domain_id).to(self.dtype)
        b = None if self.bias is None else take_domain(self.bias, domain_id).to(self.dtype)
        if self.tp_mode in ("col", "row"):
            return split_linear(x.to(self.dtype), w, b, self, _matmul, w.shape[0])
        return _matmul(x.to(self.dtype), w, b)


def _matmul(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor]) -> torch.Tensor:
    y = x @ w
    return y if b is None else y + b


class DomainLayerNorm(nn.Module):
    """LayerNorm with stacked per-domain scale/bias, computed in fp32."""

    def __init__(self, num_domains: int, features: int, epsilon: float = 1e-5,
                 dtype=torch.bfloat16, device="cuda"):
        super().__init__()
        self.epsilon = epsilon
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(num_domains, features, device=device))
        self.bias = nn.Parameter(torch.zeros(num_domains, features, device=device))

    def forward(self, x: torch.Tensor, domain_id: int) -> torch.Tensor:
        y = _var_norm(x, self.epsilon)
        y = y * take_domain(self.scale, domain_id) + take_domain(self.bias, domain_id)
        return y.to(self.dtype)


class ActionStemMLP(nn.Module):
    """Per-domain action stem: Dense -> LayerNorm -> ReLU -> Dense."""

    def __init__(self, num_domains: int, max_d_action: int, d_model: int,
                 dtype=torch.bfloat16, device="cuda"):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.fc1 = DomainDense(num_domains, max_d_action, d_model, **kw)
        self.ln = DomainLayerNorm(num_domains, d_model, **kw)
        self.fc2 = DomainDense(num_domains, d_model, d_model, **kw)
        self.tp = None

    def enable_tp(self, tp) -> None:
        """fc1 column-split, its features gathered for the LayerNorm, fc2
        row-split."""
        if tpar.split_mode(self.fc1, self.fc2):
            self.tp = tp

    def forward(self, actions: torch.Tensor, domain_id: int) -> torch.Tensor:
        h = self.ln(tpar.gather(self.fc1(actions, domain_id), self.tp), domain_id)
        return self.fc2(F.relu(h), domain_id)


class DomainModulate(nn.Module):
    """Token-wise adaLN modulation from action features:
    y = linear_out(norm(x) * (1 + scale) + shift), with (shift, scale) from
    the action embedding; the norm has eps 1e-6 and no affine."""

    def __init__(self, num_domains: int, d_model: int, dtype=torch.bfloat16,
                 device="cuda"):
        super().__init__()
        kw = dict(init_gain=0.1, dtype=dtype, device=device)
        self.dtype = dtype
        self.ada_fc1 = DomainDense(num_domains, d_model, d_model, **kw)
        self.ada_fc2 = DomainDense(num_domains, d_model, 2 * d_model, **kw)
        self.linear_out = DomainDense(num_domains, d_model, d_model, **kw)
        self.tp = None

    def enable_tp(self, tp) -> None:
        """ada_fc1 column-split and gathered, ada_fc2 column-split by
        [shift | scale] (the rank's shift and scale), linear_out row-split
        on the rank's modulated features."""
        if tpar.split_mode(self.ada_fc1, self.ada_fc2, self.linear_out):
            self.tp = tp

    def forward(self, x: torch.Tensor, cond: torch.Tensor,
                domain_id: int) -> torch.Tensor:
        """x: (..., d_model); cond broadcastable to x's leading dims."""
        h = tpar.gather(F.silu(self.ada_fc1(cond, domain_id)), self.tp)
        shift, scale = self.ada_fc2(h, domain_id).chunk(2, dim=-1)
        normed = tpar.scatter(_var_norm(x, 1e-6).to(self.dtype), self.tp)
        return self.linear_out(normed * (1 + scale) + shift, domain_id)


class DomainCrossAttention(nn.Module):
    """Per-domain cross-attention action injection: q (B, N, C) attends to
    kv (B, M, C). 8 heads whatever the trunk has (pass num_heads=8), scale
    8 / head_dim, one shared per-domain fp32 qk LayerNorm (eps 1e-5), fp32
    scores, probs cast to the compute dtype before p v, `proj` with a bias.

    compat="reference" reproduces the reference's BasicCrossAttention
    quirks exactly; q is then the (B, S, T, C) view:
      - query row i = b*S + s reads action row i % B (its `.repeat` tiling);
      - q, k, v stay (.., T, H, D) with no head transpose, so the softmax
        runs over an (H, H) head table for each (b, s, t);
      - the (H, T, D) output block is reinterpreted as (T, H*D).
    """

    def __init__(self, num_domains: int, num_heads: int, d_model: int,
                 dtype=torch.bfloat16, compat: str = "fixed", device="cuda"):
        super().__init__()
        if compat not in ("fixed", "reference"):
            raise ValueError(f"cross_attention_compat={compat!r}")
        self.num_heads = num_heads
        self.head_dim = d_model // num_heads
        self.dtype = dtype
        self.compat = compat
        # JAX multiplies by the scale cast to the compute dtype
        self.scale = float(torch.tensor(8.0 / self.head_dim, dtype=dtype))
        kw = dict(use_bias=False, dtype=dtype, device=device)
        self.to_q = DomainDense(num_domains, d_model, d_model, **kw)
        self.to_k = DomainDense(num_domains, d_model, d_model, **kw)
        self.to_v = DomainDense(num_domains, d_model, d_model, **kw)
        self.qk_ln_scale = nn.Parameter(torch.ones(num_domains, self.head_dim, device=device))
        self.qk_ln_bias = nn.Parameter(torch.zeros(num_domains, self.head_dim, device=device))
        self.proj = DomainDense(num_domains, d_model, d_model, dtype=dtype, device=device)
        self.tp = self.sp = None

    def enable_tp(self, tp) -> None:
        """to_q/to_k/to_v column-split by head (their outputs are (H, D), so
        a rank's contiguous part is whole heads), proj row-split: the rank
        attends with its H / tp heads; the compat="reference" head-axis
        softmax gathers every head and proj takes the rank's part."""
        if not tpar.split_mode(self.to_q, self.to_k, self.to_v, self.proj):
            return
        if self.num_heads % tp.size:
            raise NotImplementedError(f"tp {tp.size} does not divide {self.num_heads} heads")
        self.tp = tp
        if self.compat == "fixed":
            self.num_heads //= tp.size

    def enable_sp(self, sp) -> None:
        """q holds the rank's tokens of every frame: the compat="reference"
        pairing counts them from its first token's global index."""
        self.sp = sp

    def _ln(self, u: torch.Tensor, domain_id: int) -> torch.Tensor:
        scale, bias = (tpar.copy(p, None if self.compat == "reference" else self.tp)
                       for p in (self.qk_ln_scale, self.qk_ln_bias))
        y = _var_norm(u, 1e-5) * take_domain(scale, domain_id)
        return (y + take_domain(bias, domain_id)).to(self.dtype)

    def forward(self, q: torch.Tensor, kv: torch.Tensor, domain_id: int) -> torch.Tensor:
        H, D = self.num_heads, self.head_dim
        if self.compat == "reference":
            B, S, T, C = q.shape
            ranks, rank = (1, 0) if self.sp is None else (self.sp.size, self.sp.rank)
            s = rank * S + torch.arange(S, device=q.device)  # the global token index
            rows = (torch.arange(B, device=q.device)[:, None] * S * ranks + s[None, :]) % B
            kvp = kv[:, :T][rows]  # (B, S, T, C)
            qh, kh, vh = (tpar.gather(f(x, domain_id), self.tp).view(B, S, T, H, D)
                          for f, x in ((self.to_q, q), (self.to_k, kvp), (self.to_v, kvp)))
            qh = self._ln(qh, domain_id) * self.scale
            kh = self._ln(kh, domain_id)
            logits = torch.einsum("bsthd,bstgd->bsthg", qh.float(), kh.float())
            probs = torch.softmax(logits, -1).to(self.dtype)
            out = torch.einsum("bsthg,bstgd->bsthd", probs, vh)
            out = out.transpose(2, 3).reshape(B, S, T, C)
            return self.proj(out, domain_id)
        B, N, C = q.shape
        M = kv.shape[1]
        qh = self._ln(self.to_q(q, domain_id).view(B, N, H, D), domain_id) * self.scale
        kh = self._ln(self.to_k(kv, domain_id).view(B, M, H, D), domain_id)
        vh = self.to_v(kv, domain_id).view(B, M, H, D)
        logits = torch.einsum("bnhd,bmhd->bhnm", qh.float(), kh.float())
        probs = torch.softmax(logits, -1).to(self.dtype)
        out = torch.einsum("bhnm,bmhd->bnhd", probs, vh).reshape(B, N, H * D)
        return self.proj(out, domain_id)


class ActionReadout(nn.Module):
    """Pooled action readout head: d_model -> max_d_action, per domain,
    drawn with torch's Linear default init."""

    def __init__(self, num_domains: int, d_model: int, max_d_action: int,
                 dtype=torch.bfloat16, device="cuda"):
        super().__init__()
        self.out = DomainDense(num_domains, d_model, max_d_action, init_gain=None,
                               dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, domain_id: int) -> torch.Tensor:
        return self.out(x, domain_id)
