"""Per-embodiment ("domain") action conditioning as stacked parameter tables
(counterpart of hma_tpu/models/action_stems.py).

Every per-domain module holds parameters with a leading `num_domains` axis
and an integer `domain_id` selects the row, so one set of modules serves
all embodiments. Action vectors are zero-padded to `max_d_action`.
`DomainCrossAttention` and `ActionReadout` are not ported yet.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F


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
    """Dense layer with a stacked (num_domains, in, out) kernel and
    (num_domains, out) bias."""

    def __init__(self, num_domains: int, in_features: int, out_features: int,
                 init_gain: float = 0.01, dtype=torch.bfloat16, device="cuda"):
        super().__init__()
        self.init_gain = init_gain
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(num_domains, in_features,
                                               out_features, device=device))
        self.bias = nn.Parameter(torch.zeros(num_domains, out_features,
                                             device=device))

    def forward(self, x: torch.Tensor, domain_id: int) -> torch.Tensor:
        y = x.to(self.dtype) @ take_domain(self.kernel, domain_id).to(self.dtype)
        return y + take_domain(self.bias, domain_id).to(self.dtype)


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

    def forward(self, actions: torch.Tensor, domain_id: int) -> torch.Tensor:
        h = self.ln(self.fc1(actions, domain_id), domain_id)
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

    def forward(self, x: torch.Tensor, cond: torch.Tensor,
                domain_id: int) -> torch.Tensor:
        """x: (..., d_model); cond broadcastable to x's leading dims."""
        h = F.silu(self.ada_fc1(cond, domain_id))
        shift, scale = self.ada_fc2(h, domain_id).chunk(2, dim=-1)
        normed = _var_norm(x, 1e-6).to(self.dtype)
        return self.linear_out(normed * (1 + scale) + shift, domain_id)
