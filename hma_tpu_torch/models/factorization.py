"""Factored-vocabulary utilities and embedding
(counterpart of hma_tpu/models/factorization.py).

The 2**18-token MagVit2 vocabulary is factored into `num_factored_vocabs`
base-`factored_vocab_size` digits (2 x 512 by default).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F


def _powers(n: int, base: int, like: torch.Tensor) -> torch.Tensor:
    return base ** torch.arange(n, dtype=like.dtype, device=like.device)


def factorize_token_ids(token_ids: torch.Tensor, num_factored_vocabs: int = 2,
                        factored_vocab_size: int = 512) -> torch.Tensor:
    """Split ids in [0, vocab**n) into n base-`vocab` digits (last axis),
    factor 0 being the least-significant digit."""
    powers = _powers(num_factored_vocabs, factored_vocab_size, token_ids)
    return (token_ids[..., None] // powers) % factored_vocab_size


def unfactorize_token_ids(factored: torch.Tensor, num_factored_vocabs: int = 2,
                          factored_vocab_size: int = 512) -> torch.Tensor:
    """Inverse of `factorize_token_ids` over the last axis."""
    powers = _powers(num_factored_vocabs, factored_vocab_size, factored)
    return torch.sum(factored * powers, dim=-1)


def factorize_labels(labels_THW: torch.Tensor, num_factored_vocabs: int = 2,
                     factored_vocab_size: int = 512) -> torch.Tensor:
    """(B, T, H, W) ids -> (B, num_factored_vocabs, T, H, W) factored ids."""
    f = factorize_token_ids(labels_THW, num_factored_vocabs, factored_vocab_size)
    return torch.movedim(f, -1, 1)


class FactorizedEmbedding(nn.Module):
    """Sum of per-factor embeddings; masked positions (id == mask_token_id)
    take `mask_token_embed` through a select, so the gather is static-shape."""

    def __init__(self, factored_vocab_size: int, num_factored_vocabs: int,
                 d_model: int, mask_token_id: int, dtype=torch.bfloat16,
                 device="cuda"):
        super().__init__()
        self.factored_vocab_size = factored_vocab_size
        self.num_factored_vocabs = num_factored_vocabs
        self.mask_token_id = mask_token_id
        self.dtype = dtype
        self.factored_embeds = nn.ModuleList(
            nn.Embedding(factored_vocab_size, d_model, device=device)
            for _ in range(num_factored_vocabs))
        self.mask_token_embed = nn.Parameter(
            torch.zeros(1, d_model, device=device))

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """input_ids: (...) int -> (..., d_model) in the compute dtype."""
        is_mask = input_ids == self.mask_token_id
        safe_ids = torch.where(is_mask, 0, input_ids)
        factored = factorize_token_ids(safe_ids, self.num_factored_vocabs,
                                       self.factored_vocab_size)
        embeds = 0
        for i, table in enumerate(self.factored_embeds):
            embeds = embeds + F.embedding(factored[..., i],
                                          table.weight.to(self.dtype))
        return torch.where(is_mask[..., None],
                           self.mask_token_embed.to(self.dtype), embeds)
