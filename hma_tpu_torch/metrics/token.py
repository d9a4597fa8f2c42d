"""Token-space eval metrics: factored CE loss, perplexity, accuracy
(counterpart of hma_tpu/metrics/token.py), on the (B, T-1, S, nv, fv)
logits the rollout functions return."""

from __future__ import annotations

import torch
from torch.nn import functional as F

from hma_tpu_torch.models.factorization import factorize_token_ids


def teacher_forced_metrics(logits: torch.Tensor, targets: torch.Tensor,
                           factored_vocab_size: int = 512) -> dict:
    """logits: (B, T-1, S, nv, fv); targets: (B, T-1, S) ids.

    Returns {'loss', 'perplexity', 'acc'} as 0-d fp32 tensors: the CE summed
    over the factored vocabs and averaged over every token (all tokens of
    frames 1.., each decoded from a fully masked frame); a token is correct
    when the argmax of every factor is.
    """
    nv = logits.shape[-2]
    ft = factorize_token_ids(targets.long(), nv, factored_vocab_size)  # (..., nv)
    logits = logits.float()
    logp = F.log_softmax(logits, dim=-1)
    ce = -logp.gather(-1, ft[..., None])[..., 0].sum(-1)  # over the factors
    loss = ce.mean()
    acc = (logits.argmax(-1) == ft).all(-1).float().mean()
    return {"loss": loss, "perplexity": torch.exp(loss), "acc": acc}


class AvgMetric:
    """Running mean over batches, each weighted by its size."""

    def __init__(self):
        self.total = 0.0
        self.count = 0

    def update(self, value: float, n: int = 1):
        self.total += float(value) * n
        self.count += n

    def mean(self) -> float:
        return self.total / max(self.count, 1)
