"""MaskGIT masking schedules (counterpart of hma_tpu/models/schedules.py)."""

from __future__ import annotations

import math

import torch


def cosine_schedule(u):
    """cos(u * pi / 2) for u in [0, 1]; works on floats and tensors."""
    if isinstance(u, (float, int)):
        return math.cos(u * math.pi / 2)
    return torch.cos(u * math.pi / 2)


def maskgit_mask_counts(maskgit_steps: int, seq_len: int) -> list[int]:
    """Number of tokens left masked after each MaskGIT step.

    Step i re-masks ceil(cos((i+1)/steps * pi/2) * S) tokens; the final
    step masks none.
    """
    ns = []
    for step in range(maskgit_steps):
        if step == maskgit_steps - 1:
            ns.append(0)
        else:
            ns.append(math.ceil(cosine_schedule((step + 1) / maskgit_steps) * seq_len))
    return ns
