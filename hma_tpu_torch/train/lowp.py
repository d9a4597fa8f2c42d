"""Low-precision Adam moment storage with stochastic rounding
(counterpart of hma_tpu/train/lowp.py).

Storing Adam's m and v in bfloat16 halves the optimizer state: 8 bytes a
parameter instead of 12 with fp32 moments (the 1.5B-parameter d512 STMAR
card saves about 6 GB). All arithmetic stays fp32: a moment is upcast on
read and stochastically rounded on write. Nearest rounding would stall
the second moment, whose step (1 - beta2 = 1e-3 of its size) is far below
bf16's ~2^-8 resolution; stochastic rounding makes each write unbiased.

The rounding is an integer bit trick: an fp32 with its low 16 mantissa
bits cleared is the bf16 neighbour below it in magnitude, so adding 16
uniform random bits to the raw bits and clearing the low half rounds to
either neighbour with probability proportional to proximity.

The random bits of a write are drawn from the optimizer's step count, the
parameter's place in the model and whether it is m or v
(`MomentNoise`), so a resumed run writes the same moments as a straight
one; tests hand the bits in instead.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

# the seeds' first words, as hma_tpu's PRNGKey(0x10AD) / PRNGKey(0x51AD)
DENSE_TAG = 0x10AD   # the dense AdamW's moments
SLICED_TAG = 0x51AD  # the domain-sliced AdamW's stacked rows


def stochastic_round(x: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Unbiased stochastic rounding of `x` (read as fp32) to bfloat16.

    noise: an integer tensor of x's shape whose low 16 bits are the random
    bits (the rest are ignored). Non-finite values are cast directly, as
    XLA casts them (inf stays inf, NaN becomes the quiet NaN 0x7FC0 with
    its sign): adding bits to their patterns would scramble them. The bf16
    patterns are built as integers, so no float conversion (whose NaN
    pattern differs between backends) takes part."""
    x = x.float().contiguous()
    bits = x.view(torch.int32)
    finite = torch.isfinite(x)
    # non-finite values get no bits, so no sum crosses the sign bit
    out = torch.where(finite, bits + (noise.to(torch.int32) & 0xFFFF), bits)
    out = torch.where(torch.isnan(x), (bits & -0x80000000) | 0x7FC00000, out)
    return (out >> 16).to(torch.int16).view(torch.bfloat16)


class MomentNoise:
    """The random bits of one optimizer update: `bits(leaf, which, shape)`
    for parameter number `leaf` and moment `which` (0 for m, 1 for v),
    drawn from a generator seeded by (tag, count, leaf, which).

    The bits are drawn at the parameter's whole shape whatever its
    sharding, as `hma_tpu`'s are: a rank takes its piece of the draw (its
    tp part, then its fsdp shard: `step.AdamW`), so that sharded ranks write
    the moments one process writes. The draw is transient and full-size
    (its int32 bits: 4 bytes an element of the leaf, or of the row for a
    stacked table's update)."""

    def __init__(self, tag: int, count: int, device):
        self.tag, self.count = tag, int(count)
        self.device = torch.device(device)
        self.generator = torch.Generator(self.device)

    def bits(self, leaf: int, which: int, shape) -> torch.Tensor:
        """The bits at the whole `shape`."""
        seed = np.random.SeedSequence([self.tag, self.count, leaf, which])
        self.generator.manual_seed(int(seed.generate_state(1, np.uint64)[0] >> 1))
        bits = torch.randint(0, 1 << 16, tuple(shape), generator=self.generator,
                             device=self.device, dtype=torch.int32)
        return bits


def resolve_moment_dtype(spec: Optional[str]) -> Optional[torch.dtype]:
    """CLI string -> torch.bfloat16, or None for fp32 moments."""
    if spec in (None, "", "float32", "fp32", torch.float32):
        return None
    if spec in ("bfloat16", "bf16", torch.bfloat16):
        return torch.bfloat16
    raise ValueError(f"unsupported adam_moment_dtype: {spec!r}")


def adamw_lowp_(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                count: int, lr: float, wd: float, b1: float, b2: float, eps: float,
                ok_f: torch.Tensor, m_bits: torch.Tensor, v_bits: torch.Tensor) -> None:
    """One optax adamw update of fp32 p in place with m and v stored low
    precision: m32 = b1 m + (1 - b1) g and v32 = b2 v + (1 - b2) g^2 in fp32
    (m, v upcast on read), p += -lr (m32_hat / (sqrt(v32_hat) + eps) + wd p)
    * ok_f, then m and v are written back stochastically rounded with the
    bits m_bits and v_bits."""
    m32 = b1 * m.float() + (1 - b1) * g
    v32 = b2 * v.float() + (1 - b2) * g.square()
    u = (m32 / (1 - b1**count)) / ((v32 / (1 - b2**count)).sqrt() + eps)
    if wd:
        u.add_(p, alpha=wd)
    p.sub_(u.mul_(ok_f * lr))
    m.copy_(stochastic_round(m32, m_bits))
    v.copy_(stochastic_round(v32, v_bits))
