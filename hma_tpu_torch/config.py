"""Model configuration with JSON (de)serialization.

Own copy of `hma_tpu.config.GenieConfig` / `load_config` (the port imports
nothing of `hma_tpu`). Field names and defaults are identical, so a
`config.json` written by either package loads in the other. Only the
discrete family lives here for now; `load_config` refuses a continuous
(`"Diffusion": true`) card until the STMAR family is ported.
"""

from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass
from typing import List, Optional


def nth_root(x: int, n: int) -> int:
    """Integer n-th root with exactness check."""
    root = round(x ** (1 / n))
    if root**n != x:
        raise ValueError(f"{x} is not a perfect {n}-th power")
    return root


@dataclass
class GenieConfig:
    """Configuration for the discrete STMaskGIT model."""

    num_layers: int
    num_heads: int
    d_model: int
    T: int = 12  # temporal sequence length
    S: int = 256  # spatial sequence length, e.g. 256 for 16x16
    image_vocab_size: int = 262144  # number of distinct image tokens (2**18)
    use_mup: bool = False
    dataloader_apply_mask: bool = True
    dataloader_apply_corruption: bool = True
    dataloader_mask_ratio_min: float = 0.2
    drop_action_ratio: float = 0.0
    arch: str = "STTransformerDecoder"
    random_dummy_action: bool = True

    # Factorization for large vocabs (e.g. Open-MAGVIT2): 2**18 -> 2 x 512
    num_factored_vocabs: int = 1
    factored_vocab_size: Optional[int] = None

    # MaskGIT training
    max_corrupt_rate: float = 0.2
    non_mlm_ratio: float = 0.2
    num_prompt_frames: int = 4

    # Action conditioning
    init_actions: bool = False
    d_action: int = 28
    use_actions: bool = True
    action_domains: Optional[List[str]] = None
    d_actions: Optional[List[int]] = None
    action_stats: Optional[list] = None  # per-domain [mean, std] lists
    action_network: str = "mlp"
    cross_attention_compat: str = "fixed"
    shared_action_mlps: bool = True
    action_contrastive_loss: bool = False
    jointly_predict_actions: bool = False
    jointly_predict_states: bool = True
    action_token_size: int = 64
    label_drop_prob: float = 0.5
    action_loss_weight: float = 0.5

    # Attention
    qkv_bias: bool = False
    proj_bias: bool = True
    attn_drop: float = 0.0
    qk_norm: bool = True

    # MLP
    mlp_ratio: float = 4.0
    mlp_drop: float = 0.0
    mlp_bias: bool = True

    def __post_init__(self):
        if self.image_vocab_size is None:
            self.factored_vocab_size = 64  # dummy, matching the reference
        else:
            self.factored_vocab_size = nth_root(self.image_vocab_size,
                                                self.num_factored_vocabs)

    def save_pretrained(self, json_path: str) -> None:
        with open(json_path, "w") as f:
            json.dump(dataclasses.asdict(self), f)

    @classmethod
    def from_pretrained(cls, json_path: str) -> "GenieConfig":
        with open(json_path) as f:
            raw = json.load(f)
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in raw.items() if k in names})

    @property
    def h(self) -> int:
        side = math.isqrt(self.S)
        if side * side != self.S:
            raise ValueError(f"S={self.S} is not square")
        return side

    @property
    def w(self) -> int:
        return self.h

    @property
    def mask_token_id(self) -> int:
        return self.image_vocab_size

    @property
    def num_domains(self) -> int:
        return len(self.action_domains) if self.action_domains else 0

    @property
    def max_d_action(self) -> int:
        """All per-domain action vectors are zero-padded to this width."""
        if not self.d_actions:
            return self.d_action
        return max(self.d_actions)


def load_config(path: str) -> GenieConfig:
    """Load a discrete model card from a JSON file."""
    with open(path) as f:
        raw = json.load(f)
    if raw.get("Diffusion", False):
        raise NotImplementedError(
            "continuous (STMAR) cards are not ported yet: ROADMAP.md Queue A, "
            "the STMAR family")
    return GenieConfig.from_pretrained(path)
