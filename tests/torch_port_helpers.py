"""Shared set-up for the tests/test_torch_*.py files: one tiny discrete
card built in both packages, JAX weights converted into the port."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from hma_tpu.config import GenieConfig as JaxGenieConfig
from hma_tpu.models.st_mask_git import STMaskGIT as JaxSTMaskGIT
from hma_tpu_torch.config import GenieConfig
from hma_tpu_torch.convert import params_from_jax
from hma_tpu_torch.models.st_mask_git import STMaskGIT


def tiny_card(qk_norm: bool = False,
              action_network: str = "concat+modulate") -> dict:
    """2 layers, 2 heads, d 32, T 4, S 16, 8 concat action tokens,
    1 domain (as tests/test_rollout.py)."""
    return dict(num_layers=2, num_heads=2, d_model=32, T=4, S=16,
                image_vocab_size=2**18, num_factored_vocabs=2,
                action_token_size=8, action_network=action_network,
                use_actions=True, action_domains=["a"], d_actions=[4],
                action_stats=[[[0.1, -0.2], [1.5, 0.5]]], qk_norm=qk_norm)


def build_pair(qk_norm: bool = False, B: int = 2, seed: int = 0,
               action_network: str = "concat+modulate"):
    """(jax_model, jax_params, torch_model, tokens, actions) in fp32.

    Every parameter is perturbed with noise after init so that zero-init
    tensors (positional embedding, biases, mask tokens) are exercised by
    the conversion too. tokens (B, T, S) int32 with some mask ids;
    actions (B, T, max_d_action) float32."""
    card = tiny_card(qk_norm, action_network)
    jcfg = JaxGenieConfig(**card)
    jm = JaxSTMaskGIT(jcfg, dtype=jnp.float32)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, jcfg.image_vocab_size,
                          (B, jcfg.T, jcfg.S)).astype(np.int32)
    tokens[:, -1, ::3] = jcfg.image_vocab_size
    actions = rng.normal(size=(B, jcfg.T, jcfg.max_d_action)).astype(np.float32)
    params = jm.init({"params": jax.random.PRNGKey(seed)}, tokens, tokens,
                     actions, jnp.asarray(0, jnp.int32))
    params = jax.tree.map(
        lambda x: np.asarray(x) + 0.02 * rng.normal(size=x.shape).astype(np.float32),
        params)
    cfg = GenieConfig(**card)
    tm = STMaskGIT(cfg, dtype=torch.float32, device="cpu")
    tm.load_state_dict(params_from_jax(params, cfg))
    return jm, params, tm, tokens, actions


def to_torch(x: np.ndarray) -> torch.Tensor:
    x = np.asarray(x)
    return torch.from_numpy(x.astype(np.int64) if x.dtype.kind in "iu" else x)
