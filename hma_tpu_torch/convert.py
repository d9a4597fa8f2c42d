"""Turn an `hma_tpu` STMaskGIT or STMAR param tree into this port's
`state_dict`.

The tree is the nested dict of arrays that the model's `init` / a checkpoint
gives (with or without the top-level "params" key), in the loop layout
(`decoder/layers_<i>`) or the scan layout (`decoder/layers_scan/block`,
stacked on a leading layer axis). Names map one to one:

  - `layers_<i>`, `factored_embeds_<i>` -> `layers.<i>`, `factored_embeds.<i>`;
  - a flax `nn.Dense` kernel (in, out) -> `weight` (out, in);
  - a flax `nn.LayerNorm` scale -> `weight`; `nn.Embed` embedding -> `weight`;
  - stacked per-domain tables (`kernel` (nd, in, out), `scale`/`bias`
    (nd, C)) and everything else pass through unchanged: STMAR's raw
    parameters (`pos_embed_TSC`, `diffusion_pos_embed_learned`,
    `mask_token`, `action_mask_tokens`) and the domain-stacked
    `action_diff_loss/net/*` among them. The plain head's
    `diffloss/net/{time_embed/fc1, res_<i>_adaLN, ...}` are Dense and
    LayerNorm leaves like any other.

With `tp=(rank, size)` the state is that rank's tensor-parallel part:
every leaf `hma_tpu`'s param_spec splits over "tp" (`mesh.tp_dim`) is cut
to the rank's columns, dealt by head or feature as
`parallel.tensor_parallel.split_model` holds them, so it loads into a model
split at that size.
"""

from __future__ import annotations

import re
from typing import Optional

import numpy as np
import torch

from hma_tpu_torch.config import GenieConfig
from hma_tpu_torch.parallel.mesh import tp_dim
from hma_tpu_torch.parallel.tensor_parallel import CHUNKS, Part, take

_INDEXED = re.compile(r"^(layers|factored_embeds)_(\d+)$")


def unstack_layer_params(dec_params: dict, num_layers: int) -> dict:
    """Scan layout {'layers_scan': {'block': stacked (L, ...)}} -> loop
    layout {'layers_<i>': {...}} (own copy of the `hma_tpu` helper)."""
    def take(tree, i):
        if isinstance(tree, dict):
            return {k: take(v, i) for k, v in tree.items()}
        return np.asarray(tree)[i]

    stacked = dec_params["layers_scan"]["block"]
    out = {k: v for k, v in dec_params.items() if k != "layers_scan"}
    for i in range(num_layers):
        out[f"layers_{i}"] = take(stacked, i)
    return out


def _flatten(tree: dict, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def params_from_jax(tree: dict, cfg: GenieConfig, tp: Optional[tuple] = None) -> dict:
    """hma_tpu param tree (numpy or jax arrays) -> torch state_dict (fp32);
    with `tp` (rank, size), the rank's tensor-parallel part of it."""
    if "params" in tree:
        tree = tree["params"]
    if "layers_scan" in tree.get("decoder", {}):
        tree = {**tree, "decoder": unstack_layer_params(tree["decoder"],
                                                        cfg.num_layers)}
    state = {}
    for path, value in _flatten(tree):
        arr = np.array(value, dtype=np.float32)
        *mods, leaf = path
        parent = mods[-1] if mods else ""
        dim = None if tp is None else tp_dim(parent, leaf, arr.shape, tp[1])
        mods = [".".join(m.groups()) if (m := _INDEXED.match(p)) else p
                for p in mods]
        if leaf == "kernel" and arr.ndim == 2:
            leaf, arr = "weight", arr.T
            dim = None if dim is None else 1 - dim
        elif leaf == "scale" and arr.ndim == 1:
            leaf = "weight"
        elif leaf == "embedding":
            leaf = "weight"
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if dim is not None:
            t = take(t, Part(dim, CHUNKS.get(parent, 1), tuple(t.shape)), *tp)
        state[".".join([*mods, leaf])] = t
    return state
