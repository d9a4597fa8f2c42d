"""Turn an `hma_tpu` STMaskGIT param tree into this port's `state_dict`.

The tree is the nested dict of arrays that `STMaskGIT.init` / a checkpoint
gives (with or without the top-level "params" key), in the loop layout
(`decoder/layers_<i>`) or the scan layout (`decoder/layers_scan/block`,
stacked on a leading layer axis). Names map one to one:

  - `layers_<i>`, `factored_embeds_<i>` -> `layers.<i>`, `factored_embeds.<i>`;
  - a flax `nn.Dense` kernel (in, out) -> `weight` (out, in);
  - a flax `nn.LayerNorm` scale -> `weight`; `nn.Embed` embedding -> `weight`;
  - stacked per-domain tables (`kernel` (nd, in, out), `scale`/`bias`
    (nd, C)) and everything else pass through unchanged.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from hma_tpu_torch.config import GenieConfig

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


def params_from_jax(tree: dict, cfg: GenieConfig) -> dict:
    """hma_tpu param tree (numpy or jax arrays) -> torch state_dict (fp32)."""
    if "params" in tree:
        tree = tree["params"]
    if "layers_scan" in tree.get("decoder", {}):
        tree = {**tree, "decoder": unstack_layer_params(tree["decoder"],
                                                        cfg.num_layers)}
    state = {}
    for path, value in _flatten(tree):
        arr = np.array(value, dtype=np.float32)
        *mods, leaf = path
        mods = [".".join(m.groups()) if (m := _INDEXED.match(p)) else p
                for p in mods]
        if leaf == "kernel" and arr.ndim == 2:
            leaf, arr = "weight", arr.T
        elif leaf == "scale" and arr.ndim == 1:
            leaf = "weight"
        elif leaf == "embedding":
            leaf = "weight"
        state[".".join([*mods, leaf])] = torch.from_numpy(np.ascontiguousarray(arr))
    return state
