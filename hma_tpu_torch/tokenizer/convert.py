"""MagVit2 checkpoints (counterpart of hma_tpu/tokenizer/convert.py).

`load_magvit2` reads the reference's torch `.ckpt` (`magvit2.ckpt` of HF
1x-technologies/worldmodel), whose `encoder.*` / `decoder.*` keys are this
package's `VQModel` state-dict keys; the EMA shadow weights (LitEma, stored
as `model_ema.<name with dots stripped>`) take priority, since the reference
encodes and decodes under `ema_scope()`. It also reads a directory written
by this package's `train_tokenizer` (`save_tokenizer_checkpoint`: tags
holding `tokenizer.pt` with the generator and its EMA, and a `vq_config.json`
sidecar). `params_from_flax` takes a `hma_tpu` VQModel parameter tree (numpy)
to that state dict, the inverse of `hma_tpu`'s `torch_state_dict_to_flax`;
`disc_params_from_flax` does the same for the discriminator's variables.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from hma_tpu_torch.tokenizer.magvit2 import VQConfig, VQModel
from hma_tpu_torch.utils.checkpoint import latest_checkpoint, prune_checkpoints

TOKENIZER_FILE = "tokenizer.pt"

# flax module names -> torch module paths (`down_0_block_1` -> `down.0.block.1`)
_MODULE_NAMES = [(re.compile(r"(down|up)_(\d+)_block_(\d+)"), r"\1.\2.block.\3"),
                 (re.compile(r"down_(\d+)_downsample"), r"down.\1.downsample"),
                 (re.compile(r"up_(\d+)_upsample"), r"up.\1.upsample"),
                 (re.compile(r"mid_block_(\d+)"), r"mid_block.\1")]
_LEAF_NAMES = {"kernel": "weight", "scale": "weight", "bias": "bias"}


def _torch_name(path: tuple) -> str:
    parts = []
    for name in path[:-1]:
        for pattern, repl in _MODULE_NAMES:
            if pattern.fullmatch(name):
                name = pattern.sub(repl, name)
                break
        parts.append(name)
    return ".".join(parts + [_LEAF_NAMES[path[-1]]])


def params_from_flax(tree: dict) -> Dict[str, torch.Tensor]:
    """A `hma_tpu` VQModel parameter tree ({"params": ...} or its inner
    dict; numpy leaves) -> this package's VQModel state dict, fp32: conv
    kernels (kh, kw, I, O) -> (O, I, kh, kw), GroupNorm `scale` -> `weight`."""
    tree = tree.get("params", tree)
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
            return
        value = np.asarray(node, np.float32)
        if path[-1] == "kernel":
            value = value.transpose(3, 2, 0, 1)
        out[_torch_name(path)] = torch.from_numpy(np.ascontiguousarray(value))

    walk(tree, ())
    return out


def disc_params_from_flax(variables: dict, n_layers: int = 3) -> Dict[str, torch.Tensor]:
    """A `hma_tpu` NLayerDiscriminator's variables ({"params": ...,
    "batch_stats": ...}, numpy leaves) -> this package's state dict, fp32:
    conv{n} and bn{n} to their `main.{i}` slots, BatchNorm `scale` ->
    `weight`, `mean` / `var` -> `running_mean` / `running_var`."""
    slots = {"conv0": 0, f"conv{n_layers}": 3 * n_layers - 1,
             "conv_out": 3 * n_layers + 2}
    for n in range(1, n_layers):
        slots[f"conv{n}"] = 3 * n - 1
    for n in range(1, n_layers + 1):
        slots[f"bn{n}"] = 3 * n
    leaf = {"kernel": "weight", "scale": "weight", "bias": "bias",
            "mean": "running_mean", "var": "running_var"}
    out = {}
    for coll in ("params", "batch_stats"):
        for mod, leaves in variables.get(coll, {}).items():
            for name, value in leaves.items():
                value = np.array(value, np.float32)  # a writable copy
                if name == "kernel":
                    value = value.transpose(3, 2, 0, 1)
                out[f"main.{slots[mod]}.{leaf[name]}"] = torch.from_numpy(
                    np.ascontiguousarray(value))
    return out


def save_tokenizer_checkpoint(output_dir: str, tag: str, gen_state: dict, ema_state: dict,
                              keep_last: Optional[int] = None) -> str:
    """Write output_dir/<tag>/tokenizer.pt holding {"gen": ..., "ema": ...}
    (fp32 state dicts on the CPU); step_<n> tags past `keep_last` are
    pruned, oldest first. Returns the tag's path."""
    out = Path(output_dir) / tag
    out.mkdir(parents=True, exist_ok=True)
    torch.save({k: {n: v.detach().float().cpu() for n, v in sd.items()}
                for k, sd in (("gen", gen_state), ("ema", ema_state))}, out / TOKENIZER_FILE)
    if keep_last:
        prune_checkpoints(output_dir, keep_last)
    return str(out)


def _load_trained(ckpt_dir: str, use_ema: bool):
    """(state_dict, VQConfig) of a train_tokenizer directory: a tag holding
    `tokenizer.pt`, or a run directory (its newest step_<n> tag, else
    `final_checkpt`, as hma_tpu chooses: a run whose last steps fall after
    its last step_<n> gives that tag, not `final_checkpt`); the sidecar
    `vq_config.json` is looked for in the tag, then beside it, else the
    config is `VQConfig()`."""
    tagged = Path(ckpt_dir)
    if not (tagged / TOKENIZER_FILE).exists() and not (tagged / "state").is_dir():
        found = latest_checkpoint(ckpt_dir)
        if found is None:
            raise FileNotFoundError(
                f"no tokenizer checkpoint under '{ckpt_dir}' (expected {TOKENIZER_FILE} "
                "or step_*/final_checkpt tags)")
        tagged = Path(found)
    if (tagged / "state").is_dir():
        raise NotImplementedError(
            f"{tagged} is an orbax checkpoint written by hma_tpu.train_tokenizer: this "
            "package reads no orbax (it imports nothing of JAX); train with "
            "hma_tpu_torch.train_tokenizer, or pass a torch .ckpt")
    config = VQConfig()
    for cand in (tagged / "vq_config.json", tagged.parent / "vq_config.json"):
        if cand.exists():
            config = VQConfig.from_pretrained(str(cand))
            break
    tree = torch.load(tagged / TOKENIZER_FILE, map_location="cpu", weights_only=True)
    return tree["ema" if use_ema else "gen"], config


def _resolve_ema(state_dict: dict) -> dict:
    """Overlay LitEma shadow weights (keys 'model_ema.<name with dots
    stripped>') onto their originals."""
    ema = {k[len("model_ema."):]: v for k, v in state_dict.items()
           if k.startswith("model_ema.") and k not in
           ("model_ema.num_updates", "model_ema.decay")}
    if not ema:
        return state_dict
    out = dict(state_dict)
    for name in state_dict:
        stripped = name.replace(".", "")
        if stripped in ema:
            out[name] = ema[stripped]
    return out


def load_magvit2(ckpt_path: str, use_ema: bool = True):
    """(state_dict, VQConfig) of a reference torch `.ckpt` file or of a
    `train_tokenizer` directory, its `encoder.*` and `decoder.*` tensors in
    fp32 (quantizer, loss-net and discriminator keys are ignored), checked
    key for key and shape for shape against the VQModel of the config. The
    EMA weights are taken unless `use_ema` is False. A file's config comes
    from a sidecar JSON, `<ckpt_path>.json` or `vq_config.json` beside the
    file (written by `VQConfig.save_pretrained`), else `VQConfig()`, the
    released architecture. A directory of hma_tpu's orbax checkpoints
    raises NotImplementedError."""
    if os.path.isdir(ckpt_path):
        state, config = _load_trained(ckpt_path, use_ema)
    elif not os.path.exists(ckpt_path):
        raise FileNotFoundError(
            f"MagVit2 checkpoint not found at '{ckpt_path}'. Download it from "
            "HF 1x-technologies/worldmodel (magvit2.ckpt) as in the reference "
            "build.sh, then pass --tokenizer_ckpt / --encoder_name_or_path.")
    else:
        # a Lightning checkpoint pickles its hyper-parameters beside the tensors
        ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=False)
        state = ckpt.get("state_dict", ckpt)
        if use_ema:
            state = _resolve_ema(state)
        config = VQConfig()
        for cand in (ckpt_path + ".json",
                     os.path.join(os.path.dirname(os.path.abspath(ckpt_path)),
                                  "vq_config.json")):
            if os.path.exists(cand):
                config = VQConfig.from_pretrained(cand)
                break
    state = {k: torch.as_tensor(v).float() for k, v in state.items()
             if k.split(".")[0] in ("encoder", "decoder")}
    want = VQModel(config, dtype=torch.float32, device="meta").state_dict()
    missing, unexpected = sorted(set(want) - set(state)), sorted(set(state) - set(want))
    wrong = [k for k in want if k in state and state[k].shape != want[k].shape]
    if missing or unexpected or wrong:
        raise ValueError(f"{ckpt_path} does not fit the tokenizer config: missing "
                         f"{missing}, unexpected {unexpected}, wrong shapes {wrong}")
    return state, config
