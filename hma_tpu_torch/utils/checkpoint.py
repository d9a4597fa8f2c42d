"""Port checkpoints (counterpart of hma_tpu/utils/checkpoint.py).

`save_checkpoint(output_dir, tag, ...)` writes `output_dir/<tag>/` holding
`config.json` (the model card, in the `hma_tpu` format), `model.pt` (a
`torch.save`d fp32 state_dict) and, for a training checkpoint,
`train_state.pt` (the optimizer state and the step). `step_<n>` and
`epoch_<n>` directories past `keep_last` are pruned, oldest first; no
other directory (`final_checkpt`, `epoch_1_pinned`) ever is.
`load_checkpoint` builds the model for rollout from a checkpoint directory
or from a run directory (its newest one).
"""

from __future__ import annotations

import re
import shutil
from pathlib import Path
from typing import Optional

import torch

from hma_tpu_torch.config import GenieConfig, load_config
from hma_tpu_torch.models.st_mask_git import STMaskGIT

CONFIG_FILE = "config.json"
STATE_FILE = "model.pt"
TRAIN_FILE = "train_state.pt"


def save_checkpoint(output_dir: str, tag: str, model_state: dict,
                    config: GenieConfig, *, opt_state: Optional[dict] = None,
                    step: Optional[int] = None, keep_last: Optional[int] = None) -> str:
    """Write output_dir/<tag>/; returns its path. With `opt_state` or
    `step`, also the training state that `load_train_state` reads."""
    out = Path(output_dir) / tag
    out.mkdir(parents=True, exist_ok=True)
    config.save_pretrained(str(out / CONFIG_FILE))
    torch.save({k: v.detach().cpu() for k, v in model_state.items()},
               out / STATE_FILE)
    if opt_state is not None or step is not None:
        torch.save({"opt_state": _to_cpu(opt_state), "step": step}, out / TRAIN_FILE)
    if keep_last:
        prune_checkpoints(output_dir, keep_last)
    return str(out)


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.detach().cpu() if torch.is_tensor(tree) else tree


def _step_dirs(output_dir: str) -> list[tuple[float, Path]]:
    """Checkpoint dirs, oldest first: by their counter when all share one
    prefix, by mtime when step_ and epoch_ dirs are mixed."""
    out = Path(output_dir)
    if not out.is_dir():
        return []
    dirs = []
    for d in out.iterdir():
        m = re.fullmatch(r"(step|epoch)_(\d+)", d.name)
        if m and d.is_dir():
            dirs.append((m.group(1), int(m.group(2)), d))
    if len({kind for kind, _, _ in dirs}) <= 1:
        return [(float(n), d) for _, n, d in sorted(dirs, key=lambda x: x[1])]
    return sorted((d.stat().st_mtime, d) for _, _, d in dirs)


def prune_checkpoints(output_dir: str, keep_last: int) -> None:
    for _, d in _step_dirs(output_dir)[:-keep_last] if keep_last > 0 else []:
        shutil.rmtree(d, ignore_errors=True)


def latest_checkpoint(output_dir: str) -> Optional[str]:
    """Newest step/epoch dir, else `final_checkpt` if present, else None."""
    dirs = _step_dirs(output_dir)
    if dirs:
        return str(dirs[-1][1])
    final = Path(output_dir) / "final_checkpt"
    return str(final) if final.is_dir() else None


def resolve_checkpoint(ckpt_dir: str) -> Path:
    """`ckpt_dir` itself when it holds a model, else its newest checkpoint."""
    path = Path(ckpt_dir)
    if (path / STATE_FILE).exists():
        return path
    newest = latest_checkpoint(ckpt_dir)
    if newest is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    return Path(newest)


def load_checkpoint(ckpt_dir: str, device, dtype=torch.bfloat16):
    """(model, config) with the saved weights, built on `device`, in eval
    mode; `ckpt_dir` is a checkpoint or a run directory."""
    path = resolve_checkpoint(ckpt_dir)
    config = load_config(str(path / CONFIG_FILE))
    state = torch.load(path / STATE_FILE, map_location=device, weights_only=True)
    model = STMaskGIT(config, dtype=dtype, device=device)
    model.load_state_dict(state)
    return model.eval(), config


def load_train_state(ckpt_dir: str, device) -> tuple[dict, dict, int]:
    """(model state_dict, optimizer state, step) of a training checkpoint."""
    path = resolve_checkpoint(ckpt_dir)
    model_state = torch.load(path / STATE_FILE, map_location=device, weights_only=True)
    train = torch.load(path / TRAIN_FILE, map_location=device, weights_only=True)
    return model_state, train["opt_state"], int(train["step"])
