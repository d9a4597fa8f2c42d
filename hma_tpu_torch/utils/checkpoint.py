"""Port checkpoints: a directory holding `config.json` (the model card, in
the `hma_tpu` format) and `model.pt` (a `torch.save`d fp32 state_dict)."""

from __future__ import annotations

from pathlib import Path

import torch

from hma_tpu_torch.config import GenieConfig, load_config
from hma_tpu_torch.models.st_mask_git import STMaskGIT

CONFIG_FILE = "config.json"
STATE_FILE = "model.pt"


def save_checkpoint(ckpt_dir: str, state_dict: dict, config: GenieConfig) -> str:
    out = Path(ckpt_dir)
    out.mkdir(parents=True, exist_ok=True)
    config.save_pretrained(str(out / CONFIG_FILE))
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()},
               out / STATE_FILE)
    return str(out)


def load_checkpoint(ckpt_dir: str, device, dtype=torch.bfloat16):
    """(model, config) with the saved weights, built on `device`."""
    config = load_config(str(Path(ckpt_dir) / CONFIG_FILE))
    state = torch.load(Path(ckpt_dir) / STATE_FILE, map_location=device,
                       weights_only=True)
    model = STMaskGIT(config, dtype=dtype, device=device)
    model.load_state_dict(state)
    return model.eval(), config
