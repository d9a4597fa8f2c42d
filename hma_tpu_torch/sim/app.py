"""Arrow-key world-model demo (counterpart of hma_tpu/sim/app.py):
`build_simulator` loads a trained world model and its pixel codec into a
GenieSimulator, and `launch_app` serves it with gradio (imported there; it
is not a dependency of the package), direction buttons mapped to 2-D delta
actions.

    python -m hma_tpu_torch.sim.app --checkpoint_dir ckpt --tokenizer_ckpt magvit2.ckpt

Both backbones load: STMaskGIT with the MagVit2 decoder, and STMAR with the
SVD temporal VAE's decoder (latents out when no VAE checkpoint is given). One
extra flag, `--device` (default: the CUDA card; raises if there is none).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from hma_tpu_torch import resolve_device
from hma_tpu_torch.config import DiffusionGenieConfig, load_config
from hma_tpu_torch.evaluate_feature import load_mar_model
from hma_tpu_torch.generate import load_model
from hma_tpu_torch.rollout.decode import decode_clips, load_svd_decoder, make_token_decoder
from hma_tpu_torch.sim.simulator import GenieSimulator
from hma_tpu_torch.tokenizer.convert import load_magvit2
from hma_tpu_torch.utils.checkpoint import CONFIG_FILE, resolve_checkpoint

# direction -> 2-D delta action
DIRECTION_ACTIONS = {
    "up": np.asarray([-0.05, 0.0], np.float32),
    "down": np.asarray([0.05, 0.0], np.float32),
    "left": np.asarray([0.0, -0.05], np.float32),
    "right": np.asarray([0.0, 0.05], np.float32),
    "noop": np.asarray([0.0, 0.0], np.float32),
}


def _is_continuous(checkpoint_dir: str) -> bool:
    config = load_config(str(resolve_checkpoint(checkpoint_dir) / CONFIG_FILE))
    return isinstance(config, DiffusionGenieConfig)


def _make_latent_decoder(vae_checkpoint: str, dtype=None, device=None):
    """The STMAR simulator's pixels: (N, h, w, C) latents x SVD_SCALE ->
    (N, 8h, 8w, 3) uint8 through the SVD-VAE's temporal decoder, the N frames
    as one clip, the RAW (unscaled) latents clamped to +/-25."""
    decode = load_svd_decoder(vae_checkpoint, dtype, device)
    return lambda lat_nhwc: decode_clips(decode, np.asarray(lat_nhwc, np.float32)[None])[0]


def build_simulator(checkpoint_dir: str, tokenizer_ckpt, domain: str = "language_table",
                    prompt_horizon: int = 3, backbone: str = "auto",
                    device=None) -> GenieSimulator:
    """backbone: "auto" (from the checkpoint's card), "stmaskgit" or "stmar".
    For stmaskgit, tokenizer_ckpt is the MagVit2 checkpoint; for stmar the
    diffusers SVD-VAE state-dict file (None: latents out). On the CUDA card
    in bf16 unless `device` says otherwise (fp32 on the CPU)."""
    device = resolve_device(device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    if backbone == "auto":
        backbone = "stmar" if _is_continuous(checkpoint_dir) else "stmaskgit"
    if backbone == "stmar":
        model, config = load_mar_model(checkpoint_dir, device, dtype)
        decode_kw = {"decode_latents": (_make_latent_decoder(tokenizer_ckpt, dtype, device)
                                        if tokenizer_ckpt else None)}
    else:
        model, config = load_model(checkpoint_dir, device, dtype)
        decode_kw = {"decode_tokens": make_token_decoder(
            *load_magvit2(tokenizer_ckpt), dtype=dtype, device=device)}
    domains = config.action_domains or []
    domain_id = domains.index(domain) if domain in domains else 0
    return GenieSimulator(model, domain_id=domain_id, prompt_horizon=prompt_horizon,
                          **decode_kw)


def launch_app(sim: GenieSimulator, share: bool = False):
    import gradio as gr

    def handle(direction):
        return sim.step(DIRECTION_ACTIONS[direction])

    with gr.Blocks(title="HMA interactive world model") as demo:
        img = gr.Image(label="world")
        with gr.Row():
            for d in ["up", "down", "left", "right", "noop"]:
                gr.Button(d).click(lambda d=d: handle(d), outputs=img)
    demo.launch(share=share)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint_dir", type=str, required=True)
    p.add_argument("--tokenizer_ckpt", type=str, default="data/magvit2.ckpt")
    p.add_argument("--domain", type=str, default="language_table")
    p.add_argument("--prompt_horizon", type=int, default=3)
    p.add_argument("--backbone", type=str, default="auto",
                   choices=["auto", "stmaskgit", "stmar"])
    p.add_argument("--share", action="store_true")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; raises without a card)")
    args = p.parse_args(argv)
    sim = build_simulator(args.checkpoint_dir, args.tokenizer_ckpt, args.domain,
                          args.prompt_horizon, args.backbone, args.device)
    launch_app(sim, args.share)


if __name__ == "__main__":
    main()
