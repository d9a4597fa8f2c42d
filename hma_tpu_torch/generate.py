"""Rollout CLI: `python -m hma_tpu_torch.generate ...`

Counterpart of `hma_tpu.generate`: loads a port checkpoint
(`utils.checkpoint`), rolls out future frames with the KV-cached MaskGIT
engine (or teacher-forced), and writes the [prompt | prediction | ground
truth] stream to `video.bin` + `metadata.json` in the same layout.
`--use_feature` switches to the continuous family: an STMAR checkpoint
rolls out VAE latents with the KV-cached MAR engine and `video.bin` holds
float16 (N, C, h, w) raw latents, the layout `RawFeatureDataset` reads. One
extra flag: `--device` (default: the CUDA card; raises if there is none).
The model computes in bf16 on the card and in fp32 on the CPU.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from hma_tpu_torch import resolve_device
from hma_tpu_torch.config import DiffusionGenieConfig
from hma_tpu_torch.data.datasets import SVD_SCALE, RawFeatureDataset, RawTokenDataset
from hma_tpu_torch.rollout.mar import make_mar_generator, teacher_forced_latents
from hma_tpu_torch.rollout.maskgit import make_generator, teacher_forced_logits
from hma_tpu_torch.train.trainer import _pad_actions
from hma_tpu_torch.utils.checkpoint import load_checkpoint


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Autoregressive MaskGIT rollout")
    p.add_argument("--checkpoint_dir", type=str, required=True)
    p.add_argument("--val_data_dir", type=str, required=True)
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--domain", type=str, default=None)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--maskgit_steps", type=int, default=None,
                   help="default: 2 (discrete) / the model card's "
                        "maskgit_steps (--use_feature)")
    p.add_argument("--temperature", type=float, default=None,
                   help="default: 0.0 greedy (discrete) / 1.0 (--use_feature)")
    p.add_argument("--num_prompt_frames", type=int, default=8)
    p.add_argument("--window_size", type=int, default=None,
                   help="frames per rollout window (default: the model "
                        "card's T; must be <= T)")
    p.add_argument("--example_ind", type=int, default=0)
    p.add_argument("--max_examples", "--max_example", type=int, default=16)
    p.add_argument("--teacher_force_time", action="store_true")
    p.add_argument("--use_feature", action="store_true",
                   help="continuous family: STMAR checkpoint over VAE latents")
    p.add_argument("--cfg", type=float, default=1.0,
                   help="--use_feature classifier-free guidance scale "
                        "(doubled [cond|uncond] batch; uncond = the trained "
                        "action-dropout branch, so it needs a model trained "
                        "with jointly_predict_actions and drop_action_ratio > 0)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; raises without a card)")
    return p.parse_args(argv)


def load_model(checkpoint_dir: str, device, dtype=torch.bfloat16):
    """(model, config) of a discrete (STMaskGIT) checkpoint, in eval mode on
    `device`; `checkpoint_dir` is a checkpoint or a run directory (then its
    newest `step_*` one)."""
    model, config = load_checkpoint(checkpoint_dir, device, dtype)
    if isinstance(config, DiffusionGenieConfig):
        raise ValueError(f"{checkpoint_dir} holds a continuous (STMAR) model; "
                         "evaluate it with --use_feature")
    return model, config


def _load(args):
    """(model, config, device, window length T) for the CLI's arguments."""
    device = resolve_device(args.device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    model, config = load_checkpoint(args.checkpoint_dir, device, dtype)
    if args.use_feature != isinstance(config, DiffusionGenieConfig):
        raise ValueError("--use_feature is for a continuous (STMAR) checkpoint "
                         "and only for one; this one is "
                         f"{type(config).__name__}")
    T = args.window_size or config.T
    if T > config.T:
        raise ValueError(f"--window_size {T} exceeds the model's T={config.T}")
    if args.num_prompt_frames >= T:
        raise ValueError(f"--num_prompt_frames {args.num_prompt_frames} leaves "
                         f"no frames to generate in a {T}-frame window")
    return model, config, device, T


def _batch(args, dataset, config, device):
    """(items, B, domain, domain_id, actions on `device` or None)."""
    domain = args.domain or dataset.name
    domains = config.action_domains or []
    domain_id = domains.index(domain) if domain in domains else 0
    B = min(args.batch_size, args.max_examples)
    items = [dataset[args.example_ind + i] for i in range(B)]
    actions = None
    if "action_ids" in items[0]:
        actions = torch.from_numpy(_pad_actions(
            np.stack([it["action_ids"] for it in items]).astype(np.float32),
            config.max_d_action)).to(device)
    return items, B, domain, domain_id, actions


def _write(args, video: np.ndarray, meta: dict, what: str) -> None:
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    video.tofile(out / "video.bin")
    with open(out / "metadata.json", "w") as f:
        json.dump(meta, f)
    print(f"wrote {video.shape[0]} {what} to {out}")


def main(argv=None):
    args = parse_args(argv)
    if args.use_feature:
        return main_feature(args)
    model, config, device, T = _load(args)
    dataset = RawTokenDataset(args.val_data_dir, window_size=T,
                              use_actions=config.use_actions,
                              name=args.domain or "")
    items, B, domain, domain_id, actions = _batch(args, dataset, config, device)
    tokens = np.stack([it["input_ids"] for it in items]).reshape(B, T, -1)

    steps = args.maskgit_steps if args.maskgit_steps is not None else 2
    temperature = args.temperature if args.temperature is not None else 0.0
    generator = torch.Generator(device).manual_seed(args.seed)
    tokens_t = torch.from_numpy(tokens).to(device)
    if args.teacher_force_time:
        samples, _ = teacher_forced_logits(
            model, tokens_t, actions, domain_id, generator,
            maskgit_steps=steps, temperature=temperature)
        pred = np.concatenate([tokens[:, :1], samples.cpu().numpy()], axis=1)
    else:
        run = make_generator(model, num_prompt_frames=args.num_prompt_frames,
                             maskgit_steps=steps, temperature=temperature)
        pred = run(tokens_t, actions, domain_id, generator).cpu().numpy()

    # output layout [prompt | prediction | ground truth] per example
    h = w = config.h
    p = args.num_prompt_frames
    rows = [np.concatenate([tokens[i, :p], pred[i, p:], tokens[i, p:]])
            for i in range(B)]
    video = np.concatenate(rows).reshape(-1, h, w).astype(np.uint32)
    meta = {
        "num_images": int(video.shape[0]),
        "h": h, "w": w,
        "token_dtype": "uint32",
        "vocab_size": int(config.image_vocab_size),
        "name": domain,
        "num_prompt_frames": p,
        "window_size": int(T),
        "generation_layout": "prompt,pred,gt",
    }
    _write(args, video, meta, "frames")


def main_feature(args):
    """Continuous rollout: STMAR over VAE latents; writes [prompt | pred |
    gt] raw float16 latents in the `RawFeatureDataset` layout ((N, C, h, w),
    divided by SVD_SCALE). Honours --window_size and --teacher_force_time
    like the discrete path."""
    model, config, device, T = _load(args)
    dataset = RawFeatureDataset(args.val_data_dir, window_size=T,
                                use_actions=config.use_actions, domain=args.domain)
    items, B, domain, domain_id, actions = _batch(args, dataset, config, device)
    h, w, C = items[0]["h"], items[0]["w"], items[0]["c"]
    # items are (T*h*w, C) x SVD_SCALE; the MAR engine takes (B, T, h, w, C)
    lat = np.stack([it["input_ids"] for it in items]).reshape(
        B, T, h, w, C).astype(np.float32)

    temperature = args.temperature if args.temperature is not None else 1.0
    generator = torch.Generator(device).manual_seed(args.seed)
    lat_t = torch.from_numpy(lat).to(device)
    if args.teacher_force_time:
        frames = teacher_forced_latents(
            model, lat_t, actions, domain_id, generator,
            maskgit_steps=args.maskgit_steps, temperature=temperature, cfg=args.cfg)
        pred = np.concatenate([lat[:, :1], frames.cpu().numpy()], axis=1)
    else:
        run = make_mar_generator(model, num_prompt_frames=args.num_prompt_frames,
                                 maskgit_steps=args.maskgit_steps,
                                 temperature=temperature, cfg=args.cfg)
        pred = run(lat_t, actions, domain_id, generator).cpu().numpy()

    p = args.num_prompt_frames
    rows = [np.concatenate([lat[i, :p], pred[i, p:], lat[i, p:]]) for i in range(B)]
    # (N, h, w, C) x SVD_SCALE -> raw (N, C, h, w) float16 on disk
    video = (np.concatenate(rows) / SVD_SCALE).transpose(0, 3, 1, 2).astype(np.float16)
    meta = {
        "num_images": int(video.shape[0]),
        "h": h, "w": w,
        "latent_channels": int(C),
        "token_dtype": "float16",
        "name": domain,
        "num_prompt_frames": p,
        "window_size": int(T),
        "generation_layout": "prompt,pred,gt",
    }
    _write(args, video, meta, "latent frames")


if __name__ == "__main__":
    main()
