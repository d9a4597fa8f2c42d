"""Rollout CLI: `python -m hma_tpu_torch.generate ...`

The discrete branch of `hma_tpu.generate`: loads a port checkpoint
(`utils.checkpoint`), rolls out future frames with the KV-cached MaskGIT
engine (or teacher-forced), and writes the [prompt | prediction | ground
truth] stream to `video.bin` + `metadata.json` in the same layout. One
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
from hma_tpu_torch.data.datasets import RawTokenDataset
from hma_tpu_torch.rollout.maskgit import make_generator, teacher_forced_logits
from hma_tpu_torch.utils.checkpoint import load_checkpoint


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Autoregressive MaskGIT rollout")
    p.add_argument("--checkpoint_dir", type=str, required=True)
    p.add_argument("--val_data_dir", type=str, required=True)
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--domain", type=str, default=None)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--maskgit_steps", type=int, default=None, help="default: 2")
    p.add_argument("--temperature", type=float, default=None,
                   help="default: 0.0 (greedy)")
    p.add_argument("--num_prompt_frames", type=int, default=8)
    p.add_argument("--window_size", type=int, default=None,
                   help="frames per rollout window (default: the model "
                        "card's T; must be <= T)")
    p.add_argument("--example_ind", type=int, default=0)
    p.add_argument("--max_examples", "--max_example", type=int, default=16)
    p.add_argument("--teacher_force_time", action="store_true")
    p.add_argument("--use_feature", action="store_true",
                   help="continuous family (not ported yet)")
    p.add_argument("--cfg", type=float, default=1.0,
                   help="--use_feature guidance scale (not ported yet)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; raises without a card)")
    return p.parse_args(argv)


def _pad_actions(a: np.ndarray, width: int) -> np.ndarray:
    if a.shape[-1] == width:
        return a
    pad = np.zeros((*a.shape[:-1], width - a.shape[-1]), a.dtype)
    return np.concatenate([a, pad], axis=-1)


def main(argv=None):
    args = parse_args(argv)
    if args.use_feature:
        raise NotImplementedError(
            "--use_feature (the continuous STMAR family) is not ported yet: "
            "ROADMAP.md Queue A, the STMAR family with K6")
    device = resolve_device(args.device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    model, config = load_checkpoint(args.checkpoint_dir, device, dtype)

    T = args.window_size or config.T
    if T > config.T:
        raise ValueError(f"--window_size {T} exceeds the model's T={config.T}")
    if args.num_prompt_frames >= T:
        raise ValueError(f"--num_prompt_frames {args.num_prompt_frames} leaves "
                         f"no frames to generate in a {T}-frame window")
    dataset = RawTokenDataset(args.val_data_dir, window_size=T,
                              use_actions=config.use_actions,
                              name=args.domain or "")
    domain = args.domain or dataset.name
    domains = config.action_domains or []
    domain_id = domains.index(domain) if domain in domains else 0

    B = min(args.batch_size, args.max_examples)
    items = [dataset[args.example_ind + i] for i in range(B)]
    tokens = np.stack([it["input_ids"] for it in items]).reshape(B, T, -1)
    actions = None
    if "action_ids" in items[0]:
        actions = torch.from_numpy(_pad_actions(
            np.stack([it["action_ids"] for it in items]).astype(np.float32),
            config.max_d_action)).to(device)

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
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    p = args.num_prompt_frames
    rows = [np.concatenate([tokens[i, :p], pred[i, p:], tokens[i, p:]])
            for i in range(B)]
    video = np.concatenate(rows).reshape(-1, h, w).astype(np.uint32)
    video.tofile(out / "video.bin")
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
    with open(out / "metadata.json", "w") as f:
        json.dump(meta, f)
    print(f"wrote {video.shape[0]} frames to {out}")


if __name__ == "__main__":
    main()
