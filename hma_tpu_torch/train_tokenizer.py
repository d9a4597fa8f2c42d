"""MagVit2 tokenizer GAN training CLI: `python -m hma_tpu_torch.train_tokenizer`
(counterpart of hma_tpu/train_tokenizer.py).

Trains the VQ tokenizer on a raw-image dataset directory (the
`RawImageDataset` layout, uint8 (N, H, W, 3)) with the step of
`tokenizer/train_vq.py`. The flags are hma_tpu's, plus `--device` (default:
the CUDA card; raises without one). Batches are drawn as hma_tpu draws them,
`np.random.default_rng(seed).integers(0, len(dataset), batch_size)` a step,
so both packages see the same images. The output directory gets the
`vq_config.json` sidecar, `step_<n>` checkpoints every
`--checkpointing_steps` (the last 3 kept) and `final_checkpt`, each holding
the generator and its EMA (`tokenizer/convert.save_tokenizer_checkpoint`),
which `tokenizer.convert.load_magvit2(output_dir)` reads, and
`metrics.jsonl` (`tok/*` every `--log_every` steps).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from hma_tpu_torch import resolve_device
from hma_tpu_torch.data.datasets import RawImageDataset
from hma_tpu_torch.metrics.lpips import LPIPS, load_lpips_torch_weights
from hma_tpu_torch.tokenizer.convert import save_tokenizer_checkpoint
from hma_tpu_torch.tokenizer.magvit2 import VQConfig
from hma_tpu_torch.tokenizer.train_vq import init_vq_train_state, make_vq_train_step
from hma_tpu_torch.utils.logging import MetricLogger


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train the MagVit2 VQ tokenizer (PyTorch port)")
    p.add_argument("--train_data_dir", type=str, required=True,
                   help="RawImageDataset directory (uint8 frames)")
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--vq_config", type=str, default=None,
                   help="VQConfig json; defaults to the reference card")
    p.add_argument("--image_size", type=int, default=256,
                   help="side of the dataset's square frames; raises if they differ")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--warmup_steps", type=int, default=1000)
    p.add_argument("--max_train_steps", type=int, default=100000)
    p.add_argument("--checkpointing_steps", type=int, default=2000)
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--lpips_weights", type=str, default=None,
                   help="torch LPIPS(vgg) state dict for the perceptual loss")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; raises without a card)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    config = (VQConfig.from_pretrained(args.vq_config) if args.vq_config
              else VQConfig())

    lpips_fn = None
    if args.lpips_weights:
        lpips_fn = load_lpips_torch_weights(
            LPIPS("vgg", device=device),
            torch.load(args.lpips_weights, map_location="cpu", weights_only=True))

    dataset = RawImageDataset(args.train_data_dir, window_size=1,
                              compute_stride_from_freq_table=False,
                              filter_interrupts=False)
    side = dataset[0]["images"].shape[1:3]
    if tuple(side) != (args.image_size, args.image_size):
        raise ValueError(f"--image_size {args.image_size}, but the frames of "
                         f"{args.train_data_dir} are {side[0]}x{side[1]}")
    # the architecture sidecar, so load_magvit2() rebuilds the codec from
    # the output directory alone
    os.makedirs(args.output_dir, exist_ok=True)
    config.save_pretrained(os.path.join(args.output_dir, "vq_config.json"))
    state = init_vq_train_state(config, args.seed, lr=args.learning_rate,
                                warmup_steps=args.warmup_steps, device=device)
    step_fn = make_vq_train_step(state, config, lpips_fn=lpips_fn)

    rng = np.random.default_rng(args.seed)
    t_last = time.time()
    with MetricLogger(args.output_dir, config=vars(args)) as logger:
        for step_i in range(1, args.max_train_steps + 1):
            idx = rng.integers(0, len(dataset), args.batch_size)
            frames = np.stack([dataset[int(i)]["images"][0] for i in idx])
            images = (torch.from_numpy(frames).to(device) / 127.5 - 1.0).permute(0, 3, 1, 2)
            logs = step_fn(images)
            if step_i % args.log_every == 0:
                m = {k: float(v) for k, v in logs.items()}
                m["steps_per_sec"] = args.log_every / max(time.time() - t_last, 1e-9)
                t_last = time.time()
                logger.log({f"tok/{k}": v for k, v in m.items()}, step=step_i)
            if step_i % args.checkpointing_steps == 0:
                save_tokenizer_checkpoint(args.output_dir, f"step_{step_i}",
                                          state.gen.state_dict(), state.ema, keep_last=3)
        save_tokenizer_checkpoint(args.output_dir, "final_checkpt",
                                  state.gen.state_dict(), state.ema)


if __name__ == "__main__":
    main()
