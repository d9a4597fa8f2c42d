"""Discrete-model evaluation CLI: `python -m hma_tpu_torch.evaluate ...`

Counterpart of `hma_tpu.evaluate`: per-frame MaskGIT prediction over the
validation windows, reporting the factored CE loss, perplexity and
accuracy of the first-step logits (`metrics.token.teacher_forced_metrics`)
and the generation time a frame. Teacher-forced by default (frame t sees
ground-truth frames < t); `--autoregressive_time` gives frame t the model's
own sample of frame t-1 past `--num_prompt_frames`
(`rollout.maskgit.autoregressive_logits`). `--use_feature` hands every flag
to `evaluate_feature`, the continuous family's evaluator. Prints one JSON
line: loss, perplexity, acc, gen_time, num_examples.

One extra flag: `--device` (default: the CUDA card; raises if there is
none). The model computes in bf16 on the card and in fp32 on the CPU.
One device and one process (`parallel.sharded_eval`). Not ported yet, and
raising when asked for: the pixel metrics and ΔPSNR (`--tokenizer_ckpt`,
`--raw_image_data`; ROADMAP.md Queue A, items 6 and 7), `--use_wandb`
(item 11) and meshes above one device (`--fsdp/--tp/--sp` > 1, item 10).
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from hma_tpu_torch import evaluate_feature
from hma_tpu_torch.data.datasets import RawTokenDataset
from hma_tpu_torch.generate import load_model
from hma_tpu_torch.metrics.token import AvgMetric, teacher_forced_metrics
from hma_tpu_torch.parallel import distributed as dist
from hma_tpu_torch.parallel.sharded_eval import (
    local_rows,
    put_batch,
    round_batch,
    setup_eval_mesh,
)
from hma_tpu_torch.rollout.maskgit import autoregressive_logits, teacher_forced_logits
from hma_tpu_torch.train.trainer import _pad_actions
from hma_tpu_torch.utils.logging import MetricLogger


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate a discrete HMA model")
    p.add_argument("--checkpoint_dir", type=str, required=True)
    p.add_argument("--val_data_dir", type=str, required=True)
    p.add_argument("--output_dir", type=str, default="eval_out")
    p.add_argument("--domain", type=str, default=None)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--maskgit_steps", type=int, default=None,
                   help="default: 2 (discrete) / the model card's value "
                        "(--use_feature)")
    p.add_argument("--temperature", type=float, default=None,
                   help="default: 0.0 greedy (discrete) / 1.0 (--use_feature)")
    p.add_argument("--max_examples", type=int, default=200)
    p.add_argument("--autoregressive_time", action="store_true",
                   help="past num_prompt_frames, condition each frame on "
                        "the model's own sample of the frame before")
    p.add_argument("--num_prompt_frames", type=int, default=None,
                   help="prompt length for --autoregressive_time "
                        "(default: the model card's num_prompt_frames)")
    p.add_argument("--tokenizer_ckpt", type=str, default=None,
                   help="pixel metrics: not ported yet, raises")
    p.add_argument("--raw_image_data", action="store_true",
                   help="raw uint8 frames tokenized on the fly: not ported "
                        "yet, raises")
    p.add_argument("--use_tokenized_images", action="store_true",
                   help="accepted for compatibility: pre-tokenized val dirs "
                        "are the default")
    p.add_argument("--save_outputs_dir", type=str, default=None,
                   help="dump predicted + ground-truth token windows as .npy")
    p.add_argument("--num_action_trials", type=int, default=5,
                   help="ΔPSNR trials (with --tokenizer_ckpt only)")
    p.add_argument("--perturbation_scale", type=float, default=0.1)
    p.add_argument("--perturbation_type", type=str, default="gaussian",
                   choices=["gaussian"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fsdp", type=int, default=1)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--sp", type=int, default=1)
    p.add_argument("--use_wandb", action="store_true")
    p.add_argument("--use_feature", action="store_true",
                   help="continuous family: hand over to evaluate_feature")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; raises without a card)")
    return p.parse_known_args(argv)


def feature_argv(args, rest) -> list[str]:
    """evaluate_feature's argv for `--use_feature`: every flag of this
    parser that it takes, spelled out (this parser consumed them), then the
    flags this parser does not know."""
    opt = lambda flag, v: [flag, str(v)] if v is not None else []
    return ["--checkpoint_dir", args.checkpoint_dir,
            "--val_data_dir", args.val_data_dir,
            "--output_dir", args.output_dir,
            "--batch_size", str(args.batch_size),
            "--max_examples", str(args.max_examples),
            "--seed", str(args.seed),
            "--fsdp", str(args.fsdp), "--tp", str(args.tp), "--sp", str(args.sp),
            *opt("--domain", args.domain),
            *opt("--maskgit_steps", args.maskgit_steps),
            *opt("--temperature", args.temperature),
            *opt("--num_prompt_frames", args.num_prompt_frames),
            *(["--eval_mode", "autoregressive"] if args.autoregressive_time else []),
            *(["--use_wandb"] if args.use_wandb else []),
            *opt("--device", args.device),
            *rest]


def main(argv=None):
    args, rest = parse_args(argv)
    if args.tokenizer_ckpt or args.raw_image_data:
        raise NotImplementedError(
            "--tokenizer_ckpt / --raw_image_data: the tokenizers and the pixel "
            "path are not ported yet (ROADMAP.md Queue A, items 6 and 7)")
    if args.use_feature:
        return evaluate_feature.main(feature_argv(args, rest))
    if rest:
        raise ValueError(f"unknown arguments: {rest}")
    if args.use_wandb:
        raise NotImplementedError(evaluate_feature.WANDB)
    dist.init_distributed()
    device = setup_eval_mesh(fsdp=args.fsdp, tp=args.tp, sp=args.sp, device=args.device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    model, config = load_model(args.checkpoint_dir, device, dtype)
    dataset = RawTokenDataset(args.val_data_dir, window_size=config.T,
                              use_actions=config.use_actions, name=args.domain or "")
    domain = args.domain or dataset.name
    domains = config.action_domains or []
    domain_id = domains.index(domain) if domain in domains else 0

    steps = args.maskgit_steps if args.maskgit_steps is not None else 2
    temperature = args.temperature if args.temperature is not None else 0.0
    n_prompt = (args.num_prompt_frames if args.num_prompt_frames is not None
                else config.num_prompt_frames)

    def predict(tokens, actions, generator):
        kw = dict(maskgit_steps=steps, temperature=temperature)
        if args.autoregressive_time:
            samples, logits = autoregressive_logits(
                model, tokens, n_prompt, actions, domain_id, generator, **kw)
        else:
            samples, logits = teacher_forced_logits(
                model, tokens, actions, domain_id, generator, **kw)
        return samples, teacher_forced_metrics(logits, tokens[:, 1:],
                                               config.factored_vocab_size)

    logger = MetricLogger(args.output_dir, config=vars(args))
    metrics = {k: AvgMetric() for k in ("loss", "perplexity", "acc", "gen_time")}
    generator = torch.Generator(device).manual_seed(args.seed)
    total = round_batch(min(args.max_examples, len(dataset)), device)
    if total <= 0:
        raise ValueError(f"min(--max_examples {args.max_examples}, len(dataset) "
                         f"{len(dataset)}) is 0: nothing to evaluate")
    n_done = 0
    while n_done < total:
        B = min(args.batch_size, total - n_done)
        items = [dataset[int(i)] for i in dist.local_slice(np.arange(n_done, n_done + B))]
        local = {"tokens": np.stack([it["input_ids"] for it in items])
                 .reshape(B, config.T, -1).astype(np.int64)}
        if "action_ids" in items[0]:
            local["actions"] = _pad_actions(
                np.stack([it["action_ids"] for it in items]).astype(np.float32),
                config.max_d_action)
        batch = put_batch(local, device)
        tokens = batch["tokens"]
        t0 = time.perf_counter()
        samples, tf = predict(tokens, batch.get("actions"), generator)
        tf = {k: float(v) for k, v in tf.items()}  # waits for the device
        if device.type == "cuda":
            torch.cuda.synchronize()
        gen_time = (time.perf_counter() - t0) / (config.T - 1)
        for k in ("loss", "perplexity", "acc"):
            metrics[k].update(tf[k], B)
        metrics["gen_time"].update(gen_time, B)
        if args.save_outputs_dir:
            out = Path(args.save_outputs_dir)
            out.mkdir(parents=True, exist_ok=True)
            r = dist.process_index()
            np.save(out / f"pred_{n_done}_r{r}.npy", local_rows(samples))
            np.save(out / f"gt_{n_done}_r{r}.npy", local_rows(tokens))
        n_done += B

    result = {k: m.mean() for k, m in metrics.items() if m.count > 0}
    result["num_examples"] = metrics["loss"].count
    prefix = "autoregressive" if args.autoregressive_time else "teacher_force"
    if dist.is_primary():
        logger.log({f"val/{domain}_{prefix}_{k}": v for k, v in result.items()})
    logger.close()
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
