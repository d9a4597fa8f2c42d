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

With a MagVit2 checkpoint (`--tokenizer_ckpt`) the samples are decoded to
pixels and scored against the decoded ground truth: psnr, ssim, dec_time,
psnr_copy_prev (frame t-1 as the prediction of frame t, the no-dynamics
baseline), psnr_vs_copy and the controllability probe delta_psnr (psnr
less the mean over `--num_action_trials` rollouts with the actions moved by
`--perturbation_scale` x N(0, 1), drawn from the run's generator).
`--raw_image_data` reads uint8 frames, tokenizes them with the same codec
and scores against the raw frames.

One extra flag: `--device` (default: the CUDA card; raises if there is
none). The model and the codec compute in bf16 on the card and in fp32 on
the CPU; the pixel metrics run on the same device. Data-parallel across
processes when launched with torchrun (`parallel.sharded_eval`): each
evaluates its rows of every global batch (`--batch_size`, rounded down to
a multiple of the data degree dp * fsdp) with its rows of the global
batch's draws (`--seed`), so that N processes give what one gives; the token metrics are
the global batch's, the pixel metrics and gen_time the mean over the
processes, and process 0 writes. With `--fsdp` above 1 the model's
parameters are sharded over the processes by FSDP2, by the training rules;
with `--tp` above 1 its heads and MLP features are split over the tp ranks
and with `--sp` above 1 every frame's tokens over the sp ranks, which share
their rows and draws (the world is dp * fsdp * tp * sp processes, the batch
split over dp * fsdp). Not ported yet, and raising when asked for:
`--use_wandb` (ROADMAP.md Queue A, item 11).
"""

from __future__ import annotations

import argparse
import json
import math
import time
from pathlib import Path

import numpy as np
import torch

from hma_tpu_torch import evaluate_feature
from hma_tpu_torch.data.datasets import RawImageDataset, RawTokenDataset
from hma_tpu_torch.data.encode_openx import make_magvit_encoder
from hma_tpu_torch.generate import load_model
from hma_tpu_torch.metrics.image import batch_psnr, batch_ssim
from hma_tpu_torch.metrics.token import AvgMetric, teacher_forced_metrics
from hma_tpu_torch.parallel import distributed as dist
from hma_tpu_torch.parallel.sharded_eval import round_batch, setup_eval_mesh, shard_params
from hma_tpu_torch.rollout.decode import codec, make_token_decoder
from hma_tpu_torch.rollout.maskgit import autoregressive_logits, teacher_forced_logits
from hma_tpu_torch.tokenizer.convert import load_magvit2
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
                   help="magvit2.ckpt for pixel metrics; token metrics only if omitted")
    p.add_argument("--raw_image_data", action="store_true",
                   help="val_data_dir holds raw uint8 frames: tokenize them "
                        "with --tokenizer_ckpt and score against them")
    p.add_argument("--use_tokenized_images", action="store_true",
                   help="accepted for compatibility: pre-tokenized val dirs "
                        "are the default")
    p.add_argument("--save_outputs_dir", type=str, default=None,
                   help="dump predicted + ground-truth token windows as .npy")
    p.add_argument("--num_action_trials", type=int, default=5,
                   help="ΔPSNR trials (with --tokenizer_ckpt only)")
    p.add_argument("--perturbation_scale", type=float, default=0.1,
                   help="sigma of the ΔPSNR action noise")
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
    if args.use_feature:
        return evaluate_feature.main(feature_argv(args, rest))
    if rest:
        raise ValueError(f"unknown arguments: {rest}")
    if args.use_wandb:
        raise NotImplementedError(evaluate_feature.WANDB)
    if args.raw_image_data and not args.tokenizer_ckpt:
        raise ValueError("--raw_image_data requires --tokenizer_ckpt")
    dist.init_distributed(device=args.device)
    device, mesh = setup_eval_mesh(fsdp=args.fsdp, tp=args.tp, sp=args.sp,
                                   device=args.device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    decode = encode = None
    if args.tokenizer_ckpt:
        vq = codec(*load_magvit2(args.tokenizer_ckpt), dtype=dtype, device=device)
        decode = make_token_decoder(vq)
        if args.raw_image_data:
            encode = make_magvit_encoder(vq)
    model, config = load_model(args.checkpoint_dir, device, dtype)
    model = shard_params(model, mesh)
    if args.raw_image_data:
        dataset = RawImageDataset(args.val_data_dir, window_size=config.T,
                                  use_actions=config.use_actions, domain=args.domain)
    else:
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
        """(samples (B, T-1, S), first-step logits)."""
        kw = dict(maskgit_steps=steps, temperature=temperature)
        if args.autoregressive_time:
            return autoregressive_logits(model, tokens, n_prompt, actions, domain_id,
                                         generator, **kw)
        return teacher_forced_logits(model, tokens, actions, domain_id, generator, **kw)

    def perturbed(tokens, actions):
        """Samples of a rollout with the actions moved by scale x N(0, 1)."""
        noise = dist.draw_rows(
            lambda m, g: torch.randn((m, *actions.shape[1:]), generator=g, device=device),
            len(actions), generator)
        return predict(tokens, actions + args.perturbation_scale * noise, generator)[0]

    logger = MetricLogger(args.output_dir, config=vars(args), enabled=dist.is_primary())
    metrics = {k: AvgMetric() for k in ("loss", "perplexity", "acc")}
    # host-side: per-process means, averaged over the processes at the end
    pixel = {k: AvgMetric() for k in ("gen_time", "dec_time", "psnr", "ssim", "delta_psnr",
                                      "psnr_copy_prev", "psnr_vs_copy")}
    # each process draws its rows of the global batch's draws: N processes = 1
    generator = dist.rank_rows(torch.Generator(device).manual_seed(args.seed),
                               dist.data_group())
    total, B_full = (round_batch(n)
                     for n in (min(args.max_examples, len(dataset)), args.batch_size))
    if total <= 0 or B_full <= 0:
        raise ValueError(f"min(--max_examples {args.max_examples}, len(dataset) "
                         f"{len(dataset)}) or --batch_size {args.batch_size} rounds to "
                         f"0 over {dist.data_count()} data-parallel ranks: nothing to evaluate")
    n_done = 0
    while n_done < total:
        B = min(B_full, total - n_done)
        items = [dataset[int(i)] for i in dist.local_slice(np.arange(n_done, n_done + B))]
        raw_frames = None
        if "images" in items[0]:  # raw frames: tokenized here, the pixel ground truth
            raw_frames = np.clip(np.stack([it["images"] for it in items]), 0, 255).astype(np.uint8)
            tokens = encode(raw_frames.reshape(-1, *raw_frames.shape[2:]))
        else:
            tokens = np.stack([it["input_ids"] for it in items])
        local = {"tokens": tokens.reshape(len(items), config.T, -1).astype(np.int64)}
        if "action_ids" in items[0]:
            local["actions"] = _pad_actions(
                np.stack([it["action_ids"] for it in items]).astype(np.float32),
                config.max_d_action)
        batch = dist.make_global_batch(local, device)
        tokens, actions = batch["tokens"], batch.get("actions")
        t0 = time.perf_counter()
        samples, logits = predict(tokens, actions, generator)
        tf = teacher_forced_metrics(logits, tokens[:, 1:], config.factored_vocab_size)
        tf = {k: float(v) for k, v in tf.items()}  # waits for the device
        if device.type == "cuda":
            torch.cuda.synchronize()
        gen_time = (time.perf_counter() - t0) / (config.T - 1)
        if dist.process_count() > 1:  # the global batch's means (equal shards)
            tf = dist.aggregate_host_metrics({"loss": tf["loss"], "acc": tf["acc"]})
            tf["perplexity"] = math.exp(tf["loss"])
        for k in ("loss", "perplexity", "acc"):
            metrics[k].update(tf[k], B)
        pixel["gen_time"].update(gen_time, B)
        if args.save_outputs_dir:
            out = Path(args.save_outputs_dir)
            out.mkdir(parents=True, exist_ok=True)
            r = dist.process_index()
            np.save(out / f"pred_{n_done}_r{r}.npy", samples.cpu().numpy())
            np.save(out / f"gt_{n_done}_r{r}.npy", tokens.cpu().numpy())
        if decode is not None:
            trials = args.num_action_trials if actions is not None else 0
            pixel_metrics(pixel, decode, samples, tokens, raw_frames, config,
                          [lambda: perturbed(tokens, actions)] * trials, device)
        n_done += B

    result = {k: m.mean() for k, m in metrics.items() if m.count > 0}
    result.update(dist.aggregate_host_metrics(
        {k: m.mean() for k, m in pixel.items() if m.count > 0}))
    result["num_examples"] = metrics["loss"].count
    prefix = "autoregressive" if args.autoregressive_time else "teacher_force"
    if dist.is_primary():
        logger.log({f"val/{domain}_{prefix}_{k}": v for k, v in result.items()})
    logger.close()
    print(json.dumps(result))
    return result


def pixel_metrics(pixel: dict, decode, samples, tokens, raw_frames, config,
                  trials, device) -> None:
    """Add one batch's pixel metrics to the AvgMetrics of `pixel`: samples
    (B, T-1, S) decoded and scored against frames 1.. of the raw frames (B,
    T, H, W, 3) or, without them, of the decoded ground-truth tokens (B, T,
    S); `trials` are callables giving the samples of the perturbed-action
    rollouts (ΔPSNR)."""
    n = len(samples)

    def frames(tok):
        return decode(tok.reshape(-1, config.h, config.w))

    t0 = time.perf_counter()
    pred_px = frames(samples)
    pixel["dec_time"].update((time.perf_counter() - t0) / max(n, 1), n)
    if raw_frames is not None:
        gt_px = raw_frames[:, 1:].reshape(-1, *raw_frames.shape[2:])
        copy_px = raw_frames[:, :-1].reshape(-1, *raw_frames.shape[2:])
        if gt_px.shape[1:3] != pred_px.shape[1:3]:
            raise ValueError("raw-image resolution must match the tokenizer's decode "
                             f"resolution: {gt_px.shape} vs {pred_px.shape}")
    else:
        gt_px, copy_px = frames(tokens[:, 1:]), frames(tokens[:, :-1])
    gt_psnr = float(np.mean(batch_psnr(pred_px, gt_px, device=device)))
    pixel["psnr"].update(gt_psnr, n)
    pixel["ssim"].update(float(np.mean(batch_ssim(pred_px, gt_px, device=device))), n)
    # the no-dynamics baseline: frame t predicted as frame t-1
    copy_psnr = float(np.mean(batch_psnr(copy_px, gt_px, device=device)))
    pixel["psnr_copy_prev"].update(copy_psnr, n)
    pixel["psnr_vs_copy"].update(gt_psnr - copy_psnr, n)
    if trials:
        rand = [np.mean(batch_psnr(frames(trial()), gt_px, device=device))
                for trial in trials]
        pixel["delta_psnr"].update(float(gt_psnr - np.mean(rand)), n)


if __name__ == "__main__":
    main()
