"""Continuous-model (STMAR) evaluation CLI:
`python -m hma_tpu_torch.evaluate_feature ...` (also as
`hma_tpu_torch.evaluate_diffusion`).

Counterpart of `hma_tpu.evaluate_feature`: frame prediction over the
validation latents, teacher-forced (`rollout.mar.teacher_forced_latents`,
frame t from ground-truth frames < t) or autoregressive from
`--num_prompt_frames` (`rollout.mar.generate_latents`), both with
classifier-free guidance `--cfg`. Prints one JSON line: latent_mse over the
predicted frames, latent_mse_per_frame, gen_time a predicted frame and
num_examples; with `--compute_fid` / `--compute_fvd` also fid_latent and
fvd_latent (FVD only for T >= 10), the Fréchet distances of the flattened
latent frames and clips of a second pass over the same windows, and with
`--vae_checkpoint` first fid and fvd over those windows decoded to uint8
pixels by the SVD temporal VAE, clip by clip (InceptionV3 pool3 features of
every frame; I3D embeddings of every clip, `--fvd_backend`, weights from
`--i3d_weights` or drawn from a seed).

One extra flag: `--device` (default: the CUDA card; raises if there is
none). bf16 on the card, fp32 on the CPU, the metric backbones fp32 on
both. Data-parallel across processes when launched with torchrun: each
evaluates its rows of every global batch (`--batch_size`, rounded down to a
multiple of the data degree dp * fsdp) with its rows of the global batch's draws, so
that N processes give what one gives; the latent MSEs are the global
batch's, the FID/FVD pass gathers every process's rows, gen_time is the
mean over the processes, and process 0 writes. With `--fsdp` above 1 the
model's parameters are sharded over the processes by FSDP2, by the
training rules; with `--tp` above 1 its heads and MLP features are split
over the tp ranks (the diffusion head is gathered whole on each), with
`--sp` above 1 every frame's tokens over the sp ranks (the head sees whole
frames); the ranks of a tp or sp group share their rows and draws.
`--use_wandb` (ROADMAP.md Queue A, item 11) raises.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from hma_tpu_torch.config import DiffusionGenieConfig
from hma_tpu_torch.data.datasets import RawFeatureDataset
from hma_tpu_torch.metrics.fid import calculate_fid, fid_from_features
from hma_tpu_torch.metrics.fvd import calculate_fvd
from hma_tpu_torch.metrics.token import AvgMetric
from hma_tpu_torch.parallel import distributed as dist
from hma_tpu_torch.parallel.sharded_eval import round_batch, setup_eval_mesh, shard_params
from hma_tpu_torch.rollout.decode import decode_clips, load_svd_decoder
from hma_tpu_torch.rollout.mar import generate_latents, teacher_forced_latents
from hma_tpu_torch.train.trainer import _pad_actions
from hma_tpu_torch.utils.checkpoint import load_checkpoint
from hma_tpu_torch.utils.logging import MetricLogger

FID_SEED = 100  # the FID/FVD pass seeds batch i's generator with FID_SEED + i
WANDB = "--use_wandb: the port logs to metrics.jsonl only (ROADMAP.md Queue A, item 11)"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate a continuous (STMAR) HMA model")
    p.add_argument("--checkpoint_dir", type=str, required=True)
    p.add_argument("--val_data_dir", type=str, required=True)
    p.add_argument("--output_dir", type=str, default="eval_feature_out")
    p.add_argument("--domain", type=str, default=None)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--maskgit_steps", type=int, default=None)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--cfg", type=float, default=1.0,
                   help="classifier-free guidance scale (uncond = the trained "
                        "action-dropout branch)")
    p.add_argument("--num_prompt_frames", type=int, default=4)
    p.add_argument("--eval_mode", type=str, default="teacher_forced",
                   choices=["teacher_forced", "autoregressive"])
    p.add_argument("--max_examples", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--compute_fvd", action="store_true",
                   help="fvd_latent over the flattened latent clips (T >= 10)")
    p.add_argument("--compute_fid", action="store_true",
                   help="fid_latent over the flattened latent frames")
    p.add_argument("--vae_checkpoint", type=str, default=None,
                   help="diffusers AutoencoderKLTemporalDecoder state-dict file: adds "
                        "pixel fid / fvd over the decoded windows")
    p.add_argument("--fvd_backend", type=str, default="styleganv",
                   choices=["styleganv", "videogpt"],
                   help="I3D variant of pixel FVD (with --vae_checkpoint only)")
    p.add_argument("--i3d_weights", type=str, default=None,
                   help="torch I3D state-dict file for --fvd_backend (default: "
                        "weights drawn from a seed)")
    p.add_argument("--fsdp", type=int, default=1)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--sp", type=int, default=1)
    p.add_argument("--use_wandb", action="store_true")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; raises without a card)")
    return p.parse_args(argv)


def load_mar_model(checkpoint_dir: str, device, dtype=torch.bfloat16):
    """(model, config) of a continuous (STMAR) checkpoint, in eval mode on
    `device`; `checkpoint_dir` is a checkpoint or a run directory (then its
    newest `step_*` one)."""
    model, config = load_checkpoint(checkpoint_dir, device, dtype)
    if not isinstance(config, DiffusionGenieConfig):
        raise ValueError(f"{checkpoint_dir} holds a discrete model, not a "
                         "continuous (STMAR) one")
    return model, config


def flat_embed(v: np.ndarray) -> np.ndarray:
    """The latent metrics' embedding: each item flattened, fp32."""
    return v.reshape(len(v), -1).astype(np.float32)


def main(argv=None):
    args = parse_args(argv)
    for flag, path in (("--vae_checkpoint", args.vae_checkpoint),
                       ("--i3d_weights", args.i3d_weights)):
        if path and not Path(path).is_file():  # before the evaluation, not after it
            raise FileNotFoundError(f"{flag} {path}: no such file")
    if args.use_wandb:
        raise NotImplementedError(WANDB)
    dist.init_distributed(device=args.device)
    device, mesh = setup_eval_mesh(fsdp=args.fsdp, tp=args.tp, sp=args.sp,
                                   device=args.device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    model, config = load_mar_model(args.checkpoint_dir, device, dtype)
    model = shard_params(model, mesh)
    dataset = RawFeatureDataset(args.val_data_dir, window_size=config.T,
                                use_actions=config.use_actions, domain=args.domain)
    domain = args.domain or dataset.name
    domains = config.action_domains or []
    domain_id = domains.index(domain) if domain in domains else 0
    teacher = args.eval_mode == "teacher_forced"
    if not teacher and args.num_prompt_frames >= config.T:
        raise ValueError(f"--num_prompt_frames {args.num_prompt_frames} leaves no "
                         f"frames to generate (model T={config.T})")
    t_first = 1 if teacher else args.num_prompt_frames  # the first predicted frame
    T, h, C = config.T, config.h, config.vae_embed_dim

    def predict(lat, actions, generator):
        kw = dict(maskgit_steps=args.maskgit_steps, temperature=args.temperature,
                  cfg=args.cfg)
        if teacher:
            pred = teacher_forced_latents(model, lat, actions, domain_id, generator, **kw)
            return torch.cat([lat[:, :1], pred], dim=1)
        return generate_latents(model, lat, args.num_prompt_frames, actions,
                                domain_id, generator, **kw)

    def load(lo, B):
        items = [dataset[int(i)] for i in dist.local_slice(np.arange(lo, lo + B))]
        local = {"lat": np.stack([it["input_ids"] for it in items])
                 .reshape(len(items), T, h, h, C).astype(np.float32)}
        if "action_ids" in items[0]:
            local["actions"] = _pad_actions(
                np.stack([it["action_ids"] for it in items]).astype(np.float32),
                config.max_d_action)
        batch = dist.make_global_batch(local, device)
        return batch["lat"], batch.get("actions")

    logger = MetricLogger(args.output_dir, config=vars(args), enabled=dist.is_primary())
    metrics = {k: AvgMetric() for k in ("latent_mse", "gen_time")}
    frame_sum = np.zeros(T - t_first)
    # each process draws its rows of the global batch's draws: N processes = 1
    seeded = lambda seed: dist.rank_rows(torch.Generator(device).manual_seed(seed),
                                         dist.data_group())
    generator = seeded(args.seed)
    total, B_full = (round_batch(n)
                     for n in (min(args.max_examples, len(dataset)), args.batch_size))
    if total <= 0 or B_full <= 0:
        raise ValueError(f"min(--max_examples {args.max_examples}, len(dataset) "
                         f"{len(dataset)}) or --batch_size {args.batch_size} rounds to "
                         f"0 over {dist.data_count()} data-parallel ranks: nothing to evaluate")
    n_done = 0
    while n_done < total:
        B = min(B_full, total - n_done)
        lat, actions = load(n_done, B)
        t0 = time.perf_counter()
        out = predict(lat, actions, generator)
        err = (out[:, t_first:].float() - lat[:, t_first:]) ** 2
        mse, mse_frames = err.mean().item(), err.mean(dim=(0, 2, 3, 4)).double()
        if device.type == "cuda":
            torch.cuda.synchronize()
        gen_time = (time.perf_counter() - t0) / (T - t_first)
        # the global batch's means: equal shards, so the mean over processes
        both = dist.gather_rows(np.concatenate([[mse], mse_frames.cpu().numpy()])[None])
        mse, mse_frames = float(both[:, 0].mean()), both[:, 1:].mean(0)
        frame_sum += mse_frames * B
        metrics["latent_mse"].update(mse, B)
        metrics["gen_time"].update(gen_time, B)
        n_done += B

    result = {k: m.mean() for k, m in metrics.items() if m.count > 0}
    result["gen_time"] = dist.aggregate_host_metrics({"t": result["gen_time"]})["t"]
    result["num_examples"] = n_done
    result["latent_mse_per_frame"] = (frame_sum / n_done).tolist()
    if args.compute_fid or args.compute_fvd:
        preds, gts = [], []
        for i in range(0, total, B_full):
            lat, actions = load(i, min(B_full, total - i))
            preds.append(predict(lat, actions, seeded(FID_SEED + i)).float().cpu().numpy())
            gts.append(lat.cpu().numpy())
        # every process's rows, so that the statistics are the global ones
        pred, gt = (dist.gather_rows(np.concatenate(x)) for x in (preds, gts))
        if args.vae_checkpoint:
            decode = load_svd_decoder(args.vae_checkpoint, device=device)
            pred_px, gt_px = decode_clips(decode, pred), decode_clips(decode, gt)
            if args.compute_fid:
                result["fid"] = calculate_fid(pred_px.reshape(-1, *pred_px.shape[2:]),
                                              gt_px.reshape(-1, *gt_px.shape[2:]),
                                              device=device)
            if args.compute_fvd and T >= 10:
                i3d = (torch.load(args.i3d_weights, map_location="cpu")
                       if args.i3d_weights else None)
                result["fvd"] = calculate_fvd(pred_px, gt_px, backend=args.fvd_backend,
                                              i3d_state_dict=i3d, device=device)
        if args.compute_fid:
            result["fid_latent"] = fid_from_features(
                flat_embed(pred.reshape(-1, *pred.shape[2:])),
                flat_embed(gt.reshape(-1, *gt.shape[2:])))
        if args.compute_fvd and T >= 10:
            result["fvd_latent"] = calculate_fvd(pred, gt, embed_fn=flat_embed)
    if dist.is_primary():
        logger.log({f"val/{domain}_{k}": v for k, v in result.items()})
    logger.close()
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
