"""Multi-dataset training loop (counterpart of hma_tpu/train/trainer.py).

The discrete family on one device: per-domain memmap datasets from a
datasplit file, temperature-weighted batch sampling, the training step of
`train/step.py`, periodic teacher-forced eval, a token-match rollout eval
and checkpointing with bit-exact resume (the sampler position is replayed
and each step's collate RNG is derived from (seed, step)). The model runs
in bf16 on the card and in fp32 on the CPU; parameters and optimizer
state are fp32 on both.

Not ported (they raise): the continuous family, the mesh and multi-host,
the native loader, the tokenizer/LPIPS pixel visualisation, muP, bf16
moments, JAX's `sliced_grads` lever and schedules other than
"custom_cosine".
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
import math
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from hma_tpu_torch import resolve_device
from hma_tpu_torch.config import GenieConfig, load_config
from hma_tpu_torch.data.collators import maskgit_collate
from hma_tpu_torch.data.datasets import RawTokenDataset
from hma_tpu_torch.data.sampler import MultiTaskBatchSampler
from hma_tpu_torch.models.st_mask_git import STMaskGIT
from hma_tpu_torch.rollout.maskgit import generate_tokens
from hma_tpu_torch.train.step import (
    custom_cosine_schedule,
    domain_stacked_mask,
    make_domain_sliced_optimizer,
    make_eval_step,
    make_optimizer,
    make_train_step,
    scale_lr_by_batch,
)
from hma_tpu_torch.utils.checkpoint import (
    latest_checkpoint,
    load_train_state,
    save_checkpoint,
)
from hma_tpu_torch.utils.logging import MetricLogger


@dataclass
class TrainArgs:
    """`hma_tpu.train.trainer.TrainArgs` plus `device` (default: the card)."""

    genie_config: str = ""
    output_dir: str = "out"
    train_split: str = "experiments/datasplit/dataset1.yaml"
    data_root: str = "data"
    model_type: str = "discrete"  # discrete | continuous (not ported)
    window_size: int = 12
    stride: int = 1
    filter_overlaps: bool = False
    num_episodes_per_dataset: int = 1_000_000
    per_device_train_batch_size: int = 4
    per_device_eval_batch_size: int = 4
    gradient_accumulation_steps: int = 1
    learning_rate: float = 1e-4
    weight_decay: float = 0.05
    num_train_epochs: int = 2
    max_train_steps: Optional[int] = None
    max_eval_steps: int = 10
    # abort when ~this many consecutive steps are NaN-guard-skipped
    # (sampled at log points; 0 disables)
    max_nan_skip_steps: int = 200
    eval_every_n_steps: int = 1000
    vis_every_n_steps: int = 10_000_000
    lr_scheduler_type: str = "custom_cosine"
    num_warmup_steps: int = 500
    max_grad_norm: float = 1.0
    adam_beta_1: float = 0.9
    adam_beta_2: float = 0.999
    adam_eps: float = 1e-8
    checkpointing_steps: str = "1000"
    keep_checkpoints: int = 3
    seed: int = 42
    overfit_first_batch: bool = False
    resume_from_checkpoint: Optional[str] = None
    mu_transfer: bool = False
    action_network: Optional[str] = None
    run_name: str = ""
    report_to: str = "jsonl"
    dp: Optional[int] = None
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    log_every: int = 10
    grad_checkpointing: bool = True  # remat STBlocks ("full") in the train step
    save_second_epoch: bool = False  # pin the epoch-1 checkpoint (never pruned)
    use_native_loader: bool = False
    tokenizer_checkpoint: Optional[str] = None
    lpips_weights: Optional[str] = None
    domain_sliced_adam: bool = True
    adam_moment_dtype: str = "float32"
    sliced_grads: str = "auto"  # "auto" and "off" mean off here; "on" raises
    device: Optional[str] = None


def _refuse_unported(args: TrainArgs) -> None:
    unported = {
        "--model_type continuous (the STMAR family)": args.model_type != "discrete",
        "a device mesh (--dp/--fsdp/--tp/--sp)":
            (args.dp or 1) * args.fsdp * args.tp * args.sp > 1,
        "--use_native_loader": args.use_native_loader,
        "--tokenizer_checkpoint / --lpips_weights (pixel visualisation)":
            bool(args.tokenizer_checkpoint or args.lpips_weights),
        "--mu_transfer (muP)": args.mu_transfer,
        "--adam_moment_dtype bfloat16": args.adam_moment_dtype != "float32",
        "--sliced_grads on": args.sliced_grads == "on",
        f"--lr_scheduler_type {args.lr_scheduler_type}":
            args.lr_scheduler_type != "custom_cosine",
        "--report_to wandb": args.report_to == "wandb",
    }
    asked = [k for k, v in unported.items() if v]
    if asked:
        raise NotImplementedError(f"not ported yet (ROADMAP.md Queue A): {asked}")


def read_domains(path: str) -> list[str]:
    """The comma-separated `domains` of a datasplit YAML file: a plain
    scalar (`domains: a,b`) or a folded block (`domains: >` and indented
    lines), the two forms the repo's datasplit files use."""
    lines = Path(path).read_text().splitlines()
    for i, line in enumerate(lines):
        if line.startswith("domains:"):
            value = line[len("domains:"):].strip()
            if value in (">", ">-", "|", "|-"):
                block = itertools.takewhile(lambda l: not l or l[0].isspace(),
                                            lines[i + 1:])
                value = " ".join(l.strip() for l in block)
            return [d.strip() for d in value.strip("'\"").split(",") if d.strip()]
    raise ValueError(f"{path}: no `domains:` key")


def build_domain_datasets(args: TrainArgs, config: GenieConfig):
    """Per-domain train/val datasets and the shared metadata."""
    domains = read_domains(args.train_split)
    fmt = "{root}/{domain}_magvit_max1000000_{split}"
    kwargs = dict(window_size=args.window_size, stride=args.stride,
                  max_traj_num=args.num_episodes_per_dataset,
                  use_actions=config.use_actions)
    if config.drop_action_ratio:
        kwargs["drop_action_ratio"] = config.drop_action_ratio
    train_sets, val_sets, action_dims, action_stats = [], [], [], []
    for domain in domains:
        tds = RawTokenDataset(fmt.format(root=args.data_root, domain=domain,
                                         split="train"),
                              filter_overlaps=args.filter_overlaps, name=domain,
                              **kwargs)
        train_sets.append(tds)
        action_dims.append(tds.n_action)
        if config.use_actions:
            action_stats.append(tds.action_stat)
        if args.overfit_first_batch:
            val_sets.append(tds)  # truncated to one batch in run_training
        else:
            val_sets.append(RawTokenDataset(
                fmt.format(root=args.data_root, domain=domain, split="val"),
                filter_overlaps=True, name=domain, **kwargs))
    meta = train_sets[0].metadata
    shared = {k: meta[k] for k in ("s", "h", "w", "vocab_size") if k in meta}
    return domains, train_sets, val_sets, action_dims, action_stats, shared


def configure_model(args: TrainArgs, config: GenieConfig, domains, action_dims,
                    action_stats, shared_metadata) -> GenieConfig:
    """Inject the dataset-derived fields into the model config."""
    config.use_mup = args.mu_transfer
    if "vocab_size" in shared_metadata:
        config.image_vocab_size = shared_metadata["vocab_size"]
    config.T = args.window_size
    config.S = shared_metadata["h"] * shared_metadata["w"]
    if args.action_network is not None:
        config.action_network = args.action_network
    if config.use_actions:
        config.init_actions = True
        config.action_domains = domains
        config.d_actions = action_dims
        config.action_stats = action_stats
    config.__post_init__()  # re-derive the factored vocab
    return config


def _pad_actions(a: np.ndarray, width: int) -> np.ndarray:
    if a.shape[-1] == width:
        return a
    pad = np.zeros((*a.shape[:-1], width - a.shape[-1]), a.dtype)
    return np.concatenate([a, pad], axis=-1)


class BatchAssembler:
    """Sampler indices -> collated batch of tensors on `device`."""

    def __init__(self, datasets, config: GenieConfig, seed: int, device,
                 rng: np.random.Generator):
        self.datasets = datasets
        self.offsets = np.cumsum([0] + [len(d) for d in datasets[:-1]])
        self.config = config
        self.seed = seed
        self.device = device
        self.rng = rng

    def __call__(self, global_indices: np.ndarray, step: Optional[int] = None) -> dict:
        """A training call passes `step`: the collate RNG is then derived
        from (seed, step), so a resumed run collates step k as a straight
        run does."""
        ds_idx = int(np.searchsorted(self.offsets, global_indices[0], side="right") - 1)
        items = [self.datasets[ds_idx][int(i)]
                 for i in global_indices - self.offsets[ds_idx]]
        rng = self.rng if step is None else np.random.default_rng([self.seed, int(step)])
        batch = maskgit_collate(items, self.config, rng)
        B, T = len(items), self.config.T
        hw = batch["h"][0] * batch["w"][0]
        out = {k: torch.from_numpy(batch[k].reshape(B, T, hw).astype(np.int64))
               .to(self.device) for k in ("input_ids", "labels")}
        if "action_ids" in batch:
            out["action_ids"] = torch.from_numpy(_pad_actions(
                batch["action_ids"], self.config.max_d_action)).to(self.device)
        out["domain_id"] = ds_idx
        return out


def stacked_param_mask(model: STMaskGIT, config: GenieConfig) -> dict[str, bool]:
    """The same model with one more domain, built on the meta device: the
    parameters whose shapes change are the domain-stacked tables."""
    alt = copy.deepcopy(config)
    alt.action_domains = list(config.action_domains) + ["__probe__"]
    alt.d_actions = list(config.d_actions) + [config.d_actions[-1]]
    if config.action_stats:
        alt.action_stats = list(config.action_stats) + [config.action_stats[-1]]
    return domain_stacked_mask(model, STMaskGIT(alt, dtype=model.dtype, device="meta"))


def run_training(args: TrainArgs) -> dict:
    """Main loop; returns the metrics of the last log point."""
    _refuse_unported(args)
    device = resolve_device(args.device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    config = load_config(args.genie_config)
    domains, train_sets, val_sets, action_dims, action_stats, shared = (
        build_domain_datasets(args, config))
    config = configure_model(args, config, domains, action_dims, action_stats, shared)

    B = args.per_device_train_batch_size
    effective_batch = B * args.gradient_accumulation_steps
    lr = scale_lr_by_batch(args.learning_rate, effective_batch)
    if args.overfit_first_batch:
        # one effective batch in all, reused for train and val
        for ds in train_sets:
            ds.valid_start_inds = ds.valid_start_inds[:effective_batch]
    # one sampler draw == one optimizer update (of grad-accum microbatches)
    sampler = MultiTaskBatchSampler([len(d) for d in train_sets],
                                    batch_size=effective_batch, temperature=3.0,
                                    seed=args.seed)
    steps_per_epoch = max(len(sampler), 1)
    max_steps = args.max_train_steps or args.num_train_epochs * steps_per_epoch
    schedule = custom_cosine_schedule(lr, args.num_warmup_steps, max_steps)
    assembler = BatchAssembler(train_sets, config, args.seed, device,
                               np.random.default_rng(args.seed))
    val_assembler = BatchAssembler(val_sets, config, args.seed, device,
                                   np.random.default_rng(0))

    model = STMaskGIT(config, dtype=dtype, device=device,
                      generator=torch.Generator(device).manual_seed(args.seed),
                      remat=args.grad_checkpointing)
    opt_kw = dict(learning_rate=schedule, weight_decay=args.weight_decay,
                  beta1=args.adam_beta_1, beta2=args.adam_beta_2, eps=args.adam_eps,
                  max_grad_norm=args.max_grad_norm)
    if args.domain_sliced_adam and config.num_domains > 1:
        tx = make_domain_sliced_optimizer(
            model, **opt_kw, stacked_mask=stacked_param_mask(model, config),
            num_domains=config.num_domains)
    else:
        tx = make_optimizer(model, **opt_kw)

    start_step = 0
    resume = args.resume_from_checkpoint
    if resume == "latest":
        resume = latest_checkpoint(args.output_dir)
    if resume:
        model_state, opt_state, start_step = load_train_state(resume, device)
        model.load_state_dict(model_state)
        tx.load_state_dict(opt_state)

    microbatch = B if args.gradient_accumulation_steps > 1 else 0
    train_step = make_train_step(model, tx, microbatch=microbatch)
    eval_step = make_eval_step(model)

    n_params = sum(p.numel() for p in model.parameters())
    exp_config = {**dataclasses.asdict(args), **{
        "model_parameters": int(n_params),
        "model_parameters_M": round(n_params / 1e6),
        "effective_batch_size": effective_batch,
        "seq_len": config.T * config.S,
        "FLOPs_per_update_step": 6 * n_params * effective_batch * config.T * config.S,
        "num_datasets": len(domains),
        "device": str(device),
    }}
    ckpt_every = (int(args.checkpointing_steps)
                  if str(args.checkpointing_steps).isdigit() else None)

    def save(tag, **kw):
        save_checkpoint(args.output_dir, tag, model.state_dict(), config,
                        opt_state=tx.state_dict(), step=step_i, **kw)

    step_i = start_step
    # replay the epoch and intra-epoch sampler position of a resumed run
    epoch, skip = divmod(start_step, steps_per_epoch)
    t_last = time.time()
    last_metrics: dict = {}
    nan_streak = 0  # consecutive log points whose sampled step was skipped
    with MetricLogger(args.output_dir, config=exp_config) as logger:
        while step_i < max_steps:
            sampler.set_epoch(epoch)
            for indices in sampler:
                if step_i >= max_steps:
                    break
                if skip > 0:
                    skip -= 1
                    continue
                metrics = train_step(assembler(indices, step=step_i))
                step_i += 1

                if step_i % args.log_every == 0 or step_i == max_steps:
                    m = {k: float(v) for k, v in metrics.items()}
                    dt = time.time() - t_last
                    m["steps_per_sec"] = args.log_every / max(dt, 1e-9)
                    m["lr"] = schedule(step_i)
                    t_last = time.time()
                    logger.log({f"train/{k}": v for k, v in m.items()}, step=step_i)
                    last_metrics = m
                    # fail loudly when the NaN guard freezes training; two
                    # skipped log points at least, so that one sampled
                    # transient never ends a run (hma_tpu aborts on one when
                    # log_every >= max_nan_skip_steps)
                    nan_streak = nan_streak + 1 if m["skipped"] else 0
                    if (nan_streak >= 2 and
                            nan_streak * args.log_every >= args.max_nan_skip_steps > 0):
                        raise RuntimeError(
                            f"non-finite loss or gradients for >= "
                            f"{nan_streak * args.log_every} consecutive steps at "
                            f"step {step_i}: the NaN guard skips every update. "
                            "Lower the lr, add weight decay, or set qk_norm=true.")

                if step_i % args.eval_every_n_steps == 0 or step_i == max_steps:
                    logger.log({f"val/{k}": v for k, v in run_eval(
                        eval_step, val_assembler, val_sets, args).items()},
                        step=step_i)

                if (args.vis_every_n_steps and step_i % args.vis_every_n_steps == 0
                        and step_i < max_steps):
                    logger.log({f"vis/{k}": v for k, v in rollout_eval(
                        model, val_assembler, val_sets, args, config).items()},
                        step=step_i)

                if ckpt_every and step_i % ckpt_every == 0:
                    save(f"step_{step_i}", keep_last=args.keep_checkpoints)
            epoch += 1
            if args.checkpointing_steps == "epoch":
                save(f"epoch_{epoch}", keep_last=args.keep_checkpoints)
            if args.save_second_epoch and epoch == 1:
                save("epoch_1_pinned")  # outside the retention policy
        save("final_checkpt")
    return last_metrics


def run_eval(eval_step, val_assembler: BatchAssembler, val_sets,
             args: TrainArgs) -> dict:
    """Teacher-forced eval over up to `max_eval_steps` val batches."""
    sampler = MultiTaskBatchSampler([len(d) for d in val_sets],
                                    batch_size=args.per_device_eval_batch_size,
                                    temperature=4.0, seed=0)
    sums: dict = {}
    n = 0
    for i, indices in enumerate(sampler):
        if i >= args.max_eval_steps:
            break
        out = eval_step(val_assembler(indices))
        for k in ("loss", "acc"):
            sums[k] = sums.get(k, 0.0) + float(out[k])
        n += 1
    out = {k: v / max(n, 1) for k, v in sums.items()}
    if "loss" in out:
        out["perplexity"] = math.exp(min(out["loss"], 30))
    return out


def rollout_eval(model: STMaskGIT, val_assembler: BatchAssembler, val_sets,
                 args: TrainArgs, config: GenieConfig) -> dict:
    """Roll out the future frames of one val batch with the KV-cached engine
    (2 MaskGIT steps) and report the share of tokens equal to the ground
    truth. Pixel PSNR/LPIPS need the tokenizer: not ported."""
    sampler = MultiTaskBatchSampler([len(d) for d in val_sets],
                                    batch_size=args.per_device_eval_batch_size,
                                    temperature=4.0, seed=1)
    batch = val_assembler(next(iter(sampler)))
    tokens = batch["labels"]
    p = config.num_prompt_frames
    out = generate_tokens(model, tokens, p, batch.get("action_ids"),
                          batch["domain_id"],
                          torch.Generator(tokens.device).manual_seed(0),
                          maskgit_steps=2)
    return {"rollout_token_match": float((out[:, p:] == tokens[:, p:]).float().mean())}
