"""Multi-dataset training loop (counterpart of hma_tpu/train/trainer.py).

Both families, on one card or data-parallel over processes: per-domain
memmap datasets from a datasplit file (`{domain}_magvit_max1000000_{split}`
token sets for the discrete STMaskGIT, `{domain}_vae_max1000000_{split}`
latent sets for the continuous STMAR), temperature-weighted batch sampling,
the training step of `train/step.py`, periodic teacher-forced eval, a
token-match rollout eval (discrete only, as in `hma_tpu`) and checkpointing
with bit-exact resume (the sampler position is replayed, each step's
collate RNG is derived from (seed, step) and its training draws from the
step number). The model runs in bf16 on the card and in fp32 on the CPU;
parameters and optimizer state are fp32 on both. With a MagVit2 checkpoint
(`--tokenizer_checkpoint`, a `.ckpt` or a `train_tokenizer` directory) the
discrete rollout eval also decodes prediction and ground truth to pixels
and reports their PSNR, and with `--lpips_weights` (an AlexNet LPIPS state
dict) their LPIPS. With `--use_native_loader` the batches come from the C++
loader (`data/native_loader.py`), one per domain, resumed bit for bit.
`--mu_transfer` trains with muP (width mult d_model / 256, the matrix-like
parameters found against the card at half its head dim), and
`--adam_moment_dtype bfloat16` keeps Adam's moments in bf16 with stochastic
rounding; checkpoints hold them in bf16. `--lr_scheduler_type` other than
"custom_cosine" gives optax's warmup cosine decay to 0, as in `hma_tpu`
(whatever the name says: "linear" too).

Sliced gradients (`--sliced_grads`, `train/step.py`): "auto" turns them on
when the domain-sliced AdamW is active and the world is one process, as
`hma_tpu` does with no mesh; "on" and "off" force them ("on" under fsdp,
tp or sp raises: ROADMAP.md Queue A item 10e).

Data parallelism over the mesh's data axes "dp" and "fsdp" (`parallel/`):
launched with torchrun (or `hma_tpu`'s HMA_TPU_* variables), one process a
card, the factors filling the world. The global batch is the per-device
batch times the world (every card of the mesh, as `hma_tpu` counts its
devices) and the LR scales by the effective batch; every rank runs the same
sampler stream (so every rank trains the same domain), loads and collates
its data index's rows of each global batch, draws those rows of the
batch's random draws, and the gradients are summed over the data axes
(the loss is the global batch's mean), so that N ranks train as one process
on the global batch. Under "dp" alone parameters and moments are
replicated and the step sums the gradients. With `--tp` above 1 the
model's heads and MLP features are split over the tp ranks, with `--sp`
above 1 its trunk runs on the sp ranks' tokens of every frame (the ranks of
a tp or sp group share their rows and draws), and with `--fsdp` above 1 it
is sharded by FSDP2 on each tp rank's parts (`parallel.mesh.shard_model`,
after rank 0's initial weights or the resumed checkpoint are in place); the
optimizer updates each rank's parts, and a checkpoint gathers them whole
first (sp holds whole parameters). Rank 0 logs and writes the checkpoints,
every rank reads them. Not ported (they raise): the native loader with more
than one process, as in `hma_tpu`, and wandb.
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

from hma_tpu_torch.config import DiffusionGenieConfig, GenieConfig, load_config
from hma_tpu_torch.data.collators import maskgit_collate, maskgit_collate_feature
from hma_tpu_torch.data.datasets import RawFeatureDataset, RawTokenDataset
from hma_tpu_torch.data.sampler import MultiTaskBatchSampler
from hma_tpu_torch.metrics.image import batch_psnr
from hma_tpu_torch.metrics.lpips import make_lpips_fn
from hma_tpu_torch.models.st_mar import STMAR
from hma_tpu_torch.models.st_mask_git import STMaskGIT
from hma_tpu_torch.parallel import distributed
from hma_tpu_torch.parallel.mesh import check_factors, make_mesh, shard_model
from hma_tpu_torch.rollout.decode import make_token_decoder
from hma_tpu_torch.rollout.maskgit import generate_tokens
from hma_tpu_torch.tokenizer.convert import load_magvit2
from hma_tpu_torch.train.step import (
    custom_cosine_schedule,
    domain_stacked_mask,
    make_domain_sliced_optimizer,
    make_eval_step,
    make_optimizer,
    make_train_step,
    scale_lr_by_batch,
    warmup_cosine_decay_schedule,
)
from hma_tpu_torch.utils.checkpoint import (
    gather_state,
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
    model_type: str = "discrete"  # discrete | continuous
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
    # sliced gradients: "auto" = on with the domain-sliced AdamW and one
    # process, "on" / "off" force them
    sliced_grads: str = "auto"
    device: Optional[str] = None


def _refuse_unported(args: TrainArgs) -> None:
    if args.model_type not in ("discrete", "continuous"):
        raise ValueError(f"--model_type {args.model_type}")
    unported = {
        "--sliced_grads on with --fsdp, --tp or --sp above 1 (item 10e)": (
            args.sliced_grads == "on" and max(args.fsdp, args.tp, args.sp) > 1),
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
    """Per-domain train/val datasets and the shared metadata: token sets
    for the discrete family, latent sets for the continuous one."""
    domains = read_domains(args.train_split)
    discrete = args.model_type == "discrete"
    fmt = ("{root}/{domain}_magvit_max1000000_{split}" if discrete
           else "{root}/{domain}_vae_max1000000_{split}")
    shared_keys = (("s", "h", "w", "vocab_size") if discrete
                   else ("s", "h", "w", "latent_channels"))
    kwargs = dict(window_size=args.window_size, stride=args.stride,
                  max_traj_num=args.num_episodes_per_dataset,
                  use_actions=config.use_actions)
    if config.drop_action_ratio:
        kwargs["drop_action_ratio"] = config.drop_action_ratio

    def dataset(domain, split, filter_overlaps):
        path = fmt.format(root=args.data_root, domain=domain, split=split)
        if discrete:
            return RawTokenDataset(path, filter_overlaps=filter_overlaps, name=domain,
                                   **kwargs)
        return RawFeatureDataset(path, filter_overlaps=filter_overlaps, domain=domain,
                                 **kwargs)

    train_sets, val_sets, action_dims, action_stats = [], [], [], []
    for domain in domains:
        tds = dataset(domain, "train", args.filter_overlaps)
        train_sets.append(tds)
        action_dims.append(tds.n_action)
        if config.use_actions:
            action_stats.append(tds.action_stat)
        if args.overfit_first_batch:
            val_sets.append(tds)  # truncated to one batch in run_training
        else:
            val_sets.append(dataset(domain, "val", True))
    meta = train_sets[0].metadata
    shared = {k: meta[k] for k in shared_keys if k in meta}
    return domains, train_sets, val_sets, action_dims, action_stats, shared


def configure_model(args: TrainArgs, config: GenieConfig, domains, action_dims,
                    action_stats, shared_metadata) -> GenieConfig:
    """Inject the dataset-derived fields into the model config."""
    config.use_mup = args.mu_transfer
    if "vocab_size" in shared_metadata:
        config.image_vocab_size = shared_metadata["vocab_size"]
    config.T = args.window_size
    config.S = shared_metadata["h"] * shared_metadata["w"]
    if args.model_type == "continuous":
        config.vae_embed_dim = shared_metadata["latent_channels"]
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
    """Sampler indices -> collated batch of tensors on `device`: (B, T, S)
    token ids, or (B, T, h, w, C) latents and their
    `masked_tokens_indicator` when `discrete` is False."""

    def __init__(self, datasets, config: GenieConfig, seed: int, device,
                 rng: np.random.Generator, discrete: bool = True):
        self.datasets = datasets
        self.offsets = np.cumsum([0] + [len(d) for d in datasets[:-1]])
        self.config = config
        self.seed = seed
        self.device = device
        self.rng = rng
        self.discrete = discrete

    def __call__(self, global_indices: np.ndarray, step: Optional[int] = None,
                 rows: Optional[np.ndarray] = None) -> dict:
        """A training call passes `step`: the collate RNG is then derived
        from (seed, step), so a resumed run collates step k as a straight
        run does. `rows`: the positions in `global_indices` this process
        loads (data parallelism); the collate draws for the whole batch."""
        ds_idx = int(np.searchsorted(self.offsets, global_indices[0], side="right") - 1)
        local = global_indices if rows is None else global_indices[rows]
        items = [self.datasets[ds_idx][int(i)] for i in local - self.offsets[ds_idx]]
        rng = self.rng if step is None else np.random.default_rng([self.seed, int(step)])
        collate = maskgit_collate if self.discrete else maskgit_collate_feature
        batch = collate(items, self.config, rng, rows, len(global_indices))
        B, T = len(items), self.config.T
        h, w = batch["h"][0], batch["w"][0]
        if self.discrete:
            out = {k: torch.from_numpy(batch[k].reshape(B, T, h * w).astype(np.int64))
                   .to(self.device) for k in ("input_ids", "labels")}
        else:
            C = batch["input_ids"].shape[-1]
            out = {k: torch.from_numpy(batch[k].reshape(B, T, h, w, C)).to(self.device)
                   for k in ("input_ids", "labels")}
            out["masked_tokens_indicator"] = torch.from_numpy(
                batch["masked_tokens_indicator"]).to(self.device)
        if "action_ids" in batch:
            out["action_ids"] = torch.from_numpy(_pad_actions(
                batch["action_ids"], self.config.max_d_action)).to(self.device)
        out["domain_id"] = ds_idx
        return out


def native_batch(batch: dict, ds_idx: int, device, discrete: bool) -> dict:
    """A native loader's numpy batch as the assembler's tensors on `device`:
    int64 token ids, or fp32 latents with their int32 mask; the loader's
    actions are already padded to `max_d_action`."""
    out = {k: torch.from_numpy(v.astype(np.int64) if discrete and k != "action_ids" else v)
           .to(device) for k, v in batch.items()}
    out["domain_id"] = ds_idx
    return out


def make_native_loaders(args: TrainArgs, config: GenieConfig, domains, batch_size: int,
                        start_counts, discrete: bool) -> list:
    """One C++ loader a domain over `{domain}_magvit_max1000000_train` (tokens)
    or `{domain}_vae_max1000000_train` (latents), domain i seeded seed + i and
    started at batch `start_counts[i]`. The stride is the loader's default,
    from the dataset's frequency, as `hma_tpu`'s trainer leaves it."""
    from hma_tpu_torch.data.native_loader import NativeFeatureLoader, NativeTokenLoader

    loader, kind = ((NativeTokenLoader, "magvit") if discrete
                    else (NativeFeatureLoader, "vae"))
    return [loader(f"{args.data_root}/{d}_{kind}_max1000000_train", config,
                   batch_size=batch_size, seed=args.seed + i,
                   action_width=config.max_d_action, start_batch=int(start_counts[i]))
            for i, d in enumerate(domains)]


def native_start_counts(sampler: MultiTaskBatchSampler, steps_per_epoch: int,
                        start_step: int, seed: int) -> np.ndarray:
    """The batches each domain's loader delivered before `start_step`: the
    training loop's domain draws replayed (one generator an epoch, seeded
    seed + epoch, one draw a step, as the loop draws them one at a time)."""
    n = len(sampler.dataset_sizes)
    counts = np.zeros(n, np.int64)
    if start_step:
        dist = sampler.generate_tasks_distribution()
        done_epochs = start_step // steps_per_epoch
        for e in range(done_epochs + 1):
            r = np.random.default_rng(seed + e)
            for _ in range(steps_per_epoch if e < done_epochs else start_step % steps_per_epoch):
                counts[int(r.choice(n, p=dist))] += 1
    return counts


def stacked_param_mask(model, config: GenieConfig) -> dict[str, bool]:
    """The same model (its own class: STMaskGIT or STMAR) with one more
    domain, built on the meta device: the parameters whose shapes change are
    the domain-stacked tables."""
    alt = copy.deepcopy(config)
    alt.action_domains = list(config.action_domains) + ["__probe__"]
    alt.d_actions = list(config.d_actions) + [config.d_actions[-1]]
    if config.action_stats:
        alt.action_stats = list(config.action_stats) + [config.action_stats[-1]]
    return domain_stacked_mask(model, type(model)(alt, dtype=model.dtype, device="meta"))


def mup_base_model(model, config: GenieConfig):
    """The same model (its own class) at mup's base shapes, built on the
    meta device: the card with its head dim halved, as `hma_tpu`'s trainer
    builds it for `mup_matrix_mask`."""
    head_dim = config.d_model // config.num_heads
    base = dataclasses.replace(config, d_model=config.num_heads * max(head_dim // 2, 1))
    return type(model)(base, dtype=model.dtype, device="meta")


def run_training(args: TrainArgs) -> dict:
    """Main loop; returns the metrics of the last log point."""
    _refuse_unported(args)
    # a launcher's environment joins the process group before anything
    # touches the card; the factors must fill the world exactly
    multi = distributed.init_distributed(device=args.device)
    world = distributed.process_count()
    check_factors(args.dp, args.fsdp, args.tp, args.sp, world)
    mesh = make_mesh(dp=args.dp, fsdp=args.fsdp, tp=args.tp, sp=args.sp) if multi else None
    group = distributed.data_group()  # None with one data index
    if args.use_native_loader and world > 1:
        raise ValueError("--use_native_loader is one process only: data-parallel "
                         "ranks load their rows through the Python assembler")
    device = distributed.local_device(args.device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    config = load_config(args.genie_config)
    continuous = args.model_type == "continuous"
    if continuous and not isinstance(config, DiffusionGenieConfig):
        config = DiffusionGenieConfig(**{f.name: getattr(config, f.name)
                                         for f in dataclasses.fields(GenieConfig)})
    domains, train_sets, val_sets, action_dims, action_stats, shared = (
        build_domain_datasets(args, config))
    config = configure_model(args, config, domains, action_dims, action_stats, shared)

    B = args.per_device_train_batch_size * world  # the global batch a microbatch
    effective_batch = B * args.gradient_accumulation_steps
    # this rank's rows of each effective batch: its share of every microbatch
    rows = (None if group is None else np.concatenate(
        [distributed.local_slice(r) for r in np.arange(effective_batch).reshape(-1, B)]))
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
    if args.lr_scheduler_type == "custom_cosine":
        schedule = custom_cosine_schedule(lr, args.num_warmup_steps, max_steps)
    else:
        schedule = warmup_cosine_decay_schedule(lr, args.num_warmup_steps, max_steps)
    assembler = BatchAssembler(train_sets, config, args.seed, device,
                               np.random.default_rng(args.seed), not continuous)
    val_assembler = BatchAssembler(val_sets, config, args.seed, device,
                                   np.random.default_rng(0), not continuous)

    model = (STMAR if continuous else STMaskGIT)(
        config, dtype=dtype, device=device,
        generator=torch.Generator(device).manual_seed(args.seed),
        remat=args.grad_checkpointing)
    if multi:  # every rank starts from rank 0's draw
        distributed.broadcast_(list(model.parameters()), src=0)
    start_step = 0
    resume = args.resume_from_checkpoint
    if resume == "latest":
        resume = latest_checkpoint(args.output_dir)
    if resume:
        model_state, opt_state, start_step = load_train_state(resume, device)
        model.load_state_dict(model_state)
    mup_mult = config.d_model / 256.0 if args.mu_transfer else None
    opt_kw = dict(learning_rate=schedule, weight_decay=args.weight_decay,
                  beta1=args.adam_beta_1, beta2=args.adam_beta_2, eps=args.adam_eps,
                  max_grad_norm=args.max_grad_norm, mup_width_mult=mup_mult,
                  mup_base=(mup_base_model(model, config)
                            if mup_mult not in (None, 1.0) else None),
                  moment_dtype=args.adam_moment_dtype)
    smask = None
    if args.domain_sliced_adam and config.num_domains > 1:
        smask = stacked_param_mask(model, config)
    if max(args.fsdp, args.tp, args.sp) > 1:  # the whole weights are in place: split, shard
        shard_model(model, mesh)
    if smask is not None:
        tx = make_domain_sliced_optimizer(model, **opt_kw, stacked_mask=smask,
                                          num_domains=config.num_domains)
    else:
        tx = make_optimizer(model, **opt_kw)
    if resume:
        tx.load_state_dict(opt_state)
    sliced_grads = smask is not None and (
        args.sliced_grads == "on" or (args.sliced_grads == "auto" and world == 1))

    # The C++ loader implements neither per-item action dropping nor the
    # truncated one-batch dataset of overfit_first_batch: with either, the
    # Python assembler serves the batches, as in hma_tpu. Each loader starts
    # at the batches it had delivered before start_step, so a resumed run
    # draws what a straight one does.
    native_loaders = None
    if (args.use_native_loader and not args.overfit_first_batch
            and not getattr(config, "drop_action_ratio", 0.0)):
        native_loaders = make_native_loaders(
            args, config, domains, effective_batch,
            native_start_counts(sampler, steps_per_epoch, start_step, args.seed),
            not continuous)

    # a rank's rows of each microbatch
    microbatch = B // distributed.data_count() if args.gradient_accumulation_steps > 1 else 0
    step_kw = dict(continuous=continuous, action_loss_weight=config.action_loss_weight,
                   group=group)
    train_step = make_train_step(model, tx, microbatch=microbatch,
                                 stacked_mask=smask if sliced_grads else None, **step_kw)
    eval_step = make_eval_step(model, **step_kw)

    # pixel-space visualisation of the discrete rollout eval
    vis_decode = vis_lpips = None
    if args.tokenizer_checkpoint and not continuous:
        vis_decode = make_token_decoder(*load_magvit2(args.tokenizer_checkpoint),
                                        device=device)
        if args.lpips_weights:
            vis_lpips = make_lpips_fn(
                torch.load(args.lpips_weights, map_location="cpu", weights_only=True),
                net="alex", device=device)

    n_params = sum(p.numel() for p in model.parameters())
    exp_config = {**dataclasses.asdict(args), **{
        "model_parameters": int(n_params),
        "model_parameters_M": round(n_params / 1e6),
        "effective_batch_size": effective_batch,
        "seq_len": config.T * config.S,
        "FLOPs_per_update_step": 6 * n_params * effective_batch * config.T * config.S,
        "num_datasets": len(domains),
        "device": str(device),
        "world_size": world,
        "process_group": torch.distributed.get_backend() if multi else None,
        "sliced_grads_active": sliced_grads,
    }}
    ckpt_every = (int(args.checkpointing_steps)
                  if str(args.checkpointing_steps).isdigit() else None)

    def save(tag, **kw):
        # every rank gathers the fsdp shards and tp parts whole (collectives);
        # one writer
        tp = (getattr(model, "tp", None), getattr(model, "tp_parts", None))
        model_state = gather_state(model.state_dict(), *tp)
        opt_state = gather_state(tx.state_dict(), *tp)
        if distributed.is_primary():
            save_checkpoint(args.output_dir, tag, model_state, config,
                            opt_state=opt_state, step=step_i, **kw)

    step_i = start_step
    # replay the epoch and intra-epoch sampler position of a resumed run
    epoch, skip = divmod(start_step, steps_per_epoch)
    t_last = time.time()
    last_metrics: dict = {}
    nan_streak = 0  # consecutive log points whose sampled step was skipped
    with MetricLogger(args.output_dir, config=exp_config,
                      enabled=distributed.is_primary()) as logger:
        while step_i < max_steps:
            sampler.set_epoch(epoch)
            # the native path's domain draw: one generator an epoch
            dist = sampler.generate_tasks_distribution()
            task_rng = np.random.default_rng(args.seed + epoch)
            for indices in sampler:
                if step_i >= max_steps:
                    break
                if skip > 0:
                    skip -= 1
                    if native_loaders is not None:
                        task_rng.choice(len(native_loaders), p=dist)
                    continue
                if native_loaders is not None:
                    ds_idx = int(task_rng.choice(len(native_loaders), p=dist))
                    batch = native_batch(native_loaders[ds_idx].next_batch(), ds_idx,
                                         device, not continuous)
                else:
                    batch = assembler(indices, step=step_i, rows=rows)
                # the step's draws are keyed by its number, as hma_tpu's
                # PRNGKey(step): a resumed run draws what a straight one does
                metrics = train_step(batch, rng=step_i)
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
                        and step_i < max_steps and not continuous and world == 1):
                    logger.log({f"vis/{k}": v for k, v in rollout_eval(
                        model, val_assembler, val_sets, args, config, vis_decode,
                        vis_lpips).items()}, step=step_i)

                if ckpt_every and step_i % ckpt_every == 0:
                    save(f"step_{step_i}", keep_last=args.keep_checkpoints)
            epoch += 1
            if args.checkpointing_steps == "epoch":
                save(f"epoch_{epoch}", keep_last=args.keep_checkpoints)
            if args.save_second_epoch and epoch == 1:
                save("epoch_1_pinned")  # outside the retention policy
        save("final_checkpt")
    for loader in native_loaders or ():
        loader.close()
    if multi:  # rank 0's checkpoint is whole before any rank returns
        torch.distributed.barrier()
    return last_metrics


def run_eval(eval_step, val_assembler: BatchAssembler, val_sets,
             args: TrainArgs) -> dict:
    """Teacher-forced eval over up to `max_eval_steps` val batches of the
    per-device batch times the world size, each rank on its data index's
    rows."""
    B = args.per_device_eval_batch_size * distributed.process_count()
    rows = distributed.local_slice(np.arange(B)) if distributed.data_count() > 1 else None
    sampler = MultiTaskBatchSampler([len(d) for d in val_sets], batch_size=B,
                                    temperature=4.0, seed=0)
    sums: dict = {}
    n = 0
    for i, indices in enumerate(sampler):
        if i >= args.max_eval_steps:
            break
        out = eval_step(val_assembler(indices, rows=rows), rng=i)
        for k in ("loss", "acc", "action_loss"):
            if k in out:
                sums[k] = sums.get(k, 0.0) + float(out[k])
        n += 1
    out = {k: v / max(n, 1) for k, v in sums.items()}
    if "loss" in out:
        out["perplexity"] = math.exp(min(out["loss"], 30))
    return out


def rollout_eval(model: STMaskGIT, val_assembler: BatchAssembler, val_sets,
                 args: TrainArgs, config: GenieConfig, decode=None, lpips_fn=None) -> dict:
    """Roll out the future frames of one val batch with the KV-cached engine
    (2 MaskGIT steps) and report the share of tokens equal to the ground
    truth; with a token decoder (`decode`), also the mean PSNR of the
    decoded prediction against the decoded ground truth, and with
    `lpips_fn` their mean LPIPS."""
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
    gen, gt = out[:, p:], tokens[:, p:]
    metrics = {"rollout_token_match": float((gen == gt).float().mean())}
    if decode is not None:
        h = w = math.isqrt(config.S)
        pred_px = decode(gen.reshape(-1, h, w))
        gt_px = decode(gt.reshape(-1, h, w))
        metrics["rollout_psnr"] = float(np.mean(batch_psnr(pred_px, gt_px)))
        if lpips_fn is not None:
            metrics["rollout_lpips"] = float(np.mean(lpips_fn(pred_px, gt_px)))
    return metrics
