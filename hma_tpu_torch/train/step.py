"""Training step, optimizers and LR schedules
(counterpart of hma_tpu/train/step.py).

Every update is written out in plain tensor ops so that it equals the JAX
package's optax chain number for number:
  - AdamW with weight decay on everything except biases and LayerNorm /
    DomainLayerNorm scales, after a global-norm clip (`make_optimizer`);
  - the domain-sliced AdamW (`make_domain_sliced_optimizer`): per-domain
    Adam counts, one clip over the dense grads plus the active domain's
    rows, and only row `d` of each domain-stacked table and of its moments
    updated;
  - muP (`mup_width_mult`): the matrix-like parameters (`mup_matrix_mask`)
    take lr / width_mult and weight decay * width_mult, the rest the plain
    rule, in both optimizers;
  - bf16 moments (`moment_dtype`, `train/lowp.py`): fp32 math, m and v
    upcast on read and stochastically rounded on write, in both optimizers
    (the sliced one rounds and writes row `d` only);
  - the NaN guard: a non-finite loss or grad norm zeroes the grads (the
    moments still decay and the counts still advance, which is why this
    is not `torch.optim.AdamW`) and applies no update;
  - grad accumulation over `microbatch` chunks;
  - one step for both families (`continuous=True`: STMAR's diffusion loss
    with `masked_tokens_indicator`, plus `action_loss_weight` times the
    action head's loss on joint cards).

Random draws: a step takes an integer `rng`, as `hma_tpu`'s takes a key.
From it each (micro)batch gets two generators: one on the model's device
for the diffusion timesteps and noise, STMAR's action-suffix start and
STMaskGIT's action drop (joint cards), and one
on the CPU for the trunk's dropout seeds (one per block, so drawing them
never waits for the card). The tests hand the draws in instead (`draws`).

Parameters, moments and grads are fp32 and are updated in place. With
`stacked_mask` (sliced gradients, `hma_tpu`'s `make_train_step(stacked_mask=)`)
the step swaps every domain-stacked table for a one-row leaf, a view of the
active domain's row, for the forward and backward: autograd forms (1, ...)
grads and never a full-size one, and the stacked tables hold no `.grad`.
Without it the stacked tables' grads arrive full-size and are read at row
`d`.

Data parallelism (`group`, a process group whose ranks hold the rest of the
global batch): every loss denominator is summed over the ranks before the
division (`distributed.global_count`), so each rank's loss is its share of
the global-batch mean and the gradients (row grads too) and metrics are
summed over the ranks; the NaN guard then decides the same on every rank.
A rank draws its rows of the global batch's dropout masks, diffusion noise
and action drops (`generators`), so that N ranks take the step one process
takes on the whole batch.

fsdp (a model sharded by `parallel.mesh.shard_model`, its parameters
DTensors): FSDP2 sums the gradients over the data axes itself (reduce-
scatter, and an all-reduce over "dp" under HSDP), so the step does not; the
optimizers update each rank's shards (`to_local()`), with the moments
sharded as their parameters are, the clip's global norm summed over the
shards and the low-precision moments' random bits drawn at each leaf's
global shape (`MomentNoise`), so the ranks take the step one process takes.

tp (a model split by `parallel.tensor_parallel.split_model`, `model.tp` and
`model.tp_parts`): the split parameters' grads are this rank's parts and
the replicated ones whole and equal on every rank of the tp group, so the
step sums grads over the data group only; the clip's global norm sums the
squared norms of the split grads over the tp group and counts each
replicated one once; the optimizer updates the rank's parts, and a
low-precision moment's random bits are the rank's part of the draw at the
parameter's whole shape, taken through the same dealt columns
(`tensor_parallel.take`), then its fsdp shard's.
sp (a model whose trunk runs on the rank's tokens,
`parallel.sequence_parallel.enable`, `model.sp`): parameters are whole and
equal on the ranks of an sp group, so the bf16 moments' bits are too. Each
rank's loss counts 1 / sp in the backward (the metrics are the whole
loss), and after it every gradient is summed once over `model.sp_grads`:
the data and sp ranks together where FSDP2 does not shard the model, the
sp group on the shards after FSDP2's reduce-scatter where it does. That
gives one process's gradient; the clip's norm is taken after the sum
(`sequence_parallel`'s convention).
Sliced gradients under fsdp, tp or sp are ROADMAP.md Queue A item 10e and
raise.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor

from hma_tpu_torch.models.action_stems import DomainLayerNorm
from hma_tpu_torch.models.attention import LayerNorm
from hma_tpu_torch.parallel.distributed import all_reduce_sum_, rank_rows
from hma_tpu_torch.parallel.mesh import (
    full,
    local,
    shard_group,
    shard_slices,
)
from hma_tpu_torch.parallel.tensor_parallel import take
from hma_tpu_torch.train.lowp import (
    DENSE_TAG,
    SLICED_TAG,
    MomentNoise,
    adamw_lowp_,
    resolve_moment_dtype,
)

Schedule = Callable[[int], float]
SLICED_FSDP = ("sliced gradients under fsdp, tp or sp are not ported yet (ROADMAP.md "
               "Queue A item 10e): the one-row swap would replace parameters that FSDP2 "
               "or the tp split owns; use --sliced_grads off or auto")


def custom_cosine_schedule(base_lr: float, warmup_steps: int, max_steps: int,
                           end_ratio: float = 0.1) -> Schedule:
    """Linear warmup, then cosine decay to end_ratio * peak."""

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return base_lr * (step + 1) / max(warmup_steps, 1)
        remaining = max(max_steps - warmup_steps, 1)
        cos = (1 + math.cos(math.pi * (step - warmup_steps) / remaining)) / 2
        return base_lr * (cos * (1 - end_ratio) + end_ratio)

    return schedule


def warmup_cosine_decay_schedule(peak_value: float, warmup_steps: int,
                                 decay_steps: int) -> Schedule:
    """optax.warmup_cosine_decay_schedule(0, peak_value, warmup_steps,
    decay_steps): linear from 0 to peak_value over warmup_steps, then
    cosine decay to 0, reached at step decay_steps and held."""
    if decay_steps - warmup_steps <= 0:
        raise ValueError(f"decay_steps {decay_steps} must exceed warmup_steps "
                         f"{warmup_steps}")
    span = decay_steps - warmup_steps

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return peak_value * max(step, 0) / warmup_steps
        return peak_value * 0.5 * (1 + math.cos(math.pi * min(step - warmup_steps, span) / span))

    return schedule


def scale_lr_by_batch(lr: float, effective_batch_size: int) -> float:
    return lr * min(max(1, effective_batch_size / 64), 8)


def weight_decay_mask(model: nn.Module) -> dict[str, bool]:
    """{param name: decayed?}: False for biases and for the scales of
    LayerNorm and DomainLayerNorm (JAX's leaves "bias" and "scale")."""
    mask = {}
    for mod_name, mod in model.named_modules():
        norm = isinstance(mod, (LayerNorm, DomainLayerNorm))
        for leaf, _ in mod.named_parameters(recurse=False):
            name = f"{mod_name}.{leaf}" if mod_name else leaf
            mask[name] = not (leaf == "bias" or (norm and leaf in ("weight", "scale")))
    return mask


def domain_stacked_mask(model: nn.Module, other: nn.Module) -> dict[str, bool]:
    """{param name: domain-stacked?}, decided structurally: `other` is the
    same model at another num_domains (built on device="meta"), and exactly
    the stacked tables change shape."""
    shapes = {n: p.shape for n, p in other.named_parameters()}
    return {n: p.shape != shapes[n] for n, p in model.named_parameters()}


def mup_matrix_mask(model: nn.Module, base: Optional[nn.Module] = None) -> dict[str, bool]:
    """{param name: matrix-like under muP?}: the parameters whose Adam lr
    scales by 1 / width_mult (the reference pins base width 256).

    With `base`, the same model at another width (built on device="meta"),
    mup's infshape rule: a dim is infinite iff it differs from the base's,
    and a parameter is matrix-like iff at least 2 of its dims are. Without,
    `hma_tpu`'s name rule: every parameter of 2 or more dims but biases and
    the token embedding."""
    if base is not None:
        shapes = {n: p.shape for n, p in base.named_parameters()}
        parts = getattr(model, "tp_parts", {})  # a tp-split model: the whole shapes
        return {n: sum(a != b for a, b in zip(parts[n].shape if n in parts else p.shape,
                                              shapes[n])) >= 2
                for n, p in model.named_parameters()}
    return {n: p.ndim >= 2 and n.rsplit(".", 1)[-1] != "bias" and "token_embed" not in n
            for n, p in model.named_parameters()}


def _lr_at(learning_rate: Union[float, Schedule], count: int) -> float:
    return learning_rate(count) if callable(learning_rate) else learning_rate


def _adamw_(p, g, m, v, count: int, lr: float, wd: float, b1: float, b2: float,
            eps: float, ok_f: torch.Tensor) -> None:
    """One optax adamw update of p in place: m, v updated from g (always),
    p += -lr (m_hat / (sqrt(v_hat) + eps) + wd p) * ok_f."""
    m.mul_(b1).add_(g, alpha=1 - b1)
    v.mul_(b2).addcmul_(g, g, value=1 - b2)
    u = (m / (1 - b1**count)) / ((v / (1 - b2**count)).sqrt_() + eps)
    if wd:
        u.add_(p, alpha=wd)
    p.sub_(u.mul_(ok_f * lr))


class AdamW:
    """optax.chain(clip_by_global_norm, adamw(mask=weight decay mask)) over
    named fp32 parameters, with the train step's NaN guard.

    With `mup_width_mult` and a `matrix` mask, the matrix-like parameters
    take lr / width_mult and weight decay * width_mult (decayed whatever
    `decay` says), as `hma_tpu`'s optax.multi_transform partition does.
    With `moment_dtype` bf16, m and v are stored in bf16 and written with
    stochastic rounding (`lowp.adamw_lowp_`).

    On sharded parameters (DTensors, `parallel.mesh.shard_model`) every
    update runs on this rank's shards: the moments are DTensors sharded as
    their parameters, the grad norm is the square root of the squared
    shard norms summed over the shard group, and a low-precision update
    takes its shard's part of bits drawn at the leaf's global shape.

    On a tp-split model (`tp`, the group, and `tp_parts`, {name: Part}) the
    split parameters' squared norms are summed over the group, and their
    bits are drawn at the whole shape and dealt as the parameter is."""

    def __init__(self, params: dict[str, torch.Tensor],
                 learning_rate: Union[float, Schedule], weight_decay: float,
                 beta1: float, beta2: float, eps: float, max_grad_norm: float,
                 decay: dict[str, bool], mup_width_mult: Optional[float] = None,
                 matrix: Optional[dict[str, bool]] = None, moment_dtype=None,
                 tp=None, tp_parts: Optional[dict] = None):
        self.lr = learning_rate
        self.b1, self.b2, self.eps = beta1, beta2, eps
        self.max_grad_norm = max_grad_norm
        mup = mup_width_mult not in (None, 1.0)
        self.lr_mult = {n: 1.0 / mup_width_mult if mup and matrix[n] else 1.0
                        for n in params}
        self.wd = {n: (weight_decay * mup_width_mult if mup and matrix[n]
                       else (weight_decay if decay[n] else 0.0)) for n in params}
        self.moment_dtype = resolve_moment_dtype(moment_dtype) or torch.float32
        self.m = {n: torch.zeros_like(p, dtype=self.moment_dtype) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p, dtype=self.moment_dtype) for n, p in params.items()}
        self.count = 0  # updates so far: Adam's count and the schedule's
        sharded = [isinstance(p, DTensor) for p in params.values()]
        if any(sharded) and not all(sharded):
            raise ValueError("fsdp shards every parameter of the model or none")
        self.shard_group = shard_group(next(iter(params.values()))) if any(sharded) else None
        self.tp, self.tp_parts = tp, dict(tp_parts or {})
        # each leaf's whole shape and its shard's index in its tp part, for
        # the bits
        self.shapes = {n: tuple(self.tp_parts[n].shape if n in self.tp_parts else p.shape)
                       for n, p in params.items()}
        self.parts = {n: shard_slices(p) for n, p in params.items()}

    def _norm(self, grads: dict) -> torch.Tensor:
        """The global norm of the (local) grads: over every shard when the
        parameters are sharded, over the tp parts of the split ones."""
        if self.shard_group is None and self.tp is None:
            return torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g) for g in grads.values()]))

        def sq(names):
            return torch.stack([torch.linalg.vector_norm(grads[n]).square() for n in names]
                               or [next(iter(grads.values())).new_zeros(())]).sum()

        total = sq([n for n in grads if n not in self.tp_parts])
        if self.tp is not None:
            split = sq([n for n in grads if n in self.tp_parts])
            dist.all_reduce(split, group=self.tp.group)
            total = total + split
        if self.shard_group is not None:
            dist.all_reduce(total, group=self.shard_group)
        return total.sqrt()

    def _mine(self, n: str, whole: torch.Tensor, row: bool = False) -> torch.Tensor:
        """This rank's piece of `whole`, a tensor of leaf n's whole shape (of
        its row with `row`): its tp part, then its shard of that."""
        if n in self.tp_parts:
            part = self.tp_parts[n]
            if row:  # a stacked table's row: the domain axis is never split
                part = part._replace(dim=part.dim - 1, shape=part.shape[1:])
            whole = take(whole, part, self.tp.rank, self.tp.size)
        return whole[self.parts[n][1:] if row else self.parts[n]]

    def _update(self, n: str, p, g, m, v, count: int, lr: float, ok_f,
                noise: Optional[dict], draw: Optional[MomentNoise], leaf: int,
                row: bool = False) -> None:
        """Adam update of p (this rank's shard of one parameter, or of its
        row with `row`) with leaf n's lr and decay; low-precision moments
        take this shard's part of leaf n's bits (global shape) from `noise`
        where it is given, else from `draw`."""
        args = (p, g, m, v, count, lr * self.lr_mult[n], self.wd[n], self.b1, self.b2,
                self.eps, ok_f)
        if m.dtype == torch.float32:
            _adamw_(*args)
            return
        shape = self.shapes[n][1:] if row else self.shapes[n]
        if noise is not None:
            bits = noise[n]
        else:
            bits = [draw.bits(leaf, which, shape) for which in (0, 1)]
        adamw_lowp_(*args, *(self._mine(n, b, row) for b in bits))

    def _draw(self, tag: int, count: int, device) -> Optional[MomentNoise]:
        return None if self.moment_dtype == torch.float32 else MomentNoise(tag, count, device)

    def step(self, params: dict, grads: dict, domain_id: int,
             ok_loss: torch.Tensor, noise: Optional[dict] = None) -> torch.Tensor:
        """Update params in place; returns the grad norm (before the clip).
        noise: optional {name: (m bits, v bits)}, the stochastic rounding's
        bits of a low-precision update (at the global shapes), in place of
        the drawn ones."""
        grads = {n: local(g) for n, g in grads.items()}
        g_norm = self._norm(grads)
        ok = ok_loss & torch.isfinite(g_norm)
        # a skipped step clips zero grads: its norm is 0, its scale 1
        norm = torch.where(ok, g_norm, 0.0)
        scale = torch.where(norm < self.max_grad_norm, 1.0,
                            self.max_grad_norm / torch.clamp(norm, min=1e-20))
        scale = torch.where(ok, scale, 0.0)
        ok_f = ok.float()
        lr = _lr_at(self.lr, self.count)
        self.count += 1
        draw = self._draw(DENSE_TAG, self.count, g_norm.device)
        for i, (n, p) in enumerate(params.items()):
            g = torch.where(ok, grads[n], 0.0) * scale
            self._update(n, local(p.data), g, local(self.m[n]), local(self.v[n]),
                         self.count, lr, ok_f, noise, draw, i)
        return g_norm

    def state_dict(self) -> dict:
        """The moments as they are held (DTensors when sharded: a checkpoint
        gathers them whole) and the count."""
        return {"m": self.m, "v": self.v, "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        """From whole moments (any sharding's checkpoint): each rank keeps
        its tp part's shard."""
        for n in self.m:
            for mine, given in ((self.m[n], state["m"][n]), (self.v[n], state["v"][n])):
                local(mine).copy_(self._mine(n, full(given).to(mine.device)))
        self.count = int(state["count"])


class DomainSlicedAdamW(AdamW):
    """AdamW that updates only the active domain's row of every
    domain-stacked table (`stacked` names), with per-domain Adam counts;
    the dense (shared) parameters take the plain AdamW update. The global
    count drives the LR schedule and the dense Adam count alike. One clip
    covers the dense grads and the active rows (the full-tree norm: the
    other rows' grads are exactly zero). A stacked table's grad may arrive
    full-size or as the active row alone, with a leading axis of 1 (the
    sliced-gradient step), as `hma_tpu`'s takes it."""

    def __init__(self, params, learning_rate, weight_decay, beta1, beta2, eps,
                 max_grad_norm, decay, *, stacked: dict[str, bool],
                 num_domains: int, **kw):
        super().__init__(params, learning_rate, weight_decay, beta1, beta2, eps,
                         max_grad_norm, decay, **kw)
        self.stacked = stacked
        self.num_domains = num_domains
        self.domain_count = [0] * num_domains
        # a stacked table's first row on this rank: FSDP2 may shard the domain
        # axis where tp has taken the table's widest (param_spec's rule)
        self.first_row = {n: (self.parts[n][0].start if stacked[n] and isinstance(p, DTensor)
                              else None) for n, p in params.items()}

    def _row(self, n: str, g: torch.Tensor, d: int) -> Optional[torch.Tensor]:
        """Row d of stacked table n's grad (this rank's shard of it): index 0
        of a one-row grad (with one domain the two coincide), else row d, or
        of a shard on the domain axis its row d, None where the rank holds
        none of it."""
        lo = self.first_row[n]
        if lo is not None:
            return g[d - lo] if lo <= d < lo + g.shape[0] else None
        return g[0] if g.shape[0] == 1 and self.num_domains != 1 else g[d]

    def step(self, params: dict, grads: dict, domain_id: int,
             ok_loss: torch.Tensor, noise: Optional[dict] = None) -> torch.Tensor:
        """As `AdamW.step`; a stacked table's bits are its row's. The dense
        leaves' bits are drawn from the global count after this update, the
        rows' from it before, as `hma_tpu` keys them."""
        d = int(domain_id)
        rows = {n: (self._row(n, local(g), d) if self.stacked[n] else local(g))
                for n, g in grads.items()}
        g_norm = self._norm({n: r for n, r in rows.items() if r is not None})
        ok = ok_loss & torch.isfinite(g_norm)
        scale = torch.where(g_norm < self.max_grad_norm, 1.0,
                            self.max_grad_norm / torch.clamp(g_norm, min=1e-20))
        ok_f = ok.float()
        lr = _lr_at(self.lr, self.count)
        rows_draw = self._draw(SLICED_TAG, self.count, g_norm.device)
        self.count += 1
        self.domain_count[d] += 1
        dense_draw = self._draw(DENSE_TAG, self.count, g_norm.device)
        for i, (n, p) in enumerate(params.items()):
            if rows[n] is None:  # another rank holds row d
                continue
            g = torch.where(ok, rows[n] * scale, 0.0)
            p, m, v = local(p.data), local(self.m[n]), local(self.v[n])
            if self.stacked[n]:
                r = d - (self.first_row[n] or 0)
                self._update(n, p[r], g, m[r], v[r], self.domain_count[d], lr, ok_f,
                             noise, rows_draw, i, row=True)
            else:
                self._update(n, p, g, m, v, self.count, lr, ok_f, noise, dense_draw, i)
        return g_norm

    def state_dict(self) -> dict:
        return {**super().state_dict(), "domain_count": list(self.domain_count)}

    def load_state_dict(self, state: dict) -> None:
        super().load_state_dict(state)
        self.domain_count = [int(c) for c in state["domain_count"]]


def _mup_kw(model: nn.Module, mup_width_mult, mup_base, moment_dtype) -> dict:
    """The optimizer's muP, moment and tp arguments for `model`."""
    matrix = (mup_matrix_mask(model, mup_base)
              if mup_width_mult not in (None, 1.0) else None)
    return dict(mup_width_mult=mup_width_mult, matrix=matrix, moment_dtype=moment_dtype,
                tp=getattr(model, "tp", None), tp_parts=getattr(model, "tp_parts", None))


def make_optimizer(model: nn.Module, learning_rate, weight_decay: float = 0.01,
                   beta1: float = 0.9, beta2: float = 0.999, eps: float = 1e-8,
                   max_grad_norm: float = 1.0,
                   mup_width_mult: Optional[float] = None,
                   mup_base: Optional[nn.Module] = None,
                   moment_dtype=None) -> AdamW:
    """Global-norm clip, then AdamW with the weight-decay mask; muP with
    `mup_width_mult` (= d_model / 256; `mup_base` the base-width model for
    `mup_matrix_mask`), bf16 moments with `moment_dtype`."""
    return AdamW(dict(model.named_parameters()), learning_rate, weight_decay,
                 beta1, beta2, eps, max_grad_norm, weight_decay_mask(model),
                 **_mup_kw(model, mup_width_mult, mup_base, moment_dtype))


def make_domain_sliced_optimizer(model: nn.Module, learning_rate,
                                 weight_decay: float = 0.01, beta1: float = 0.9,
                                 beta2: float = 0.999, eps: float = 1e-8,
                                 max_grad_norm: float = 1.0, *,
                                 stacked_mask: dict[str, bool], num_domains: int,
                                 mup_width_mult: Optional[float] = None,
                                 mup_base: Optional[nn.Module] = None,
                                 moment_dtype=None) -> DomainSlicedAdamW:
    """The domain-sliced AdamW; `stacked_mask` from `domain_stacked_mask`;
    muP and moments as `make_optimizer`."""
    return DomainSlicedAdamW(dict(model.named_parameters()), learning_rate,
                             weight_decay, beta1, beta2, eps, max_grad_norm,
                             weight_decay_mask(model), stacked=stacked_mask,
                             num_domains=num_domains,
                             **_mup_kw(model, mup_width_mult, mup_base, moment_dtype))


def generators(rng: int, part: int, device, group=None) -> tuple:
    """(device generator, CPU generator) of (micro)batch `part` of the step
    keyed by `rng`: seeds from numpy's SeedSequence of (rng, part). With a
    data-parallel `group`, each is a `distributed.RankRows`: a rank draws
    its rows of the global (micro)batch's dropout masks, diffusion noise and
    action drops, so that the ranks draw what one process draws."""
    a, b = np.random.SeedSequence([int(rng), int(part)]).generate_state(2, np.uint64)
    return (rank_rows(torch.Generator(device).manual_seed(int(a) >> 1), group),
            rank_rows(torch.Generator("cpu").manual_seed(int(b) >> 1), group))


def _loss(model: nn.Module, batch: dict, continuous: bool, action_loss_weight: float,
          generator=None, dropout=None, draws=None, group=None):
    """(loss to differentiate, detached metrics) of one (micro)batch; with
    `group`, this rank's share of the global-batch loss."""
    args = (batch["input_ids"], batch["labels"], batch.get("action_ids"),
            batch.get("domain_id", 0))
    kw = {} if group is None else {"group": group}
    if continuous:
        out = model(*args, batch["masked_tokens_indicator"], generator=generator,
                    dropout=dropout, draws=draws, **kw)
    else:
        out = model(*args, dropout=dropout, generator=generator,
                    action_mask=(draws or {}).get("action_mask"), **kw)
    loss = out["loss"]
    metrics = {"loss": out["loss"].detach(), "acc": out["acc"].detach()}
    if "action_loss" in out:
        loss = loss + action_loss_weight * out["action_loss"]
        metrics["action_loss"] = out["action_loss"].detach()
    return loss, metrics


def _sum_metrics(metrics: dict, group) -> dict:
    """Each rank's metric shares summed over `group` (one all_reduce)."""
    keys = sorted(metrics)
    flat = torch.stack([metrics[k].float() for k in keys])
    all_reduce_sum_([flat], group)
    return dict(zip(keys, flat.unbind()))


def table_owners(model: nn.Module, names: list) -> list:
    """[(name, module, leaf)] of each parameter `names`: the module that
    holds it and its name there, found once."""
    return [(n, model.get_submodule(n.rpartition(".")[0]), n.rpartition(".")[2])
            for n in names]


@contextlib.contextmanager
def domain_rows(owners: list, d: int):
    """Within the block, each stacked table of `owners` (`table_owners`) is a
    one-row leaf: an `nn.Parameter` on a view of row d (no copy), which
    `take_domain` reads as the domain's row. Yields {name: row leaf}; the
    tables come back on exit, with no `.grad`."""
    swapped = []
    try:
        for n, mod, leaf in owners:
            full = mod._parameters[leaf]
            row = nn.Parameter(full.detach()[d:d + 1])
            mod._parameters[leaf] = row
            swapped.append((mod, leaf, full, n, row))
        yield {n: row for _, _, _, n, row in swapped}
    finally:
        for mod, leaf, full, _, _ in swapped:
            mod._parameters[leaf] = full


def make_train_step(model: nn.Module, tx: AdamW, *, microbatch: int = 0,
                    continuous: bool = False, action_loss_weight: float = 0.5,
                    stacked_mask: Optional[dict[str, bool]] = None, group=None
                    ) -> Callable:
    """train_step(batch, rng=0, draws=None) -> metrics, updating the model and
    `tx` in place.

    batch: input_ids/labels (B, T, S) int (discrete) or (B, T, h, w, C)
    fp32 latents and masked_tokens_indicator (B, T, h, w) (continuous),
    optional action_ids (B, T, max_d_action) fp32, domain_id int. With
    microbatch > 0 the batch runs in B // microbatch chunks whose grads (and
    metrics) are averaged. The forward trains (MLP dropout on); its draws
    come from `generators(rng, i)` for chunk i, or, with no microbatches,
    from `draws` where given (STMAR's `draws` or STMaskGIT's "action_mask",
    plus "dropout": one `BlockDropout` per block). Metrics: 0-d tensors loss, acc (and
    action_loss on joint cards), grad_norm and skipped (1.0 when the NaN
    guard dropped the update).

    stacked_mask (`domain_stacked_mask`, with the domain-sliced `tx`): sliced
    gradients, grads for the active domain's row of each stacked table
    only (`domain_rows`). group: the data-parallel process group (see the
    module docstring); batch is then this rank's rows of the global batch.
    On a model sharded by `parallel.mesh.shard_model` FSDP2 has summed the
    gradients over the group; sliced gradients then raise (item 10e), as
    they do on a tp-split model and under sp. Under sp (`model.sp`) the
    backward takes 1 / sp of the loss and the gradients are summed over
    `model.sp_grads` (see the module docstring).
    `noise` (a call's keyword): the low-precision moments' bits, as
    `AdamW.step` takes them.
    """
    params = dict(model.named_parameters())
    device = next(iter(params.values())).device
    sharded = isinstance(next(iter(params.values())), DTensor)
    sp = getattr(model, "sp", None)
    stacked = []
    if stacked_mask is not None and (sharded or sp is not None
                                     or getattr(model, "tp", None) is not None):
        raise NotImplementedError(SLICED_FSDP)
    if stacked_mask is not None:
        if not isinstance(tx, DomainSlicedAdamW):
            raise ValueError("sliced gradients need the domain-sliced optimizer "
                             "(make_domain_sliced_optimizer)")
        if stacked_mask != tx.stacked:
            raise ValueError("stacked_mask differs from the optimizer's stacked tables")
        stacked = table_owners(model, [n for n, s in stacked_mask.items() if s])

    def loss_of(chunk: dict, part: int, rng: int, draws: Optional[dict]):
        gen, dropout = generators(rng, part, device, group)
        draws = dict(draws or {})
        dropout = draws.pop("dropout", dropout)
        loss, metrics = _loss(model, chunk, continuous, action_loss_weight, gen, dropout,
                              draws, group)
        return (loss if sp is None else loss * (1.0 / sp.size)), metrics

    def backward(batch: dict, rng: int, draws: Optional[dict], leaves: dict) -> dict:
        """Grads into `leaves`' .grad (averaged over the chunks); metrics."""
        if microbatch <= 0:
            loss, metrics = loss_of(batch, 0, rng, draws)
            loss.backward()
            return metrics
        if draws:
            raise ValueError("draws are handed in for a whole batch only")
        B = batch["input_ids"].shape[0]
        n = B // microbatch
        metrics = {}
        for i in range(n):
            chunk = {k: (v[i * microbatch:(i + 1) * microbatch]
                         if torch.is_tensor(v) and v.ndim >= 1 and v.shape[0] == B
                         else v) for k, v in batch.items()}
            loss, m = loss_of(chunk, i, rng, None)
            loss.backward()
            metrics = {k: metrics.get(k, 0) + v for k, v in m.items()}
        for p in leaves.values():
            if p.grad is not None:
                p.grad.mul_(1.0 / n)
        return {k: v * (1.0 / n) for k, v in metrics.items()}

    def train_step(batch: dict, rng: int = 0, draws: Optional[dict] = None,
                   noise: Optional[dict] = None) -> dict:
        d = int(batch.get("domain_id", 0))
        for p in params.values():
            p.grad = None
        with domain_rows(stacked, d) as rows:
            # the tensors autograd differentiates: the dense parameters and
            # the stacked tables' rows
            leaves = {**params, **rows}
            metrics = backward(batch, rng, draws, leaves)
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for n, p in leaves.items()}
        if sp is not None:  # one process's gradients (`sequence_parallel`)
            all_reduce_sum_([local(g) for g in grads.values()], model.sp_grads)
        elif group is not None and not sharded:  # FSDP2 has summed sharded ones
            all_reduce_sum_(list(grads.values()), group)
        if group is not None:
            metrics = _sum_metrics(metrics, group)
        ok_loss = torch.isfinite(metrics["loss"])
        with torch.no_grad():  # the bits only where handed in
            g_norm = tx.step(params, grads, d, ok_loss,
                             **({} if noise is None else {"noise": noise}))
        for p in leaves.values():
            p.grad = None
        ok = ok_loss & torch.isfinite(g_norm)
        return {**metrics, "grad_norm": g_norm, "skipped": 1.0 - ok.float()}

    return train_step


def make_eval_step(model: nn.Module, *, continuous: bool = False,
                   action_loss_weight: float = 0.5, group=None) -> Callable:
    """eval_step(batch, rng=0, draws=None) -> {loss, acc, perplexity} (and
    action_loss on joint cards): teacher-forced, deterministic (no dropout),
    no grad; the diffusion draws and the action drop of joint cards come
    from `generators(rng, 0)` (so they differ between eval batches) or
    `draws`. With `group` (data parallelism) the metrics are the global
    batch's, the same on every rank."""
    device = next(model.parameters()).device

    @torch.no_grad()
    def eval_step(batch: dict, rng: int = 0, draws: Optional[dict] = None) -> dict:
        gen = generators(rng, 0, device, group)[0]
        _, metrics = _loss(model, batch, continuous, action_loss_weight, gen, None, draws,
                           group)
        if group is not None:
            metrics = _sum_metrics(metrics, group)
        return {**metrics, "perplexity": torch.exp(metrics["loss"])}

    return eval_step
