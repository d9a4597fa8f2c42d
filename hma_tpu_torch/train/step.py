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
  - the NaN guard: a non-finite loss or grad norm zeroes the grads (the
    moments still decay and the counts still advance, which is why this
    is not `torch.optim.AdamW`) and applies no update;
  - grad accumulation over `microbatch` chunks.

Parameters, moments and grads are fp32 and are updated in place. The
stacked tables' grads arrive full-size from autograd and are read at row
`d`; JAX's `sliced_grads` lever (grads for one row only) is not ported.
muP (`mup_width_mult`) and bf16 moments (`train/lowp.py`) raise.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Union

import torch
from torch import nn

from hma_tpu_torch.models.action_stems import DomainLayerNorm
from hma_tpu_torch.models.attention import LayerNorm

Schedule = Callable[[int], float]


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


def _not_ported(mup_width_mult, moment_dtype) -> None:
    if mup_width_mult not in (None, 1.0):
        raise NotImplementedError("muP (mup_width_mult) is not ported yet "
                                  "(ROADMAP.md Queue A)")
    if moment_dtype not in (None, "float32", torch.float32):
        raise NotImplementedError("low-precision Adam moments (train/lowp.py) "
                                  "are not ported yet (ROADMAP.md Queue A)")


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
    named fp32 parameters, with the train step's NaN guard."""

    def __init__(self, params: dict[str, torch.Tensor],
                 learning_rate: Union[float, Schedule], weight_decay: float,
                 beta1: float, beta2: float, eps: float, max_grad_norm: float,
                 decay: dict[str, bool]):
        self.lr, self.wd = learning_rate, weight_decay
        self.b1, self.b2, self.eps = beta1, beta2, eps
        self.max_grad_norm = max_grad_norm
        self.decay = decay
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}
        self.count = 0  # updates so far: Adam's count and the schedule's

    def step(self, params: dict, grads: dict, domain_id: int,
             ok_loss: torch.Tensor) -> torch.Tensor:
        """Update params in place; returns the grad norm (before the clip)."""
        g_norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in grads.values()]))
        ok = ok_loss & torch.isfinite(g_norm)
        # a skipped step clips zero grads: its norm is 0, its scale 1
        norm = torch.where(ok, g_norm, 0.0)
        scale = torch.where(norm < self.max_grad_norm, 1.0,
                            self.max_grad_norm / torch.clamp(norm, min=1e-20))
        scale = torch.where(ok, scale, 0.0)
        ok_f = ok.float()
        lr = _lr_at(self.lr, self.count)
        self.count += 1
        for n, p in params.items():
            g = torch.where(ok, grads[n], 0.0) * scale
            _adamw_(p.data, g, self.m[n], self.v[n], self.count, lr,
                    self.wd if self.decay[n] else 0.0, self.b1, self.b2,
                    self.eps, ok_f)
        return g_norm

    def state_dict(self) -> dict:
        return {"m": self.m, "v": self.v, "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        for n in self.m:
            self.m[n].copy_(state["m"][n])
            self.v[n].copy_(state["v"][n])
        self.count = int(state["count"])


class DomainSlicedAdamW(AdamW):
    """AdamW that updates only the active domain's row of every
    domain-stacked table (`stacked` names), with per-domain Adam counts;
    the dense (shared) parameters take the plain AdamW update. The global
    count drives the LR schedule and the dense Adam count alike. One clip
    covers the dense grads and the active rows (the full-tree norm: the
    other rows' grads are exactly zero)."""

    def __init__(self, params, learning_rate, weight_decay, beta1, beta2, eps,
                 max_grad_norm, decay, *, stacked: dict[str, bool],
                 num_domains: int):
        super().__init__(params, learning_rate, weight_decay, beta1, beta2, eps,
                         max_grad_norm, decay)
        self.stacked = stacked
        self.domain_count = [0] * num_domains

    def step(self, params: dict, grads: dict, domain_id: int,
             ok_loss: torch.Tensor) -> torch.Tensor:
        d = int(domain_id)
        rows = {n: (g[d] if self.stacked[n] else g) for n, g in grads.items()}
        g_norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in rows.values()]))
        ok = ok_loss & torch.isfinite(g_norm)
        scale = torch.where(g_norm < self.max_grad_norm, 1.0,
                            self.max_grad_norm / torch.clamp(g_norm, min=1e-20))
        ok_f = ok.float()
        lr = _lr_at(self.lr, self.count)
        self.count += 1
        self.domain_count[d] += 1
        for n, p in params.items():
            g = torch.where(ok, rows[n] * scale, 0.0)
            wd = self.wd if self.decay[n] else 0.0
            if self.stacked[n]:
                _adamw_(p.data[d], g, self.m[n][d], self.v[n][d],
                        self.domain_count[d], lr, wd, self.b1, self.b2, self.eps,
                        ok_f)
            else:
                _adamw_(p.data, g, self.m[n], self.v[n], self.count, lr, wd,
                        self.b1, self.b2, self.eps, ok_f)
        return g_norm

    def state_dict(self) -> dict:
        return {**super().state_dict(), "domain_count": list(self.domain_count)}

    def load_state_dict(self, state: dict) -> None:
        super().load_state_dict(state)
        self.domain_count = [int(c) for c in state["domain_count"]]


def make_optimizer(model: nn.Module, learning_rate, weight_decay: float = 0.01,
                   beta1: float = 0.9, beta2: float = 0.999, eps: float = 1e-8,
                   max_grad_norm: float = 1.0,
                   mup_width_mult: Optional[float] = None,
                   moment_dtype=None) -> AdamW:
    """Global-norm clip, then AdamW with the weight-decay mask."""
    _not_ported(mup_width_mult, moment_dtype)
    return AdamW(dict(model.named_parameters()), learning_rate, weight_decay,
                 beta1, beta2, eps, max_grad_norm, weight_decay_mask(model))


def make_domain_sliced_optimizer(model: nn.Module, learning_rate,
                                 weight_decay: float = 0.01, beta1: float = 0.9,
                                 beta2: float = 0.999, eps: float = 1e-8,
                                 max_grad_norm: float = 1.0, *,
                                 stacked_mask: dict[str, bool], num_domains: int,
                                 mup_width_mult: Optional[float] = None,
                                 moment_dtype=None) -> DomainSlicedAdamW:
    """The domain-sliced AdamW; `stacked_mask` from `domain_stacked_mask`."""
    _not_ported(mup_width_mult, moment_dtype)
    return DomainSlicedAdamW(dict(model.named_parameters()), learning_rate,
                             weight_decay, beta1, beta2, eps, max_grad_norm,
                             weight_decay_mask(model), stacked=stacked_mask,
                             num_domains=num_domains)


def _loss(model: nn.Module, batch: dict):
    out = model(batch["input_ids"], batch["labels"], batch.get("action_ids"),
                batch.get("domain_id", 0))
    return out["loss"], {"loss": out["loss"].detach(), "acc": out["acc"].detach()}


def make_train_step(model: nn.Module, tx: AdamW, *, microbatch: int = 0) -> Callable:
    """train_step(batch) -> metrics, updating the model and `tx` in place.

    batch: input_ids/labels (B, T, S) int, optional action_ids (B, T,
    max_d_action) fp32, domain_id int. With microbatch > 0 the batch runs
    in B // microbatch chunks whose grads (and metrics) are averaged.
    Metrics: 0-d tensors loss, acc, grad_norm and skipped (1.0 when the
    NaN guard dropped the update).
    """
    params = dict(model.named_parameters())

    def train_step(batch: dict) -> dict:
        for p in params.values():
            p.grad = None
        if microbatch <= 0:
            loss, metrics = _loss(model, batch)
            loss.backward()
        else:
            B = batch["input_ids"].shape[0]
            n = B // microbatch
            metrics = {}
            for i in range(n):
                chunk = {k: (v[i * microbatch:(i + 1) * microbatch]
                             if torch.is_tensor(v) and v.ndim >= 1 and v.shape[0] == B
                             else v) for k, v in batch.items()}
                loss, m = _loss(model, chunk)
                loss.backward()
                metrics = {k: metrics.get(k, 0) + v for k, v in m.items()}
            for p in params.values():
                if p.grad is not None:
                    p.grad.mul_(1.0 / n)
            metrics = {k: v * (1.0 / n) for k, v in metrics.items()}
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for n, p in params.items()}
        ok_loss = torch.isfinite(metrics["loss"])
        with torch.no_grad():
            g_norm = tx.step(params, grads, batch.get("domain_id", 0), ok_loss)
        for p in params.values():
            p.grad = None
        ok = ok_loss & torch.isfinite(g_norm)
        return {**metrics, "grad_norm": g_norm, "skipped": 1.0 - ok.float()}

    return train_step


def make_eval_step(model: nn.Module) -> Callable:
    """eval_step(batch) -> {loss, acc, perplexity}, teacher-forced, no grad."""

    @torch.no_grad()
    def eval_step(batch: dict) -> dict:
        _, metrics = _loss(model, batch)
        return {**metrics, "perplexity": torch.exp(metrics["loss"])}

    return eval_step
