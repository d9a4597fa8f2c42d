"""Sequence parallelism over the mesh's "sp" axis, the port's own: `hma_tpu`
shards the integer (B, T, S) token batch's trailing axis over "sp"
(`batch_sharding`) and lets XLA partition the kernels (the spatial kernel
keeps its tokens whole and splits (batch, head); the temporal kernels split
their sites); here the model's trunk runs on this rank's contiguous chunk of
the S_tot tokens of every frame and calls the collectives below.

Where the split lives. The ranks of an sp group load the same rows and draw
the same masks and noise (`distributed.data_index` counts sp as model-
parallel), and the model embeds the whole frame, appends its action or mask
tokens and adds `pos_embed_TSC` as one process does. `STTransformerDecoder`
then keeps the rank's tokens (`split_tokens`), runs its blocks on them and
joins the ranks' outputs (`gather_tokens`), so the readout, the loss, the
action pooling and the diffusion head (K6') see whole frames. Inside a
block:
  - spatial attention: q, k, v (after the qk-norm) of the rank's tokens and
    all of its heads go through `tokens_to_heads`, an all-to-all, to every
    token of H / sp of the heads; K1' (K2' in the backward) runs on that as
    it runs on a whole frame in one process, and `heads_to_tokens` sends the
    output back before `proj`;
  - temporal attention, the MLP and the action injections are per token:
    K3'/K4' take the rank's B * S_tot / sp sites, K5' its (B, T, S_tot / sp)
    block, and the KV caches hold its sites.
A token count that sp does not divide raises, as does a head count (after
tp's split) that it does not divide.

Gradients, one convention: each rank's loss counts 1 / sp (the train step
scales it), and everything after `gather_tokens` is the same on every rank
of the group (the same rows, draws and whole frames), so the gradient
reaching the gather is the same on each: its backward keeps this rank's
tokens times sp, with no collective. `split_tokens`' backward is the
slice's (zeros outside the rank's tokens), and after the backward the step
sums every parameter's gradient over the group `enable` sets once. A
parameter used only after the gather (the readout, the diffusion head)
then gets sp times 1 / sp of the whole gradient; one used before the split
or inside the trunk (the embeddings, the blocks) gets its tokens' part from
each rank. Either way the sum is one process's gradient, and the clip's
norm is taken after it. Where FSDP2 does not shard the model the sum runs
once over the data and sp ranks together (`mesh.grad_group`); under FSDP2
it runs over sp on each rank's shards, after FSDP2's reduce-scatter over
"fsdp" (the ranks of an sp group hold the same shards).

The group is `tensor_parallel.Group`, and the gather and split are
`tensor_parallel`'s all-gather and rank slice. The exchange is c10d's
all_to_all_single, written once for every backend: bf16 moves as bytes (a
copy needs no arithmetic, and gloo has no 16-bit type).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from hma_tpu_torch.parallel.tensor_parallel import Group, all_gather, rank_slice


def local_count(n: int, sp: Optional[Group]) -> int:
    """The tokens of `n` that one rank holds: n / sp. Raises where sp does
    not divide n."""
    if sp is None:
        return n
    if n % sp.size:
        raise NotImplementedError(
            f"sp {sp.size} does not divide the {n} tokens of a frame (image and action "
            "tokens): choose an sp that divides them")
    return n // sp.size


def split_tokens(x: torch.Tensor, sp: Optional[Group], dim: int) -> torch.Tensor:
    """This rank's contiguous tokens of x along `dim`; the gradient is the
    slice's own (zeros outside them)."""
    if sp is None:
        return x
    local_count(x.shape[dim], sp)
    return rank_slice(x, sp, dim)


class _GatherTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sp, dim):
        ctx.sp, ctx.dim = sp, dim
        return all_gather(x, sp, dim)

    @staticmethod
    def backward(ctx, g):
        return rank_slice(g, ctx.sp, ctx.dim) * ctx.sp.size, None, None


def gather_tokens(x: torch.Tensor, sp: Optional[Group], dim: int) -> torch.Tensor:
    """The ranks' tokens joined along `dim`, in rank order; the gradient
    (the same on every rank) sliced to this rank's tokens, times sp."""
    return x if sp is None else _GatherTokens.apply(x, sp, dim % x.ndim)


def _exchange(x: torch.Tensor, sp: Group, split: int, cat: int) -> torch.Tensor:
    """All-to-all: x cut into sp chunks along `split`, chunk j sent to rank
    j; the chunks received joined along `cat` in rank order."""
    send = torch.stack(x.chunk(sp.size, split))
    raw = send.view(torch.uint8) if send.dtype == torch.bfloat16 else send
    recv = torch.empty_like(raw)
    dist.all_to_all_single(recv, raw, group=sp.group)
    recv = recv.view(x.dtype) if x.dtype == torch.bfloat16 else recv
    return torch.cat(recv.unbind(0), cat)


class _Exchange(torch.autograd.Function):
    """`_exchange` forward; the backward exchanges the other way."""

    @staticmethod
    def forward(ctx, x, sp, split, cat):
        ctx.sp, ctx.split, ctx.cat = sp, split, cat
        return _exchange(x, sp, split, cat)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.sp, ctx.cat, ctx.split), None, None, None


def tokens_to_heads(x: torch.Tensor, sp: Optional[Group]) -> torch.Tensor:
    """(N, S_tot / sp, G, H, D), this rank's tokens of all H heads, ->
    (N, S_tot, G, H / sp, D), every token of its heads [r H / sp, (r+1) H /
    sp); the gradient goes back the other way."""
    return x if sp is None else _Exchange.apply(x, sp, 3, 1)


def heads_to_tokens(x: torch.Tensor, sp: Optional[Group]) -> torch.Tensor:
    """The inverse of `tokens_to_heads`: (N, S_tot, G, H / sp, D) ->
    (N, S_tot / sp, G, H, D)."""
    return x if sp is None else _Exchange.apply(x, sp, 1, 3)


def enable(model: nn.Module, sp: Optional[Group], grads=None) -> nn.Module:
    """Run `model`'s trunk on this rank's tokens (see the module docstring):
    each module with an `enable_sp` takes the group, and `model.sp` is set.
    `model.sp_grads` is the process group the train step sums the gradients
    over: `grads` (`mesh.shard_model` gives the data and sp ranks together
    where FSDP2 does not shard the model), else sp's own. The parameters
    stay whole. Returns `model`; with no group (or one rank), as it is."""
    if sp is None:
        return model
    for mod in model.modules():
        if hasattr(mod, "enable_sp") and mod is not model:
            mod.enable_sp(sp)
    model.sp, model.sp_grads = sp, sp.group if grads is None else grads
    return model
