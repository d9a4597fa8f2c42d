"""Tensor parallelism over the mesh's "tp" axis (Megatron's column / row
split), the port's own: `hma_tpu` annotates its parameters' shardings
(`param_spec`) and XLA inserts the collectives; here the model holds each
rank's part of every split parameter as a plain local tensor and its
modules call the collectives below, so the kernels take local contiguous
tensors as they do in one process.

`split_model(model, tp)` splits the whole weights of a model in place, by
`mesh.tp_dim` (hma_tpu's rule: `qkv`, `fc1`, `to_q/k/v`, `ada_fc1`,
`ada_fc2` split their output features, `proj`, `fc2`, `linear_out`,
`out_x_proj`, `out` their input features, embedding tables their feature
dimension; whatever the rule leaves, or tp does not divide, stays whole).
Inside the split dimension the columns are dealt so that a rank's part is
whole heads or features (`part_index`): `qkv`'s (3, H, D) output gives rank
r q, k and v of heads [r H / tp, (r+1) H / tp), kept in (3, H / tp, D)
order, and `ada_fc2`'s [shift | scale] gives rank r shift and scale of its
features. The bytes a rank holds and the split dimension are
`param_spec`'s; only the order of the columns changes. `model.tp_parts`
records each split parameter's (dim, chunks, whole shape), from which
`take` cuts a rank's part of a whole tensor (a checkpoint's, the Adam
moments' random bits) and `gather_whole` puts the parts back.

The compute: a column-split layer reads its replicated input through `copy`
(identity forward, all-reduce backward), a row-split layer sums its partial
products with `reduce` (all-reduce forward, identity backward) and adds its
bias once, after the sum; `gather` (all-gather forward, slice backward)
joins features where a whole row is needed (the factored embedding, a
LayerNorm between two split layers) and `scatter` (slice forward,
all-gather backward) takes a rank's features of a replicated activation.
A replicated parameter used on a rank's heads or features alone (the qk
LayerNorms, a column-split layer's bias) goes through `copy` too, so its
gradient is whole and equal on every rank. The diffusion head's split
layers are gathered whole at use (`Dense` mode "whole"): K6' reads whole
weights and every rank of a tp group computes the same head.

The collectives are c10d's all_reduce and all_gather_into_tensor (sums in
fp32), the ones FSDP2 and the data-parallel step run over gloo and NCCL.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
import torch.distributed as dist
from torch import nn

# the output layouts that are dealt by chunk: qkv (3, H, D), ada_fc2
# [shift | scale]
CHUNKS = {"qkv": 3, "ada_fc2": 2}


class Group(NamedTuple):
    """A tensor- or sequence-parallel group: its process group, this rank's
    index in it and its size."""
    group: Any
    rank: int
    size: int


def group_of(group) -> Optional[Group]:
    """The `Group` of a process group; None without one or with one rank."""
    if group is None or dist.get_world_size(group) == 1:
        return None
    return Group(group, dist.get_rank(group), dist.get_world_size(group))


def _all_reduce(x: torch.Tensor, tp: Group) -> torch.Tensor:
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device).copy_(x)
    dist.all_reduce(y, group=tp.group)
    return y.to(x.dtype)


def all_gather(x: torch.Tensor, tp: Group, dim: int) -> torch.Tensor:
    """The ranks' x joined along `dim`, in rank order (bf16 moves as bytes:
    a copy needs no arithmetic, and gloo has no 16-bit integers)."""
    x = x.contiguous()
    raw = x.view(torch.uint8) if x.dtype == torch.bfloat16 else x
    out = raw.new_empty((tp.size * raw.shape[0], *raw.shape[1:]))
    dist.all_gather_into_tensor(out, raw, group=tp.group)
    out = out.view(x.dtype) if x.dtype == torch.bfloat16 else out
    return torch.cat(out.view(tp.size, *x.shape).unbind(0), dim)


def rank_slice(x: torch.Tensor, tp: Group, dim: int) -> torch.Tensor:
    """This rank's contiguous 1 / tp.size of x along `dim` (a view)."""
    n = x.shape[dim] // tp.size
    return x.narrow(dim, tp.rank * n, n)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.tp), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return _all_reduce(x, tp)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return all_gather(x, tp, dim)

    @staticmethod
    def backward(ctx, g):
        return rank_slice(g, ctx.tp, ctx.dim).contiguous(), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return rank_slice(x, tp, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.tp, ctx.dim), None, None


def copy(x: torch.Tensor, tp: Optional[Group]) -> torch.Tensor:
    """x as it is; its gradient summed over the group."""
    return x if tp is None else _Copy.apply(x, tp)


def reduce(x: torch.Tensor, tp: Optional[Group]) -> torch.Tensor:
    """x summed over the group (in fp32); the gradient as it is."""
    return x if tp is None else _Reduce.apply(x, tp)


def gather(x: torch.Tensor, tp: Optional[Group], dim: int = -1) -> torch.Tensor:
    """The ranks' x joined along `dim`; the gradient's slice of this rank."""
    return x if tp is None else _Gather.apply(x, tp, dim % x.ndim)


def scatter(x: torch.Tensor, tp: Optional[Group], dim: int = -1) -> torch.Tensor:
    """This rank's contiguous slice of x along `dim`; the gradient joined."""
    return x if tp is None else _Scatter.apply(x, tp, dim % x.ndim)


# ---------------------------------------------------------------------------
# placements

def part_index(size: int, chunks: int, rank: int, world: int,
               device=None) -> torch.Tensor:
    """The indices of rank `rank`'s part of a dimension of `size` split over
    `world` ranks, dealt by `chunks` equal chunks: the rank's contiguous
    slice of each chunk, chunk after chunk."""
    n = size // chunks
    w = n // world
    return (torch.arange(chunks, device=device)[:, None] * n + rank * w
            + torch.arange(w, device=device)[None, :]).reshape(-1)


class Part(NamedTuple):
    """A split parameter: the dimension, the chunks it is dealt by and the
    whole shape."""
    dim: int
    chunks: int
    shape: tuple


def take(whole: torch.Tensor, part: Part, rank: int, world: int) -> torch.Tensor:
    """Rank `rank`'s part of `whole` (a tensor of the parameter's whole
    shape)."""
    idx = part_index(whole.shape[part.dim], part.chunks, rank, world, whole.device)
    return whole.index_select(part.dim, idx).contiguous()


def gather_whole(local: torch.Tensor, part: Part, tp: Group) -> torch.Tensor:
    """The whole tensor from every rank's part (a collective over the
    group), in the parameter's own column order."""
    joined = all_gather(local, tp, part.dim)
    idx = torch.cat([part_index(joined.shape[part.dim], part.chunks, r, tp.size,
                                joined.device) for r in range(tp.size)])
    whole = torch.empty_like(joined)
    whole.index_copy_(part.dim, idx, joined)
    return whole


def _jax_leaf(mod: nn.Module, leaf: str, p: torch.Tensor) -> tuple[str, tuple]:
    """(hma_tpu's leaf name, its shape) of parameter `leaf` of `mod`."""
    if isinstance(mod, nn.Embedding):
        return "embedding", tuple(p.shape)
    if isinstance(mod, nn.Linear) and leaf == "weight":
        return "kernel", tuple(p.shape)[::-1]
    return leaf, tuple(p.shape)


def split_params(model: nn.Module, tp: Group) -> dict:
    """{name: Part} of the parameters `mesh.tp_dim` splits at tp.size, each
    replaced in place by this rank's part (dealt by `part_index`). The
    module names are `hma_tpu`'s (the converter maps them one to one)."""
    from hma_tpu_torch.parallel.mesh import tp_dim

    parts = {}
    for mod_name, mod in model.named_modules():
        parent = mod_name.rpartition(".")[2]
        for leaf, p in list(mod.named_parameters(recurse=False)):
            jax_leaf, jax_shape = _jax_leaf(mod, leaf, p)
            dim = tp_dim(parent, jax_leaf, jax_shape, tp.size)
            if dim is None:
                continue
            if jax_leaf == "kernel" and isinstance(mod, nn.Linear):
                dim = p.ndim - 1 - dim
            else:
                dim %= p.ndim
            part = Part(dim, CHUNKS.get(parent, 1), tuple(p.shape))
            local = take(p.detach(), part, tp.rank, tp.size)
            mod._parameters[leaf] = nn.Parameter(local, requires_grad=p.requires_grad)
            parts[f"{mod_name}.{leaf}" if mod_name else leaf] = part
    return parts


def split_model(model: nn.Module, tp: Optional[Group]) -> nn.Module:
    """Split `model`'s whole weights over the tp group, in place (see the
    module docstring), and set each module's tp mode. Returns `model`,
    with `model.tp` (the group) and `model.tp_parts` ({name: Part}); with
    no group (or one rank), `model` as it is. Raises where a module's
    layers split unevenly (one split, its partner whole) or its heads do
    not divide over the group."""
    if tp is None:
        return model
    from hma_tpu_torch.models.action_stems import DomainDense
    from hma_tpu_torch.models.attention import Dense
    from hma_tpu_torch.models.diffloss import DiffLoss

    parts = split_params(model, tp)
    heads = {id(m) for d in model.modules() if isinstance(d, DiffLoss) for m in d.modules()}
    for name, mod in model.named_modules():
        if not isinstance(mod, (Dense, DomainDense)):
            continue
        leaf = "weight" if isinstance(mod, Dense) else "kernel"
        part = parts.get(f"{name}.{leaf}")
        if part is None:
            continue
        w = getattr(mod, leaf)
        col = part.dim == (0 if isinstance(mod, Dense) else w.ndim - 1)
        mode = "whole" if id(mod) in heads else ("col" if col else "row")
        mod.tp, mod.tp_mode, mod.tp_part = tp, mode, part
        if mode == "col":  # the whole bias's columns this rank adds
            mod.tp_index = part_index(part.shape[part.dim], part.chunks, tp.rank, tp.size,
                                      w.device)
    for mod in model.modules():
        if hasattr(mod, "enable_tp") and mod is not model:
            mod.enable_tp(tp)
    model.tp = tp
    model.tp_parts = parts
    return model


def split_mode(*layers) -> bool:
    """True when every layer of a module's pair (or group) is split, False
    when none is; raises when they split unevenly."""
    modes = [layer.tp_mode is not None for layer in layers]
    if any(modes) and not all(modes):
        raise NotImplementedError(
            "tp splits one layer of a module and leaves its partner whole (the "
            "group does not divide every width alike): choose a tp that divides "
            "d_model, the MLP's hidden width and the heads")
    return all(modes)
