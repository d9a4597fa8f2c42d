"""Sharded evaluation helpers (counterpart of
hma_tpu/parallel/sharded_eval.py), one process a card.

`hma_tpu` shards each global batch over a (dp, fsdp, tp, sp) mesh of every
device and reduces the metrics inside jit. Here each process evaluates its
contiguous rows of every global batch (`distributed.local_slice`, by its
data index) on its own device (`distributed.make_global_batch`, the
counterpart of `put_batch`), so a global batch must be a multiple of the
data degree, dp * fsdp, the world size over tp; its random draws are its
rows of the global batch's (`distributed.rank_rows` over the data group),
and the CLIs average the per-batch metrics over the data indices. With
`--tp` above 1 the model's heads and MLP features are split over the tp
ranks (`tensor_parallel.split_model`), which share their rows and draws;
with `--sp` above 1 its trunk runs on the sp ranks' tokens of every frame,
which share their rows and draws too (`sequence_parallel`); with `--fsdp`
above 1 its parameters are sharded by FSDP2 by the training rules
(`shard_params`, `mesh.shard_model`) and gathered a block at a time as the
model runs.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from hma_tpu_torch.parallel import distributed
from hma_tpu_torch.parallel.mesh import check_factors, make_mesh, shard_model


def setup_eval_mesh(fsdp: int = 1, tp: int = 1, sp: int = 1, device=None
                    ) -> tuple[torch.device, Optional[DeviceMesh]]:
    """(this process's evaluation device, its card unless `device` says
    otherwise; the (dp, fsdp, tp, sp) mesh over every process, None in one
    process). dp is world // (fsdp * tp * sp). Raises for an fsdp, tp or sp
    the world cannot fill (above 1 in one process among them)."""
    check_factors(None, fsdp, tp, sp)
    device = distributed.local_device(device)
    mesh = make_mesh(fsdp=fsdp, tp=tp, sp=sp) if distributed.process_count() > 1 else None
    return device, mesh


def shard_params(model: nn.Module, mesh: Optional[DeviceMesh]) -> nn.Module:
    """`model` split over the mesh's "tp" axis, its trunk on the "sp"
    ranks' tokens and sharded over its "fsdp" axis (`mesh.shard_model`), as
    training places it; as it is without a mesh or with fsdp, tp and sp at
    1."""
    if mesh is None or mesh["fsdp"].size() * mesh["tp"].size() * mesh["sp"].size() == 1:
        return model
    return shard_model(model, mesh)


def data_degree() -> int:
    """A global batch must be a multiple of this: dp * fsdp, the processes
    over which its rows split (one a card, the factors filling the world)."""
    return distributed.data_count()


def round_batch(n: int) -> int:
    """Largest multiple of the data degree <= n (0 if none)."""
    d = data_degree()
    return (n // d) * d
