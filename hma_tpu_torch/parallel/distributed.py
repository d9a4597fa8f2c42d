"""Multi-process runtime (counterpart of hma_tpu/parallel/distributed.py).

One process drives one card, the torch idiom: `init_distributed` joins the
process group (NCCL on `cuda:LOCAL_RANK`, gloo when the caller asks for the
CPU), every process runs the same seeded sampler and loads its contiguous
share of each global batch (`local_slice`) and its rows of the batch's
random draws (`rank_rows`, `draw_rows`), and the train and eval steps sum
their gradients, loss denominators and metrics over the group. The group
is the mesh's data axes ("dp" and "fsdp" flattened, `mesh.data_group`),
and a process's share goes by its data index, not its process index: the
ranks of one tp or sp group (`mesh.use_mesh` registers tp * sp as the model-
parallel factor) load the same rows and draw the same masks, dropout,
diffusion noise and rollout samples, so their replicated activations stay
equal. With tp and sp at 1 the data index is the process index.
`hma_tpu` has one process a host driving every local device; its helpers'
names and arithmetic are kept. With no launcher environment everything is
the single-process identity.
"""

from __future__ import annotations

import os
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from hma_tpu_torch import resolve_device

BUCKET_ELEMS = 1 << 25  # fp32 elements summed by one all_reduce of `all_reduce_sum_`
AUTO = ("HMA_TPU_COORDINATOR=auto asks for TPU pod metadata discovery, which "
        "has no counterpart on GPUs: give the coordinator as host:port (or "
        "launch with torchrun)")


# the ranks that share one data index (tp * sp of the registered mesh) and
# the process group of the data axes (`set_data_axes`): a process has one
# mesh, as it has one default process group, and the data helpers below
# read it where they read the process group's rank and size
_DATA_AXES = {"model_parallel": 1, "group": None}


def set_data_axes(group, model_parallel: int) -> None:
    """Register the mesh's data group and its model-parallel factor (tp *
    sp): the mesh's rank order is (dp, fsdp, tp, sp) row-major, so a
    process's data index is its rank // model_parallel."""
    _DATA_AXES.update(group=group, model_parallel=int(model_parallel))


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     local_device_ids: Optional[str] = None,
                     device=None) -> bool:
    """Join the process group; True when this process is one of a group.

    The arguments fall back to `hma_tpu`'s HMA_TPU_COORDINATOR /
    HMA_TPU_NUM_PROCESSES / HMA_TPU_PROCESS_ID / HMA_TPU_LOCAL_DEVICE_IDS,
    then to torchrun's MASTER_ADDR:MASTER_PORT / WORLD_SIZE / RANK /
    LOCAL_RANK. As in `hma_tpu`, HMA_TPU_* with one process is a no-op; a
    torchrun launch makes a group whatever its size. The backend is NCCL on
    `cuda:<local rank>` (the local rank: LOCAL_RANK, else the first of the
    local device ids, else 0), or gloo when `device` is the CPU. A group
    already joined is kept. Raises for "auto", for a world above one
    process without a coordinator or rank, and when the backend fails to
    start: nothing carries on in one process."""
    env = os.environ
    torchrun = "RANK" in env and "WORLD_SIZE" in env
    coordinator_address = coordinator_address or env.get("HMA_TPU_COORDINATOR")
    if coordinator_address == "auto":
        raise NotImplementedError(AUTO)
    if coordinator_address is None and env.get("MASTER_ADDR"):
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num_processes is None:
        num_processes = _env_int("HMA_TPU_NUM_PROCESSES", "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("HMA_TPU_PROCESS_ID", "RANK")
    local_device_ids = local_device_ids or env.get("HMA_TPU_LOCAL_DEVICE_IDS")
    if dist.is_initialized():
        return True
    if (num_processes or 1) <= 1 and not torchrun:
        return False
    if coordinator_address is None or process_id is None:
        raise ValueError(f"{num_processes} processes need a coordinator address "
                         f"and a process id (got {coordinator_address!r}, "
                         f"{process_id!r})")
    local = _env_int("LOCAL_RANK")
    if local is None:
        local = int(local_device_ids.split(",")[0]) if local_device_ids else 0
    kw = {}
    if device is not None and torch.device(device).type == "cpu":
        backend = "gloo"
    else:
        backend = "nccl"
        resolve_device(device)  # raises without a card
        torch.cuda.set_device(local)
        kw["device_id"] = torch.device("cuda", local)  # eager: a failed init raises here
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id, **kw)
    return True


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _model_parallel() -> int:
    return _DATA_AXES["model_parallel"] if dist.is_initialized() else 1


def data_index() -> int:
    """This process's index on the mesh's data axes (dp * fsdp)."""
    return process_index() // _model_parallel()


def data_count() -> int:
    """The data degree, dp * fsdp: the processes over which a global batch's
    rows are split."""
    return process_count() // _model_parallel()


def data_group():
    """The process group of the data axes, or None with one data index."""
    if data_count() == 1:
        return None
    return _DATA_AXES["group"] or dist.group.WORLD


def is_primary() -> bool:
    """True on the process that owns logging and checkpoint writes."""
    return process_index() == 0


def local_device(device=None) -> torch.device:
    """The device this process computes on: `device` as given, else the card
    that `init_distributed` bound (cuda:<local rank>) in a group, else
    `resolve_device`'s."""
    if device is None and dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return resolve_device(device)


def local_slice(global_indices: np.ndarray) -> np.ndarray:
    """This process's contiguous share of a global batch's indices: all
    processes run the same seeded sampler, and each loads 1 / data_count
    of every batch, by its data index (the ranks of a tp or sp group the same)."""
    n = data_count()
    if n == 1:
        return global_indices
    per = len(global_indices) // n
    r = data_index()
    return global_indices[r * per:(r + 1) * per]


def make_global_batch(local_batch: dict, device) -> dict:
    """This process's shard of a global batch, kept on its own device: numpy
    arrays and tensors become tensors there; scalars (domain_id), the same
    on every process by the sampler's seed, pass through."""
    def leaf(v):
        if isinstance(v, np.ndarray) or torch.is_tensor(v):
            return torch.as_tensor(v).to(device)
        return v

    return {k: leaf(v) for k, v in local_batch.items()}


class RankRows(NamedTuple):
    """The random source of one rank's rows of a global batch: a per-row
    draw (`draw_rows`) is made at the global batch's shape, the ranks'
    equal shards in rank order, and the rank keeps its own rows, so that
    `world` ranks draw what one process draws for the whole batch, as
    `hma_tpu`'s dp mesh draws at the global shape. `source` is a
    torch.Generator, or the int seed of one (a dropout block's); a draw
    that is not per row takes it as it is (`source`)."""
    source: Any
    rank: int
    world: int


def rank_rows(generator, group=None):
    """`generator` as the source of this rank's rows of `group`'s global
    batch (a `RankRows`); without a group (or a generator), as it is."""
    if group is None or generator is None:
        return generator
    return RankRows(generator, dist.get_rank(group), dist.get_world_size(group))


def source(generator):
    """The generator or seed behind a `RankRows`; anything else as it is."""
    return generator.source if isinstance(generator, RankRows) else generator


def draw_rows(draw: Callable[[int, Any], torch.Tensor], n: int, generator,
              blocks: int = 1) -> torch.Tensor:
    """n rows of a per-row draw; draw(m, g) gives m rows drawn from g.

    With a plain generator, draw(n, generator). With a `RankRows`, this
    rank's rows of the draw at the global shape: the n rows are `blocks`
    equal contiguous blocks (tiled copies of the batch's rows, or a [cond |
    uncond] pair), each holding the ranks' shards in rank order."""
    if not isinstance(generator, RankRows):
        return draw(n, generator)
    k = n // blocks
    full = draw(blocks * generator.world * k, generator.source)
    rest = full.shape[1:]
    return full.reshape(blocks, generator.world, k, *rest)[:, generator.rank].reshape(n, *rest)


def _collective_device(group=None) -> torch.device:
    """Where a host value goes for a collective: the card under NCCL, the
    CPU under gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def global_count(n: torch.Tensor, group=None) -> torch.Tensor:
    """A loss denominator summed over the ranks of `group` (none: `n`), so
    that each rank's sum over it is its share of the global-batch mean,
    as `hma_tpu`'s step divides by counts taken over the whole batch. The
    count carries no gradient."""
    if group is None:
        return n
    n = n.detach().clone()
    dist.all_reduce(n, group=group)
    return n


def all_reduce_sum_(tensors: list, group) -> None:
    """Sum each tensor over the ranks of `group`, in place, in buckets of
    about BUCKET_ELEMS fp32 elements (one all_reduce a bucket)."""
    i = 0
    while i < len(tensors):
        j, n = i, 0
        while j < len(tensors) and (j == i or n + tensors[j].numel() <= BUCKET_ELEMS):
            n += tensors[j].numel()
            j += 1
        chunk = tensors[i:j]
        flat = torch.cat([t.reshape(-1).float() for t in chunk])
        dist.all_reduce(flat, group=group)
        for t, part in zip(chunk, flat.split([t.numel() for t in chunk])):
            t.copy_(part.view_as(t))
        i = j


def broadcast_(tensors: list, src: int = 0, group=None) -> None:
    """Every tensor set to rank `src`'s, in place."""
    for t in tensors:
        dist.broadcast(t, src=src, group=group)


def gather_rows(x: np.ndarray) -> np.ndarray:
    """Every data index's rows of equal-size shards, concatenated in data
    order (each row once, whatever tp and sp are); with one data index, `x`."""
    if data_count() == 1:
        return x
    group = data_group()
    dev = _collective_device(group)
    local = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    parts = [torch.empty_like(local) for _ in range(data_count())]
    dist.all_gather(parts, local, group=group)
    return torch.cat(parts).cpu().numpy()


def aggregate_host_metrics(metrics: dict) -> dict:
    """The mean of host-local scalar metrics over the data indices (an
    all_gather of fp32 values, as `hma_tpu`'s process_allgather); a copy
    with one."""
    if data_count() == 1:
        return dict(metrics)
    keys = sorted(metrics)
    gathered = gather_rows(np.asarray([[float(metrics[k]) for k in keys]], np.float32))
    return {k: float(v) for k, v in zip(keys, gathered.mean(0))}
