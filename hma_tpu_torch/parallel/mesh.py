"""Device mesh (counterpart of hma_tpu/parallel/mesh.py), on torch's
`DeviceMesh` with `hma_tpu`'s axes ("dp", "fsdp", "tp", "sp"), one process
a card.

Only the data-parallel axis is ported: parameters and optimizer state are
replicated, each rank runs the kernels on its share of the batch (its
`distributed.local_slice`, the counterpart of `batch_sharding`), and the
train step sums the gradients over the "dp" group. fsdp (FSDP2, with
`param_spec`) is ROADMAP.md Queue A item 10b, tp and sp item 10c; asking
for them raises. Where `hma_tpu` builds a mesh over a subset of the devices
when the factors ask for fewer, the port raises: the factors must fill the
world exactly.
"""

from __future__ import annotations

from typing import Optional

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from hma_tpu_torch.parallel import distributed

AXES = ("dp", "fsdp", "tp", "sp")
UNPORTED = ("not ported yet: fsdp is ROADMAP.md Queue A item 10b, tp and sp "
            "item 10c")


def check_factors(dp: Optional[int] = None, fsdp: int = 1, tp: int = 1,
                  sp: int = 1, world: Optional[int] = None) -> int:
    """The dp degree of (dp, fsdp, tp, sp) over `world` ranks (default: the
    process group's): dp defaults to the world. Raises for fsdp, tp or sp
    above 1 and for factors that ask for more or fewer ranks than there
    are."""
    if max(fsdp, tp, sp) > 1:
        raise NotImplementedError(f"--fsdp {fsdp} --tp {tp} --sp {sp}: {UNPORTED}")
    world = distributed.process_count() if world is None else world
    dp = world if dp is None else dp
    if dp * fsdp * tp * sp != world:
        raise ValueError(f"mesh (dp {dp}, fsdp {fsdp}, tp {tp}, sp {sp}) needs "
                         f"{dp * fsdp * tp * sp} processes; the world has {world}: "
                         "launch one process a card with torchrun")
    return dp


def make_mesh(dp: Optional[int] = None, fsdp: int = 1, tp: int = 1,
              sp: int = 1) -> DeviceMesh:
    """A (dp, fsdp, tp, sp) DeviceMesh over every rank of the process group.
    Raises without a process group."""
    dp = check_factors(dp, fsdp, tp, sp)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "init_distributed (or launch with torchrun) first")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (dp, fsdp, tp, sp), mesh_dim_names=AXES)


def default_mesh_factors(n: int) -> tuple[int, int, int, int]:
    """`hma_tpu`'s (dp, fsdp, tp, sp) factorisation of n devices (sp 2 from
    8, then tp 2 from 4, then fsdp 2 from 2); above one device it asks for
    axes that are not ported, so `make_mesh` refuses it."""
    sp = 2 if n % 8 == 0 and n >= 8 else 1
    rem = n // sp
    tp = 2 if rem % 2 == 0 and rem >= 4 else 1
    rem //= tp
    fsdp = 2 if rem % 2 == 0 and rem >= 2 else 1
    dp = rem // fsdp
    return dp, fsdp, tp, sp
