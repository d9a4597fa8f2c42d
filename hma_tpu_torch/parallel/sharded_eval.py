"""Data-parallel evaluation helpers (counterpart of
hma_tpu/parallel/sharded_eval.py), one process a card.

`hma_tpu` shards each global batch over a (dp, fsdp, tp, sp) mesh of every
device and reduces the metrics inside jit. Here each process evaluates its
contiguous rows of every global batch (`distributed.local_slice`) on its own
device (`distributed.make_global_batch`, the counterpart of `put_batch`), so
a global batch must be a multiple of the data degree, the world size; its
random draws are its rows of the global batch's (`distributed.rank_rows`),
and the CLIs average the per-batch metrics over the ranks. fsdp, tp and sp
above 1 raise (ROADMAP.md Queue A items 10b and 10c).
"""

from __future__ import annotations

import torch

from hma_tpu_torch.parallel import distributed
from hma_tpu_torch.parallel.mesh import check_factors


def setup_eval_mesh(fsdp: int = 1, tp: int = 1, sp: int = 1,
                    device=None) -> torch.device:
    """This process's evaluation device (its card unless `device` says
    otherwise); pure dp over every process. Raises for fsdp, tp or sp
    above 1."""
    check_factors(None, fsdp, tp, sp)
    return distributed.local_device(device)


def data_degree() -> int:
    """A global batch must be a multiple of this: the number of processes."""
    return distributed.process_count()


def round_batch(n: int) -> int:
    """Largest multiple of the data degree <= n (0 if none)."""
    d = data_degree()
    return (n // d) * d
