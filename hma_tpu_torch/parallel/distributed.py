"""Multi-process runtime (counterpart of hma_tpu/parallel/distributed.py)
for one process: `init_distributed` starts nothing and raises when the
environment asks for more than one process; the rest are the identities
`hma_tpu`'s helpers reduce to in the single-process case."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

MULTI_GPU = "multi-GPU is not ported yet (ROADMAP.md Queue A, item 10)"


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     local_device_ids: Optional[str] = None) -> bool:
    """Always False (single process); raises when the arguments or the
    HMA_TPU_COORDINATOR / HMA_TPU_NUM_PROCESSES environment ask for more."""
    env = os.environ
    coordinator_address = coordinator_address or env.get("HMA_TPU_COORDINATOR")
    if num_processes is None and env.get("HMA_TPU_NUM_PROCESSES"):
        num_processes = int(env["HMA_TPU_NUM_PROCESSES"])
    if coordinator_address == "auto" or (num_processes or 1) > 1:
        raise NotImplementedError(f"{num_processes or 'auto'} processes: {MULTI_GPU}")
    return False


def process_index() -> int:
    return 0


def is_primary() -> bool:
    return True


def local_slice(global_indices: np.ndarray) -> np.ndarray:
    """This process's share of a global batch's indices: all of them."""
    return global_indices


def aggregate_host_metrics(metrics: dict) -> dict:
    """The mean of host-local metrics over processes: with one, a copy."""
    return dict(metrics)
