"""Evaluation helpers (counterpart of hma_tpu/parallel/sharded_eval.py) on
one device. `hma_tpu` shards the batch over a (dp, fsdp, tp, sp) mesh of
every device; here the "mesh" is the one torch device, the data degree is 1,
a batch is moved to the device and its rows come back as numpy. A degree
above 1 raises (ROADMAP.md Queue A, item 10)."""

from __future__ import annotations

import numpy as np
import torch

from hma_tpu_torch import resolve_device
from hma_tpu_torch.parallel.distributed import MULTI_GPU


def setup_eval_mesh(fsdp: int = 1, tp: int = 1, sp: int = 1,
                    device=None) -> torch.device:
    """The device evaluation runs on (the CUDA card unless `device` says
    otherwise); raises for fsdp, tp or sp above 1."""
    if max(fsdp, tp, sp) > 1:
        raise NotImplementedError(f"--fsdp {fsdp} --tp {tp} --sp {sp}: {MULTI_GPU}")
    return resolve_device(device)


def data_degree(mesh) -> int:
    """A global batch must be a multiple of this: 1 on one device."""
    return 1


def round_batch(n: int, mesh) -> int:
    """Largest multiple of the data degree <= n."""
    d = data_degree(mesh)
    return (n // d) * d


def put_batch(local: dict, mesh) -> dict:
    """numpy arrays (and tensors) of a batch dict -> tensors on the device;
    scalars and None pass through."""
    def leaf(v):
        if isinstance(v, np.ndarray) or torch.is_tensor(v):
            return torch.as_tensor(v).to(mesh)
        return v

    return {k: leaf(v) for k, v in local.items()}


def local_rows(global_arr: torch.Tensor) -> np.ndarray:
    """A batch's rows as numpy, in batch order."""
    return global_arr.detach().cpu().numpy()
