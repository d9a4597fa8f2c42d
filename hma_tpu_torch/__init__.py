"""PyTorch/CUDA port of hma_tpu for NVIDIA Hopper (H100).

A second package beside `hma_tpu`, which stays the reference: module names
mirror `hma_tpu`'s, the port imports nothing of it (nor of JAX), and every
Pallas TPU kernel on a ported path is a CUDA kernel under `csrc/`, built at
first use (`ops/_build.py`). Entry points run on the card unless the caller
asks for the CPU; a CPU tensor takes each kernel's plain PyTorch version.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device` as given, else the CUDA card; raises when neither exists
    rather than carrying on on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found; pass device='cpu' to run "
                           "on the CPU")
    return torch.device("cuda")
