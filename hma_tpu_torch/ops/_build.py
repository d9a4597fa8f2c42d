"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface (pointers and the stream
as `void*`, sizes and strides as integers, `cudaGetLastError()` as the
return value) and is compiled at first use into
`<repo>/build/hma_tpu_torch/lib<name>.so`:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o lib<name>.so <name>.cu

The library's file name carries a hash of the source and flags, so an
edited source is rebuilt and a stale library is never loaded. `build_all`
starts one nvcc per source, all at once. `launch_attention` holds the
checks and the launch that both attention kernels share.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "hma_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = ("fused_attention_fwd", "temporal_attention_fwd")
HEAD_DIMS = (32, 64)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build_all(names=SOURCES) -> dict:
    """Compile every missing library in parallel.

    Returns {name: {"seconds": wall time, "log": nvcc/ptxas output}}
    (an empty log for a library that was already built)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, report = {}, {}
    t0 = time.perf_counter()
    for name in names:
        out = _target(name)
        if out.exists():
            report[name] = {"seconds": 0.0, "log": ""}
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, out)
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
    return report


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, built first if needed."""
    build_all((name,))
    return ctypes.CDLL(str(_target(name)))


@functools.cache
def _entry(name: str, n_flags: int):
    """The C entry `hma_<name>(q, k, v, out, lse, lead, L, H, D, dtype,
    *flags, 9 strides, stream)` of library `name`."""
    fn = getattr(library(name), f"hma_{name}")
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * (5 + n_flags)
                   + [ctypes.c_longlong] * 9 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def launch_attention(name: str, q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor, max_len: int, *flags: int):
    """Launch the attention kernel `name` on CUDA tensors q, k, v.

    q, k, v: (lead, L, H, D) of one shape and dtype (fp32 or bf16), on one
    device, with D in HEAD_DIMS, 0 < L <= max_len, lead > 0, any strides on
    the first three axes and a unit stride on D. Raises on anything else or
    when the launch fails. Returns (out (lead, L, H, D) contiguous, lse
    (lead, H, L) fp32).
    """
    lead, L, H, D = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name}: shapes {q.shape} {k.shape} {v.shape}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: dtypes {q.dtype} {k.dtype} {v.dtype}")
    if D not in HEAD_DIMS or not 0 < L <= max_len or lead == 0:
        raise ValueError(f"{name}: needs D in {HEAD_DIMS}, 0 < L <= {max_len} "
                         f"and lead > 0, got {q.shape}")
    if any(t.device != q.device or t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError(f"{name}: q, k, v must share a device and have a "
                         "unit stride on D")
    out = torch.empty(lead, L, H, D, dtype=q.dtype, device=q.device)
    lse = torch.empty(lead, H, L, dtype=torch.float32, device=q.device)
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    status = _entry(name, len(flags))(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        lead, L, H, D, _DTYPE_CODE[q.dtype], *flags, *strides,
        torch.cuda.current_stream(q.device).cuda_stream)
    if status != 0:
        raise RuntimeError(f"{name} launch: CUDA error {status}")
    return out, lse
