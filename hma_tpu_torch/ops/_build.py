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
checks and the launch that both attention forward kernels share,
`launch_attention_bwd` those of both backward kernels.
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
SOURCES = ("fused_attention_fwd", "fused_attention_bwd",
           "temporal_attention_fwd", "temporal_attention_bwd")
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
def _entry(name: str, n_ptrs: int, n_flags: int, n_strided: int):
    """The C entry `hma_<name>(*n_ptrs pointers, lead, L, H, D, dtype,
    *n_flags flags, 3 strides for each of n_strided tensors, stream)` of
    library `name`."""
    fn = getattr(library(name), f"hma_{name}")
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * (5 + n_flags)
                   + [ctypes.c_longlong] * (3 * n_strided) + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(name: str, tensors, max_len: int) -> None:
    """Raise unless `tensors` are (lead, L, H, D) of one shape and dtype
    (fp32 or bf16) on one device, with D in HEAD_DIMS, 0 < L <= max_len,
    lead > 0 and a unit stride on D."""
    q = tensors[0]
    lead, L, H, D = q.shape
    if any(t.shape != q.shape for t in tensors):
        raise ValueError(f"{name}: shapes {[tuple(t.shape) for t in tensors]}")
    if q.dtype not in _DTYPE_CODE or any(t.dtype != q.dtype for t in tensors):
        raise ValueError(f"{name}: dtypes {[t.dtype for t in tensors]}")
    if D not in HEAD_DIMS or not 0 < L <= max_len or lead == 0:
        raise ValueError(f"{name}: needs D in {HEAD_DIMS}, 0 < L <= {max_len} "
                         f"and lead > 0, got {q.shape}")
    if any(t.device != q.device or t.stride(3) != 1 for t in tensors):
        raise ValueError(f"{name}: inputs must share a device and have a "
                         "unit stride on D")


def launch_attention(name: str, q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor, max_len: int, *flags: int):
    """Launch the attention forward kernel `name` on CUDA tensors q, k, v.

    q, k, v: (lead, L, H, D) as `_check` takes them, any strides on the
    first three axes. Raises on anything else or when the launch fails.
    Returns (out (lead, L, H, D) contiguous, lse (lead, H, L) fp32).
    """
    _check(name, (q, k, v), max_len)
    lead, L, H, D = q.shape
    out = torch.empty(lead, L, H, D, dtype=q.dtype, device=q.device)
    lse = torch.empty(lead, H, L, dtype=torch.float32, device=q.device)
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    status = _entry(name, 5, len(flags), 3)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        lead, L, H, D, _DTYPE_CODE[q.dtype], *flags, *strides,
        torch.cuda.current_stream(q.device).cuda_stream)
    if status != 0:
        raise RuntimeError(f"{name} launch: CUDA error {status}")
    return out, lse


def launch_attention_bwd(name: str, q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
                         dout: torch.Tensor, max_len: int, *flags: int,
                         delta: bool = False):
    """Launch the attention backward kernel `name` on CUDA tensors.

    q, k, v, out, dout: (lead, L, H, D) as `_check` takes them, any
    strides on the first three axes; lse: (lead, H, L) fp32 as the forward
    wrote it. With `delta`, a (lead, H, L) fp32 scratch for the row sums
    dout . out is allocated for the kernel. Raises on anything else or when
    the launch fails. Returns contiguous (dq, dk, dv), each (lead, L, H, D).
    """
    _check(name, (q, k, v, out, dout), max_len)
    lead, L, H, D = q.shape
    if (lse.shape != (lead, H, L) or lse.dtype != torch.float32
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f"{name}: lse must be contiguous fp32 {(lead, H, L)} on "
                         f"{q.device}, got {lse.dtype} {tuple(lse.shape)}")
    grads = [torch.empty(lead, L, H, D, dtype=q.dtype, device=q.device)
             for _ in range(3)]
    scratch = (torch.empty(lead, H, L, dtype=torch.float32, device=q.device)
               if delta else None)
    strides = [s for t in (q, k, v, out, dout) for s in t.stride()[:3]]
    status = _entry(name, 10, len(flags), 5)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        dout.data_ptr(), *(g.data_ptr() for g in grads),
        None if scratch is None else scratch.data_ptr(),
        lead, L, H, D, _DTYPE_CODE[q.dtype], *flags, *strides,
        torch.cuda.current_stream(q.device).cuda_stream)
    if status != 0:
        raise RuntimeError(f"{name} launch: CUDA error {status}")
    return tuple(grads)
