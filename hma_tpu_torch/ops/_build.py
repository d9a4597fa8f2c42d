"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface (pointers and the stream
as `void*`, sizes and strides as integers, `cudaGetLastError()` as the
return value) and is compiled at first use into
`<repo>/build/hma_tpu_torch/lib<name>.so`:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o lib<name>.so <name>.cu

The library's file name carries a hash of the source, of the headers
(`csrc/*.cuh`) and of the flags, so an edited source or header is rebuilt
and a stale library is never loaded. `build_all` starts one nvcc per
source, all at once. `launch_attention` holds the checks and the launch
that both attention forward kernels share, `launch_attention_bwd` those of
both backward kernels, `launch_temporal_resident{,_bwd}` those of the
resident-layout temporal kernel (K5'), and `launch_denoise_loop` the
scratch and the launch of the denoise-loop kernel.

The attention kernels take every head dim D from 1 to MAX_HEAD_DIM. At D 16,
32 and 64 (ALIGNED_HEAD_DIMS) they stage rows with 16-byte cp.async copies,
so each launcher refuses rows there that do not start 16-byte aligned. Any
other D runs the same bodies at the next of those widths, at any 2-byte
alignment: each row's covering 16-byte-aligned chunks are copied with
cp.async and the row is shifted into place and zero-padded in shared
memory, inside the kernel. Those copies read up to 15 bytes before and
after a row, never outside its 16-byte-aligned extent. D past 64 raises.
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
           "temporal_attention_fwd", "temporal_attention_bwd",
           "temporal_resident_fwd", "temporal_resident_bwd", "denoise_loop")
MAX_HEAD_DIM = 64
ALIGNED_HEAD_DIMS = (16, 32, 64)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
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
def _entry(name: str, n_ptrs: int, n_ints: int, n_strides: int):
    """The C entry `hma_<name>(*n_ptrs pointers, *n_ints ints, *n_strides
    strides, stream)` of library `name`: the attention kernels take (lead,
    L, H, D, dtype, *flags) or, resident, (B, T, S, H, D, dtype), then the
    strides of each strided tensor."""
    fn = getattr(library(name), f"hma_{name}")
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                   + [ctypes.c_longlong] * n_strides + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def aligned16(t: torch.Tensor) -> bool:
    """Whether every row of t (its last axis) starts 16-byte aligned."""
    return not (t.data_ptr() % 16
                or any(s * t.element_size() % 16 for s in t.stride()[:-1]))


def rows16(t: torch.Tensor, dtype) -> torch.Tensor:
    """t in `dtype`, copied when the kernels cannot read it as it is: a D
    stride other than 1, or, at a head dim of the aligned path, a row not
    16-byte aligned."""
    t = t.to(dtype)
    if t.stride(-1) != 1 or (t.shape[-1] in ALIGNED_HEAD_DIMS and not aligned16(t)):
        t = t.clone(memory_format=torch.contiguous_format)
    return t


def _check(name: str, tensors, max_len: int, ndim: int = 4) -> None:
    """Raise unless `tensors` are (lead, L, H, D), or with ndim 5 the
    resident kernel's (B, L, S, H, D), of one shape and dtype (fp32 or bf16)
    on one device, with 1 <= D <= MAX_HEAD_DIM, 0 < L <= max_len, no empty
    axis and a unit stride on D, and, where D is in ALIGNED_HEAD_DIMS, every
    row 16-byte aligned (the data pointer and the strides of the other
    axes), as the kernels' cp.async copies need there."""
    q = tensors[0]
    if any(t.shape != q.shape for t in tensors) or q.ndim != ndim:
        raise ValueError(f"{name}: shapes {[tuple(t.shape) for t in tensors]}")
    if q.dtype not in _DTYPE_CODE or any(t.dtype != q.dtype for t in tensors):
        raise ValueError(f"{name}: dtypes {[t.dtype for t in tensors]}")
    L, D = q.shape[1], q.shape[-1]
    if D > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {D} is past the kernels' {MAX_HEAD_DIM}; "
                         "wider heads (D 128) are still to port (ROADMAP Queue B)")
    if not 0 < L <= max_len or q.numel() == 0:
        raise ValueError(f"{name}: needs 1 <= D <= {MAX_HEAD_DIM}, 0 < L <= {max_len} "
                         f"and no empty axis, got {q.shape}")
    if any(t.device != q.device or t.stride(-1) != 1 for t in tensors):
        raise ValueError(f"{name}: inputs must share a device and have a "
                         "unit stride on D")
    if D in ALIGNED_HEAD_DIMS and not all(map(aligned16, tensors)):
        raise ValueError(f"{name}: at D {D} every row must start 16-byte aligned "
                         "(data pointer and strides); copy a misaligned view first")


def launch_attention(name: str, q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor, max_len: int, *flags: int):
    """Launch the attention forward kernel `name` on CUDA tensors q, k, v.

    q, k, v: (lead, L, H, D) as `_check` takes them, any strides on the
    first three axes. Raises on anything else or when the
    launch fails. Returns (out (lead, L, H, D) contiguous, lse (lead, H, L)
    fp32).
    """
    _check(name, (q, k, v), max_len)
    lead, L, H, D = q.shape
    out = torch.empty(lead, L, H, D, dtype=q.dtype, device=q.device)
    lse = torch.empty(lead, H, L, dtype=torch.float32, device=q.device)
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    status = _entry(name, 5, 5 + len(flags), 9)(
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
    strides on the first three axes; lse: (lead, H, L)
    fp32 as the forward wrote it. With `delta`, a (lead, H, L) fp32
    scratch for the row sums dout . out is allocated for the kernel. Raises
    on anything else or when the launch fails. Returns contiguous (dq, dk,
    dv), each (lead, L, H, D).
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
    status = _entry(name, 10, 5 + len(flags), 15)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        dout.data_ptr(), *(g.data_ptr() for g in grads),
        None if scratch is None else scratch.data_ptr(),
        lead, L, H, D, _DTYPE_CODE[q.dtype], *flags, *strides,
        torch.cuda.current_stream(q.device).cuda_stream)
    if status != 0:
        raise RuntimeError(f"{name} launch: CUDA error {status}")
    return tuple(grads)


def launch_temporal_resident(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             max_len: int):
    """Launch K5''s forward on CUDA tensors q, k, v, (B, T, S, H, D) as
    `_check` takes them, any strides on the first four axes.
    Raises on anything else or when the launch fails. Returns (out
    (B, T, S, H, D) contiguous, lse (B*S, H, T) fp32)."""
    name = "temporal_resident_fwd"
    _check(name, (q, k, v), max_len, ndim=5)
    B, T, S, H, D = q.shape
    out = torch.empty(B, T, S, H, D, dtype=q.dtype, device=q.device)
    lse = torch.empty(B * S, H, T, dtype=torch.float32, device=q.device)
    strides = [s for t in (q, k, v) for s in t.stride()[:4]]
    status = _entry(name, 5, 6, 12)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        B, T, S, H, D, _DTYPE_CODE[q.dtype], *strides,
        torch.cuda.current_stream(q.device).cuda_stream)
    if status != 0:
        raise RuntimeError(f"{name} launch: CUDA error {status}")
    return out, lse


def launch_temporal_resident_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 out: torch.Tensor, lse: torch.Tensor,
                                 dout: torch.Tensor, max_len: int) -> torch.Tensor:
    """Launch K5''s backward on CUDA tensors: q, k, v, out, dout (B, T, S, H,
    D) as `_check` takes them, lse (B*S, H, T) fp32 as the
    forward wrote it. Raises on anything else or when the launch fails.
    Returns dq, dk and dv as the three slots of one contiguous (B, T, S, 3,
    H, D)."""
    name = "temporal_resident_bwd"
    _check(name, (q, k, v, out, dout), max_len, ndim=5)
    B, T, S, H, D = q.shape
    if (lse.shape != (B * S, H, T) or lse.dtype != torch.float32
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f"{name}: lse must be contiguous fp32 {(B * S, H, T)} on "
                         f"{q.device}, got {lse.dtype} {tuple(lse.shape)}")
    dqkv = torch.empty(B, T, S, 3, H, D, dtype=q.dtype, device=q.device)
    strides = [s for t in (q, k, v, out, dout) for s in t.stride()[:4]]
    status = _entry(name, 7, 6, 20)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        dout.data_ptr(), dqkv.data_ptr(), B, T, S, H, D, _DTYPE_CODE[q.dtype],
        *strides, torch.cuda.current_stream(q.device).cuda_stream)
    if status != 0:
        raise RuntimeError(f"{name} launch: CUDA error {status}")
    return dqkv


@functools.cache
def _denoise_entry():
    """The C entry `hma_denoise_loop(12 pointers, K, N, C, H, depth, dtype,
    clip, domain_ln, n_half, cfg, temperature, stream)`."""
    fn = library("denoise_loop").hma_denoise_loop
    fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 9
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def launch_denoise_loop(x_noise: torch.Tensor, zs: torch.Tensor, mods: torch.Tensor,
                        sched: torch.Tensor, weights: torch.Tensor, ln: torch.Tensor,
                        *, K: int, N: int, C: int, H: int, depth: int, dtype,
                        clip_denoised: bool, domain_ln: bool, n_half: int,
                        cfg: float, temperature: float) -> torch.Tensor:
    """Launch the denoise-loop kernel on contiguous CUDA tensors: x_noise
    (N, C), zs (K, N, C) and sched (K, 8) fp32; mods (K, N, depth*3H + 2H)
    and the packed `weights` in `dtype` (fp32 or bf16); `ln` fp32. Allocates
    the kernel's scratch (three (N, H) activations in `dtype`: the residual
    stream, its LayerNorm and modulation, fc1's output; the net output (N,
    2C) and two copies of x in fp32) and returns x (N, C) fp32. Raises
    on anything else or when the launch is refused (a cooperative grid that
    does not fit the card comes back as an error, never as a partial run).
    """
    dev = x_noise.device
    n_w = C * H + H + depth * 2 * (H * H + H) + 2 * C * H + 2 * C
    want = {"x_noise": (x_noise, (N, C), torch.float32),
            "zs": (zs, (K, N, C), torch.float32),
            "mods": (mods, (K, N, depth * 3 * H + 2 * H), dtype),
            "sched": (sched, (K, 8), torch.float32),
            "weights": (weights, (n_w,), dtype),
            "ln": (ln, (depth * 2 * H,), torch.float32)}
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"denoise_loop: dtype {dtype}")
    for name, (t, shape, dt) in want.items():
        if (tuple(t.shape) != shape or t.dtype != dt or t.device != dev
                or not t.is_contiguous() or dev.type != "cuda"):
            raise ValueError(f"denoise_loop: {name} must be contiguous {dt} {shape} "
                             f"on a CUDA device, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    hbuf, nbuf, abuf = torch.empty(3, N, H, dtype=dtype, device=dev).unbind()
    outbuf = torch.empty(N, 2 * C, dtype=torch.float32, device=dev)
    xbuf = torch.empty(2, N, C, dtype=torch.float32, device=dev)
    x_out = torch.empty(N, C, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        status = _denoise_entry()(
            x_noise.data_ptr(), zs.data_ptr(), mods.data_ptr(), sched.data_ptr(),
            weights.data_ptr(), ln.data_ptr(), hbuf.data_ptr(), nbuf.data_ptr(),
            abuf.data_ptr(), outbuf.data_ptr(), xbuf.data_ptr(), x_out.data_ptr(),
            K, N, C, H, depth, _DTYPE_CODE[dtype], int(clip_denoised),
            int(domain_ln), n_half, cfg, temperature,
            torch.cuda.current_stream(dev).cuda_stream)
    if status != 0:
        raise RuntimeError(f"denoise_loop launch: CUDA error {status}")
    return x_out
