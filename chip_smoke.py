#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (hma_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--phases 1,2,3,...]   (default: all eight)

Phases, each failing the run on any error:
  1. device: the card's name and power limit (nvidia-smi), the device count;
  2. build: the four CUDA kernels from hma_tpu_torch/csrc with nvcc, one
     process each, with the build time and what `-Xptxas -v` reports;
  3. kernels against their plain PyTorch versions at the main path's shapes
     and one ragged shape each, fp32 and bf16:
     - K1' (spatial) and K3' (temporal) forwards, out and lse. fp32: atol =
       rtol = 1e-5. bf16: lse to 1e-5, out to a limit per kernel (BF16_TOL)
       and at most 1 % of outputs differing from the plain version at all;
       a negative control must exceed that share: for K1' the plain version
       without the bf16 rounding of the probs, for K3' (which keeps fp32
       probs, as its TPU kernel does) the plain version with it;
     - K2' and K4' backwards, dq, dk and dv from the same out, lse and a
       strided dout. fp32: atol = rtol = BWD_FP32_TOL. bf16: BWD_BF16_TOL
       and the 1 % share; the negative control is the plain backward with
       the other kernel's rounding of p and ds (K2' rounds, K4' does not);
     then kernel, plain and library times with CUDA events (the library
     call is a yardstick the port never calls: SDPA's forward for K1'/K3',
     the backward alone of SDPA, on a retained graph, for K2'/K4');
  4. rollouts at full width: the d256 card (32 layers, d 256, T 12, S 256 +
     64 action tokens, 2 x 512 vocab) with the 40-domain synthetic action
     fields and random weights from seed 0. The cached per-frame forward is
     held to the full forward in fp32 at B = 1 (EXACT_TOL), and two planted
     cache faults must exceed that limit; then the KV-cached rollout and
     the full-recompute rollout run at B = 8, 2 prompt frames, 2 MaskGIT
     steps, bf16, temperature 0, with the kernels' launch counts set to 0
     just before each and read just after;
  5. entry point: `hma_tpu_torch.generate.main` on a synthetic dataset and a
     2-layer d256 checkpoint written to a temporary directory;
  6. training at full width: the same card in bf16 with remat ("full") and
     the domain-sliced AdamW (lr 1e-4, wd 0.01), B = 8 of bench.py's batch
     (random tokens from seed 0, the first half of each frame 1.. masked).
     One warm-up step, then TRAIN_STEPS timed steps with the launch counts
     set to 0 just before and read just after (64/32/64/32 of K1'/K2'/K3'/
     K4' per step: remat runs each forward twice); median step time,
     tokens/s, peak memory, a profiler breakdown and the device's busy
     share; finite loss and grad norm, nothing skipped. Then OVERFIT_STEPS
     steps on the fixed batch at lr 3e-4, wd 0: the loss must fall by at
     least OVERFIT_MARGIN;
  7. gradient exactness: a 2-layer d256 card at B = 2 in fp32, one loss and
     backward with the kernels on the card against the plain versions on
     the CPU: loss to 1e-5 relative, every parameter gradient to
     max |dg| <= GRAD_TOL * max |g| per tensor;
  8. entry point: `hma_tpu_torch.train_multi.main` for a few steps of a
     2-layer d256 card on a synthetic dataset, then phase 5's generate from
     the checkpoint it wrote.

Prints one JSON line of kernel records, then the nvidia-smi line, and last
{"ok": true, "device": {...}}. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOP_PER_S = 989e12   # H100 SXM dense bf16
FP32_TOL = 1e-5  # fp32 out and lse; bf16 lse (it is fp32 in both)
# bf16 out, atol = rtol: about twice the worst reading on the card. Both
# versions round probs and out to bf16, so a different exp or summation
# order flips an output by one bf16 ulp now and then: ~1e-3 at K1''s
# |out| ~ 0.2, ~8e-3 at K3''s |out| ~ 1 (few frames, so larger outputs).
BF16_TOL = {"K1'": 4e-3, "K3'": 1e-2}
# Share of bf16 outputs that may differ from the plain version at all:
# such flips are rare (< 0.1 %), while a kernel that skips rounding the
# probs to bf16 before p v moves ~30-40 % of its outputs.
MISMATCH_LIMIT = 0.01
EXACT_TOL = 1e-5  # fp32 cached-vs-full logits, 32 layers deep
REPEATS = 3  # timed runs of each rollout
# Backward limits on dq, dk, dv. fp32: on an H100 (700 W) K2' reads 0 (the
# plain version's cuBLAS sums in the kernel's order) and K4' 7e-7 of
# max |g|. bf16, atol = rtol: about twice what the H100 readings need, a
# 1-ulp flip at |g| ~ 10 (K4': 6.25e-2 at |g| 35; K2': 0).
BWD_FP32_TOL = 1e-4
BWD_BF16_TOL = {"K2'": 1e-2, "K4'": 1e-2}
TRAIN_STEPS = 6  # timed training steps after one warm-up
OVERFIT_STEPS = 30
# The loss must fall by at least this much over OVERFIT_STEPS: half of the
# fall an H100 (700 W) reads (12.4360 -> 11.9307, from random weights after
# the timed steps; the fall speeds up late, so later steps fall more).
OVERFIT_MARGIN = 0.25
GRAD_TOL = 1e-4  # phase 7: max |dg| <= GRAD_TOL * max |g| per tensor


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def flagship_config(num_domains: int = 40):
    """The d256 card plus synthetic per-domain action fields, the same ones
    `__graft_entry__._flagship_config` builds from seed 0 for the JAX bench."""
    from hma_tpu_torch.config import GenieConfig

    cfg = GenieConfig.from_pretrained(
        str(ROOT / "hma_tpu_torch" / "configs" / "magvit_n32_h8_d256_action.json"))
    rng = np.random.default_rng(0)
    cfg.action_domains = [f"domain_{i}" for i in range(num_domains)]
    cfg.d_actions, cfg.action_stats = [], []
    for _ in range(num_domains):
        base = int(rng.integers(2, 8))
        stride = int(rng.integers(1, 4))
        cfg.d_actions.append(base * stride)
        cfg.action_stats.append([rng.normal(size=base).tolist(),
                                 (np.abs(rng.normal(size=base)) + 0.5).tolist()])
    return cfg


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def strided_qkv(lead, H, D, dtype, seed):
    """q, k, v as SelfAttention._qkv hands them over: unit-stride views into
    one (..., 3, H, D) projection, q pre-scaled."""
    import torch

    g = torch.Generator("cuda").manual_seed(seed)
    qkv = torch.randn(*lead, 3, H, D, generator=g, device="cuda").to(dtype)
    q, k, v = qkv.unbind(-3)
    return q * D**-0.5, k, v


def check_kernel(kernel, plain, control, args, tol, label):
    """Hold kernel(*args) to plain(*args); returns max |out - plain|. In
    bf16 also the share of outputs that differ, beside that of the negative
    control, control(*args)."""
    import torch

    out, lse = kernel(*args)
    torch.cuda.synchronize()
    want, want_lse = plain(*args)
    torch.cuda.synchronize()
    err = (out.float() - want.float()).abs().max().item()
    lse_err = (lse - want_lse).abs().max().item()
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol,
                               msg=lambda m: f"{label} out: {m}")
    torch.testing.assert_close(lse, want_lse, atol=FP32_TOL, rtol=FP32_TOL,
                               msg=lambda m: f"{label} lse: {m}")
    line = (f"  {label}: max|out-plain| {err:.3e} (tol {tol})  "
            f"max|lse-plain| {lse_err:.3e} (tol {FP32_TOL})")
    if out.dtype == torch.bfloat16:
        ctl = control(*args)
        share = (out != want).float().mean().item()
        ctl_share = (ctl != want).float().mean().item()
        ctl_err = (ctl.float() - want.float()).abs().max().item()
        line += (f"  differ {share:.4%} (limit {MISMATCH_LIMIT:.0%}); "
                 f"control: differ {ctl_share:.4%}, max err {ctl_err:.3e}")
        require(share <= MISMATCH_LIMIT, f"{label}: {share:.4%} of outputs differ")
        require(ctl_share > MISMATCH_LIMIT,
                f"{label}: the check cannot tell the control apart")
    print(line, flush=True)
    return err


def check_bwd(kernel, plain, control, args, tol, label):
    """Hold kernel(*args) = (dq, dk, dv) to plain(*args); returns the
    largest max |d - plain| of the three. In bf16 also the share of
    outputs that differ, beside the negative control's."""
    import torch

    got = kernel(*args)
    torch.cuda.synchronize()
    want = plain(*args)
    ctl = control(*args) if got[0].dtype == torch.bfloat16 else None
    torch.cuda.synchronize()
    worst, parts = 0.0, []
    for i, name in enumerate(("dq", "dk", "dv")):
        g, w = got[i], want[i]
        require(g.dtype == w.dtype and g.is_contiguous(), f"{label} {name} layout")
        err = (g.float() - w.float()).abs().max().item()
        worst = max(worst, err)
        torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=tol,
                                   msg=lambda m: f"{label} {name}: {m}")
        part = f"{name} {err:.3e} (|g| <= {w.float().abs().max().item():.2f})"
        if ctl is not None:
            share = (g != w).float().mean().item()
            ctl_share = (ctl[i] != w).float().mean().item()
            part += f" differ {share:.4%}, control {ctl_share:.4%}"
            require(share <= MISMATCH_LIMIT, f"{label} {name}: {share:.4%} differ")
            require(ctl_share > MISMATCH_LIMIT,
                    f"{label} {name}: the check cannot tell the control apart")
        parts.append(part)
    print(f"  {label} (tol {tol}): " + "; ".join(parts), flush=True)
    return worst


def strided_dout(lead, H, D, dtype, seed):
    """dout as a view with a unit D stride and larger strides elsewhere."""
    import torch

    g = torch.Generator("cuda").manual_seed(seed)
    return torch.randn(*lead, 2, H, D, generator=g, device="cuda").to(dtype)[..., 0, :, :]


def bound(n_bytes, n_ops):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / BF16_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def kernel_phase():
    """Phase 3: correctness at every shape, times at the main-path shapes."""
    import torch
    from torch.nn import functional as F

    from hma_tpu_torch.ops.fused_attention import (
        attention_bwd_plain, fused_attention, fused_attention_bwd,
        fused_attention_bwd_plain, fused_attention_plain)
    from hma_tpu_torch.ops.temporal_attention import (
        fused_temporal_attention, fused_temporal_attention_bwd,
        fused_temporal_attention_bwd_plain, fused_temporal_attention_plain)

    records = []
    src = {"K1'": ("fused_attention_fwd", "hma_tpu/ops/fused_attention.py:54"),
           "K2'": ("fused_attention_bwd", "hma_tpu/ops/fused_attention.py:79"),
           "K3'": ("temporal_attention_fwd", "hma_tpu/ops/temporal_attention.py:36"),
           "K4'": ("temporal_attention_bwd", "hma_tpu/ops/temporal_attention.py:63")}

    def record(name, shape, errs, ms, plain_ms, library_ms, n_bytes, n_ops):
        bound_ms, bound_by = bound(n_bytes, n_ops)
        records.append({
            "name": name, "shape": list(shape), "dtype": "bf16",
            "route": "cuda", "source": f"hma_tpu_torch/csrc/{src[name][0]}.cu",
            "replaces": src[name][1], "launches": None,
            "max_abs_err": errs[torch.bfloat16], "max_err": errs[torch.bfloat16],
            "max_abs_err_fp32": errs[torch.float32],
            "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms})
        print(f"  {name} {shape} bf16: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
              f"library {library_ms:.4f} ms  bound {bound_ms:.4f} ms ({bound_by})",
              flush=True)

    def rounded_probs(q, k, v):  # K3''s control: probs rounded as K1 does
        return fused_attention_plain(q, k, v, True)[0]

    def unrounded_probs(q, k, v, causal):  # K1''s control
        return fused_attention_plain(q, k, v, causal, dtype=torch.float32)[0]

    spatial = [((8, 320, 8, 32), False, True), ((96, 320, 8, 32), False, True),
               ((3, 77, 4, 64), True, False)]
    temporal = [((2560, 12, 8, 32), True), ((1000, 5, 3, 64), False)]
    cases = ([("K1'", s, c, main) for s, c, main in spatial]
             + [("K3'", s, True, main) for s, main in temporal])
    for name, shape, causal, main in cases:
        lead, H, D = shape[:2], shape[2], shape[3]
        spatial_k = name == "K1'"
        kernel, plain, control = (
            (fused_attention, fused_attention_plain, unrounded_probs) if spatial_k
            else (fused_temporal_attention, fused_temporal_attention_plain,
                  rounded_probs))
        extra = (causal,) if spatial_k else ()
        errs = {}
        for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL[name])):
            q, k, v = strided_qkv(lead, H, D, dtype, seed=len(records))
            errs[dtype] = check_kernel(kernel, plain, control, (q, k, v, *extra), tol,
                                       f"{name} {shape} causal={causal} {dtype}")
        if not main:
            continue
        q, k, v = strided_qkv(lead, H, D, torch.bfloat16, seed=1)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        ms = cuda_ms(lambda: kernel(q, k, v, *extra))
        plain_ms = cuda_ms(lambda: plain(q, k, v, *extra))
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, scale=1.0))
        n_rows = math.prod(lead) * H  # query rows
        n_bytes = 4 * math.prod(shape) * 2 + n_rows * 4  # q, k, v, out bf16; lse fp32
        keys = shape[1]
        pairs = keys * (keys + 1) // 2 if causal else keys * keys
        n_ops = 4 * (n_rows // keys) * pairs * D  # q.k and p.v, 2 ops per MAC
        record(name, shape, errs, ms, plain_ms, library_ms, n_bytes, n_ops)

    # backward kernels, from the forward kernel's out and lse
    bwd_cases = [("K2'", (96, 320, 8, 32), False, True), ("K2'", (3, 77, 4, 64), True, False),
                 ("K4'", (2560, 12, 8, 32), True, True), ("K4'", (1000, 5, 3, 64), True, False)]
    for name, shape, causal, main in bwd_cases:
        lead, H, D = shape[:2], shape[2], shape[3]
        if name == "K2'":
            fwd = lambda q, k, v: fused_attention(q, k, v, causal)
            kernel = lambda *a: fused_attention_bwd(*a, causal)
            plain = lambda *a: fused_attention_bwd_plain(*a, causal)
            control = lambda *a: attention_bwd_plain(*a, causal, False)
        else:
            fwd = fused_temporal_attention
            kernel, plain = fused_temporal_attention_bwd, fused_temporal_attention_bwd_plain
            control = lambda *a: attention_bwd_plain(*a, True, True)
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            tol = BWD_FP32_TOL if dtype == torch.float32 else BWD_BF16_TOL[name]
            q, k, v = strided_qkv(lead, H, D, dtype, seed=10 + len(records))
            out, lse = fwd(q, k, v)
            dout = strided_dout(lead, H, D, dtype, seed=20 + len(records))
            errs[dtype] = check_bwd(kernel, plain, control, (q, k, v, out, lse, dout),
                                    tol, f"{name} {shape} causal={causal} {dtype}")
        if not main:
            continue
        q, k, v = strided_qkv(lead, H, D, torch.bfloat16, seed=1)
        out, lse = fwd(q, k, v)
        dout = strided_dout(lead, H, D, torch.bfloat16, seed=2)
        args = (q, k, v, out, lse, dout)
        ms = cuda_ms(lambda: kernel(*args))
        plain_ms = cuda_ms(lambda: plain(*args))
        qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_(True) for x in (q, k, v))
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, scale=1.0)
        go = dout.transpose(1, 2)
        library_ms = cuda_ms(lambda: torch.autograd.grad(o, (qt, kt, vt), go,
                                                         retain_graph=True))
        del o
        n_rows = math.prod(lead) * H
        n_bytes = 8 * math.prod(shape) * 2 + n_rows * 4  # 5 in, 3 out bf16; lse
        keys = shape[1]
        pairs = keys * (keys + 1) // 2 if causal else keys * keys
        n_ops = 10 * (n_rows // keys) * pairs * D  # 5 products, 2 ops per MAC
        record(name, shape, errs, ms, plain_ms, library_ms, n_bytes, n_ops)
    return records


def profile_run(label, go, secs):
    """One more run of `go` under torch.profiler: device-busy share and the
    kernels that take the most device time (launches here are not counted)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        go()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not rows:
        print(f"  {label} profile: the profiler saw no device time", flush=True)
        return
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    print(f"  {label} profile: device busy {busy_ms:.2f} ms, "
          f"{busy_ms / (secs * 1e3):.1%} of the {secs * 1e3:.2f} ms median wall "
          f"time without the profiler, {busy_ms / (wall * 1e3):.1%} of the "
          f"{wall * 1e3:.2f} ms under it; top device time:", flush=True)
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d} x  "
              f"{e.key[:90]}", flush=True)


def main_path_phase(records):
    """Phase 4: the full-width d256 rollouts through the kernels."""
    import torch

    from hma_tpu_torch.models.st_mask_git import STMaskGIT
    from hma_tpu_torch.ops.fused_attention import fused_attention
    from hma_tpu_torch.ops.temporal_attention import fused_temporal_attention
    from hma_tpu_torch.rollout.maskgit import generate_tokens, generate_tokens_full

    cfg = flagship_config(40)
    t0 = time.perf_counter()
    model = STMaskGIT(cfg, dtype=torch.bfloat16, device="cuda",
                      generator=torch.Generator("cuda").manual_seed(0)).eval()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  d256 card, 40 domains: {n_params / 1e6:.1f}M params "
          f"(built in {time.perf_counter() - t0:.1f} s)", flush=True)

    B, P, STEPS = 8, 2, 2
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.image_vocab_size,
                                           (B, cfg.T, cfg.S))).cuda()
    actions = torch.from_numpy(rng.normal(size=(B, cfg.T, cfg.max_d_action))
                               .astype(np.float32)).cuda()

    # cached exactness in fp32 at B = 1
    model32 = STMaskGIT(cfg, dtype=torch.float32, device="cuda").eval()
    model32.load_state_dict(model.state_dict())
    with torch.no_grad():
        full, _ = model32.compute_logits(tokens[:1], actions[:1], 0)
        k, v = model32.init_cache(1)
        worst = 0.0
        for t in range(cfg.T):
            got, _, _ = model32.frame_logits(tokens[:1, t], t, k, v, actions[:1], 0)
            want = full[:, :, t].reshape(1, 2, -1, cfg.S).permute(0, 3, 1, 2)
            worst = max(worst, (got - want).abs().max().item())
        scale = full.abs().max().item()
        print(f"  fp32 frame_logits vs compute_logits, {cfg.T} frames, B=1: max "
              f"abs err {worst:.3e} (|logits| <= {scale:.2f}, tol {EXACT_TOL})",
              flush=True)
        require(math.isfinite(worst) and worst <= EXACT_TOL, "cached path not exact")
        # planted faults at the last frame: the limit must catch each
        t = cfg.T - 1
        want = full[:, :, t].reshape(1, 2, -1, cfg.S).permute(0, 3, 1, 2)
        kz, vz = k.clone(), v.clone()
        kz[:, :, t - 1] = 0
        vz[:, :, t - 1] = 0  # frame t-1's slot left unwritten
        kr, vr = k.clone(), v.clone()
        masked = torch.full_like(tokens[:1, t - 1], model32.mask_token_id)
        model32.frame_logits(masked, t - 1, kr, vr, actions[:1], 0)  # a refinement
        # pass over frame t-1 that writes its (all-mask) keys and values
        for fault, (kf, vf) in (("slot t-1 zeroed", (kz, vz)),
                                ("a refinement pass wrote slot t-1", (kr, vr))):
            got, _, _ = model32.frame_logits(tokens[:1, t], t, kf, vf, actions[:1],
                                             0, update_cache=False)
            err = (got - want).abs().max().item()
            print(f"  planted fault, {fault}: max abs err {err:.3e} "
                  f"(tol {EXACT_TOL})", flush=True)
            require(err > EXACT_TOL, f"the exactness limit misses: {fault}")
    del model32, full, k, v, kz, vz, kr, vr

    kw = dict(maskgit_steps=STEPS, temperature=0.0, unmask_mode="random")
    runs = {}
    for label, fn in (("cached", generate_tokens), ("full", generate_tokens_full)):
        def go():
            gen = torch.Generator("cuda").manual_seed(1)
            return fn(model, tokens, P, actions, 0, gen, **kw)

        go()  # warm-up, not counted
        torch.cuda.synchronize()
        fused_attention.launches = fused_temporal_attention.launches = 0
        t0 = time.perf_counter()
        out = go()
        torch.cuda.synchronize()
        secs = [time.perf_counter() - t0]
        counts = (fused_attention.launches, fused_temporal_attention.launches)
        same = True
        for _ in range(REPEATS - 1):  # the spread of the host-bound wall time
            t0 = time.perf_counter()
            same &= torch.equal(go(), out)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        frames = B * (cfg.T - P)
        runs[label] = (out, counts)
        print(f"  {label} rollout: {frames} frames in "
              f"{', '.join(f'{t:.4f}' for t in secs)} s; median "
              f"{frames / sorted(secs)[len(secs) // 2]:.2f} frames/s; "
              f"launches K1'={counts[0]} K3'={counts[1]}; repeats give the "
              f"same tokens: {same}", flush=True)
        require(torch.equal(out[:, :P], tokens[:, :P]), f"{label}: prompt changed")
        require(bool(((out >= 0) & (out < cfg.image_vocab_size)).all()),
                f"{label}: tokens out of range")
        profile_run(f"{label} rollout", go, sorted(secs)[len(secs) // 2])
    (cached, (c_k1, c_k3)), (full_out, (f_k1, f_k3)) = runs["cached"], runs["full"]
    forwards_cached = P + (cfg.T - P) * (STEPS + 1)
    require(c_k1 == forwards_cached * cfg.num_layers and c_k3 == 0,
            f"cached rollout launches K1'={c_k1} K3'={c_k3}")
    forwards_full = (cfg.T - P) * STEPS
    require(f_k1 == forwards_full * cfg.num_layers
            and f_k3 == forwards_full * cfg.num_layers,
            f"full rollout launches K1'={f_k1} K3'={f_k3}")
    agree = (cached[:, P:] == full_out[:, P:]).float().mean().item()
    agree_first = (cached[:, P] == full_out[:, P]).float().mean().item()
    print(f"  cached vs full-recompute tokens agree on {agree:.4f} of generated "
          f"tokens, {agree_first:.4f} of the first generated frame's (bf16 may "
          f"break near-ties; a changed token changes every later frame)", flush=True)
    for r in records:
        if r["name"] == "K1'":
            r["launches"] = c_k1 if r["shape"][0] == B else f_k1
        elif r["name"] == "K3'":
            r["launches"] = f_k3
    print(f"  peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)


def write_dataset(path, cfg, seed):
    """A synthetic 40-frame token dataset for domain_0 of `cfg`."""
    from hma_tpu_torch.data.datasets import write_token_dataset

    rng = np.random.default_rng(seed)
    n, side = 40, math.isqrt(cfg.S)
    write_token_dataset(
        path, rng.integers(0, cfg.image_vocab_size, (n, side, side)).astype(np.uint32),
        np.repeat(np.arange(n // 20), 20),
        rng.normal(size=(n, cfg.d_actions[0])).astype(np.float32),
        {"name": "domain_0", "vocab_size": cfg.image_vocab_size})


def check_generate(ckpt_dir, data_dir, out_dir, T, S, vocab):
    """`hma_tpu_torch.generate.main` on the card; checks what it wrote and
    that it launched K1'."""
    from hma_tpu_torch.generate import main as generate_main
    from hma_tpu_torch.ops.fused_attention import fused_attention

    fused_attention.launches = 0
    generate_main(["--checkpoint_dir", str(ckpt_dir), "--val_data_dir", str(data_dir),
                   "--output_dir", str(out_dir), "--batch_size", "2",
                   "--num_prompt_frames", "2", "--device", "cuda"])
    meta = json.loads((Path(out_dir) / "metadata.json").read_text())
    video = np.fromfile(Path(out_dir) / "video.bin", dtype=np.uint32)
    require(meta["num_images"] == 2 * (2 * T - 2), f"metadata {meta}")
    require(video.size == meta["num_images"] * S, "video.bin size")
    require(int(video.max()) < vocab, "video.bin token range")
    require(fused_attention.launches > 0, "generate CLI did not launch K1'")
    print(f"  generate CLI from {Path(ckpt_dir).name}: {meta['num_images']} frames "
          f"written, K1' launches {fused_attention.launches}", flush=True)


def entry_point_phase():
    """Phase 5: the generate CLI on a 2-layer d256 checkpoint."""
    import torch

    from hma_tpu_torch.models.st_mask_git import STMaskGIT
    from hma_tpu_torch.utils.checkpoint import save_checkpoint

    cfg = flagship_config(40)
    cfg.num_layers = 2
    model = STMaskGIT(cfg, device="cuda",
                      generator=torch.Generator("cuda").manual_seed(2))
    with tempfile.TemporaryDirectory() as tmp:
        write_dataset(Path(tmp) / "data", cfg, seed=2)
        save_checkpoint(tmp, "ckpt", model.state_dict(), cfg)
        check_generate(Path(tmp) / "ckpt", Path(tmp) / "data", Path(tmp) / "out",
                       cfg.T, cfg.S, cfg.image_vocab_size)


def kernel_counters():
    from hma_tpu_torch.ops.fused_attention import fused_attention, fused_attention_bwd
    from hma_tpu_torch.ops.temporal_attention import (
        fused_temporal_attention, fused_temporal_attention_bwd)

    return {"K1'": fused_attention, "K2'": fused_attention_bwd,
            "K3'": fused_temporal_attention, "K4'": fused_temporal_attention_bwd}


def reset_counts():
    for fn in kernel_counters().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in kernel_counters().items()}


def train_batch(cfg, B, device):
    """bench.py's batch: random tokens and actions from seed 0, the first
    half of each frame 1.. masked, domain 0."""
    import torch

    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.image_vocab_size, (B, cfg.T, cfg.S))
    actions = rng.normal(size=(B, cfg.T, cfg.max_d_action)).astype(np.float32)
    inp = tokens.copy()
    inp[:, 1:, : cfg.S // 2] = cfg.image_vocab_size
    return {"input_ids": torch.from_numpy(inp).to(device),
            "labels": torch.from_numpy(tokens).to(device),
            "action_ids": torch.from_numpy(actions).to(device), "domain_id": 0}


def training_phase(records):
    """Phase 6: the full-width d256 training step through the kernels."""
    import torch

    from hma_tpu_torch.models.st_mask_git import STMaskGIT, smoothed_ce_floor
    from hma_tpu_torch.train.step import make_domain_sliced_optimizer, make_train_step
    from hma_tpu_torch.train.trainer import stacked_param_mask

    torch.cuda.empty_cache()
    cfg = flagship_config(40)
    B = 8
    model = STMaskGIT(cfg, dtype=torch.bfloat16, device="cuda", remat=True,
                      generator=torch.Generator("cuda").manual_seed(0))
    mask = stacked_param_mask(model, cfg)
    tx = make_domain_sliced_optimizer(model, 1e-4, stacked_mask=mask,
                                      num_domains=cfg.num_domains)
    step = make_train_step(model.train(), tx)
    batch = train_batch(cfg, B, "cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    m = step(batch)  # warm-up, not counted
    torch.cuda.synchronize()
    print(f"  warm-up step {time.perf_counter() - t0:.2f} s, loss "
          f"{m['loss'].item():.4f}", flush=True)
    reset_counts()
    secs, metrics = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        metrics.append(step(batch))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    for m in metrics:
        require(math.isfinite(m["loss"].item()) and math.isfinite(m["grad_norm"].item()),
                f"training step not finite: {m}")
        require(m["skipped"].item() == 0.0, "a training step was skipped")
    med = sorted(secs)[len(secs) // 2]
    tokens = B * cfg.T * cfg.S
    per_step = {k: v / TRAIN_STEPS for k, v in counts.items()}
    print(f"  {TRAIN_STEPS} steps at B={B}: {', '.join(f'{t:.4f}' for t in secs)} s; "
          f"median {med:.4f} s, {tokens / med:.1f} tokens/s ({tokens} per step); "
          f"loss {metrics[0]['loss'].item():.4f} -> {metrics[-1]['loss'].item():.4f}, "
          f"grad norm {metrics[-1]['grad_norm'].item():.4f}, skipped 0; launches "
          f"per step {per_step}; peak memory {peak / 2**30:.2f} GiB", flush=True)
    layers = cfg.num_layers
    want = {"K1'": 2 * layers, "K2'": layers, "K3'": 2 * layers, "K4'": layers}
    require(per_step == want, f"launches per step {per_step}, want {want}")
    for r in records:
        if r["name"] in ("K2'", "K4'"):
            r["launches"] = counts[r["name"]]
        r["train_launches_per_step"] = per_step[r["name"]]
    profile_run("training step", lambda: step(batch), med)

    # overfit the fixed batch from the trained weights, lr 3e-4, wd 0
    del tx, step
    of_tx = make_domain_sliced_optimizer(model, 3e-4, weight_decay=0.0,
                                         stacked_mask=mask, num_domains=cfg.num_domains)
    of_step = make_train_step(model, of_tx)
    losses, accs = [], []
    for _ in range(OVERFIT_STEPS):
        m = of_step(batch)
        losses.append(m["loss"].item())
        accs.append(m["acc"].item())
    floor = smoothed_ce_floor(cfg.num_factored_vocabs, cfg.factored_vocab_size)
    print(f"  overfit {OVERFIT_STEPS} steps (lr 3e-4, wd 0): loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} (every 5th: {', '.join(f'{x:.3f}' for x in losses[::5])}), "
          f"acc {accs[-1]:.4f}, smoothing floor {floor:.4f}; must fall by "
          f">= {OVERFIT_MARGIN}", flush=True)
    require(all(math.isfinite(x) for x in losses), "overfit loss not finite")
    require(losses[-1] <= losses[0] - OVERFIT_MARGIN, "overfit loss did not fall")


def exactness_phase():
    """Phase 7: fp32 loss and gradients, kernels on the card vs plain on the CPU."""
    import torch

    from hma_tpu_torch.models.st_mask_git import STMaskGIT

    cfg = flagship_config(40)
    cfg.num_layers = 2
    card = STMaskGIT(cfg, dtype=torch.float32, device="cuda", remat=True,
                     generator=torch.Generator("cuda").manual_seed(3))
    host = STMaskGIT(cfg, dtype=torch.float32, device="cpu", remat=True)
    host.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    losses, grads = [], []
    reset_counts()
    for model, device in ((card, "cuda"), (host, "cpu")):
        b = train_batch(cfg, 2, device)
        loss = model(b["input_ids"], b["labels"], b["action_ids"], 0)["loss"]
        loss.backward()
        losses.append(loss.item())
        grads.append({n: p.grad.cpu() for n, p in model.named_parameters()
                      if p.grad is not None})
    counts = read_counts()
    require(all(counts.values()), f"the card's pass missed a kernel: {counts}")
    require(grads[0].keys() == grads[1].keys(), "gradient sets differ")
    loss_err = abs(losses[0] - losses[1]) / abs(losses[1])
    worst, worst_name = 0.0, ""
    for n, want in grads[1].items():
        scale = want.abs().max().item()
        err = (grads[0][n] - want).abs().max().item()
        ratio = err / scale if scale > 0 else (0.0 if err == 0 else math.inf)
        if ratio > worst:
            worst, worst_name = ratio, n
    print(f"  2-layer d256, B=2, fp32: loss card {losses[0]:.6f} cpu {losses[1]:.6f} "
          f"(rel err {loss_err:.3e}, tol 1e-5); {len(grads[1])} gradient tensors, "
          f"worst max|dg|/max|g| {worst:.3e} at {worst_name} (tol {GRAD_TOL}); "
          f"launches {counts}", flush=True)
    require(loss_err <= 1e-5, "card loss differs from the CPU's")
    require(worst <= GRAD_TOL, f"gradient {worst_name} differs: {worst:.3e}")


def train_entry_phase():
    """Phase 8: the train_multi CLI on the card, then generate from its
    checkpoint."""
    from hma_tpu_torch.train_multi import main as train_main

    cfg = flagship_config(1)
    cfg.num_layers = 2
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        data = tmp / "domain_0_magvit_max1000000_train"
        write_dataset(data, cfg, seed=4)
        cfg.save_pretrained(str(tmp / "config.json"))
        (tmp / "split.yaml").write_text("domains: domain_0\n")
        reset_counts()
        train_main(["--genie_config", str(tmp / "config.json"),
                    "--output_dir", str(tmp / "run"), "--train_split",
                    str(tmp / "split.yaml"), "--data_root", str(tmp),
                    "--window_size", str(cfg.T), "--per_device_train_batch_size", "2",
                    "--per_device_eval_batch_size", "2", "--max_train_steps", "4",
                    "--overfit_first_batch", "--checkpointing_steps", "2",
                    "--eval_every_n_steps", "4", "--max_eval_steps", "1",
                    "--log_every", "1", "--num_warmup_steps", "1",
                    "--learning_rate", "3e-4"])
        counts = read_counts()
        lines = [json.loads(l) for l in (tmp / "run" / "metrics.jsonl").read_text().splitlines()]
        losses = [l["train/loss"] for l in lines if "train/loss" in l]
        print(f"  train_multi CLI: {len(losses)} steps, losses "
              f"{', '.join(f'{x:.4f}' for x in losses)}; launches {counts}; "
              f"checkpoints {sorted(d.name for d in (tmp / 'run').iterdir() if d.is_dir())}",
              flush=True)
        require(len(losses) == 4 and all(math.isfinite(x) for x in losses),
                "train_multi losses")
        require(all(counts.values()), f"train_multi missed a kernel: {counts}")
        require((tmp / "run" / "final_checkpt" / "train_state.pt").is_file(),
                "no final checkpoint")
        check_generate(tmp / "run", data, tmp / "gen", cfg.T, cfg.S, cfg.image_vocab_size)


def main(argv=None) -> int:
    import argparse

    import torch

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--phases", default="1,2,3,4,5,6,7,8",
                   help="comma-separated phases to run (1 and 2 always run)")
    phases = {int(x) for x in p.parse_args(argv).phases.split(",")} | {1, 2}
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    card = nvidia_smi_line()
    print(f"[1] device: {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.device_count()} device(s)", flush=True)

    from hma_tpu_torch.ops import _build

    t0 = time.perf_counter()
    report = _build.build_all()
    print(f"[2] build: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, r in report.items():
        print(f"  {name}.cu: {r['seconds']:.1f} s\n{r['log']}", flush=True)

    records = []
    steps = [(3, "kernels vs plain versions", lambda: records.extend(kernel_phase())),
             (4, "rollouts, d256 card", lambda: main_path_phase(records)),
             (5, "entry point: generate", entry_point_phase),
             (6, "training step, d256 card", lambda: training_phase(records)),
             (7, "gradient exactness, card vs CPU", exactness_phase),
             (8, "entry point: train_multi, then generate", train_entry_phase)]
    for n, title, run in steps:
        if n in phases:
            t0 = time.perf_counter()
            print(f"[{n}] {title}", flush=True)
            run()
            print(f"  phase {n}: {time.perf_counter() - t0:.1f} s", flush=True)

    if {3, 4, 6} <= phases:  # every kernel of the main paths was launched
        for r in records:
            require(r["launches"], f"{r['name']} {r['shape']} never launched")
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
