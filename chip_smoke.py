#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (hma_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each failing the run on any error:
  1. device: the card's name and power limit (nvidia-smi), the device count;
  2. build: both CUDA kernels from hma_tpu_torch/csrc with nvcc, with the
     build time and what `-Xptxas -v` reports;
  3. kernels: K1' (spatial attention) and K3' (temporal attention) against
     their plain PyTorch versions at the main path's shapes and one ragged
     shape each, out and lse. fp32: atol = rtol = 1e-5. bf16: lse to 1e-5,
     out to a limit per kernel (BF16_TOL) and to at most 1 % of outputs
     that differ from the plain version at all; a negative control, the
     plain version without the bf16 rounding of the probs before p v, must
     exceed that share. Then kernel, plain and library (SDPA, a yardstick
     only: the port never calls it) times with CUDA events;
  4. main path at full width: the d256 card (32 layers, d 256, T 12,
     S 256 + 64 action tokens, 2 x 512 vocab) with the 40-domain synthetic
     action fields and random weights from seed 0. The cached per-frame
     forward is held to the full forward in fp32 at B = 1 (EXACT_TOL), and
     two planted cache faults must exceed that limit; then the
     KV-cached rollout and the full-recompute rollout run at B = 8, 2 prompt
     frames, 2 MaskGIT steps, bf16, temperature 0, with the kernels' launch
     counts set to 0 just before each and read just after;
  5. entry point: `hma_tpu_torch.generate.main` on a synthetic dataset and a
     2-layer d256 checkpoint written to a temporary directory.

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


def check_kernel(kernel, plain, args, tol, label):
    """Hold kernel(*args) to plain(*args); returns max |out - plain|. In
    bf16 also the share of outputs that differ, beside that of the plain
    version computed without rounding the probs (the negative control)."""
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
        unrounded = plain(*(a.float() if torch.is_tensor(a) else a
                            for a in args))[0].to(out.dtype)
        share = (out != want).float().mean().item()
        ctl_share = (unrounded != want).float().mean().item()
        ctl_err = (unrounded.float() - want.float()).abs().max().item()
        line += (f"  differ {share:.4%} (limit {MISMATCH_LIMIT:.0%}); "
                 f"unrounded probs: differ {ctl_share:.4%}, max err {ctl_err:.3e}")
        require(share <= MISMATCH_LIMIT, f"{label}: {share:.4%} of outputs differ")
        require(ctl_share > MISMATCH_LIMIT,
                f"{label}: the check cannot tell unrounded probs apart")
    print(line, flush=True)
    return err


def kernel_phase():
    """Phase 3: correctness at every shape, times at the main-path shapes."""
    import torch
    from torch.nn import functional as F

    from hma_tpu_torch.ops.fused_attention import fused_attention, fused_attention_plain
    from hma_tpu_torch.ops.temporal_attention import (
        fused_temporal_attention, fused_temporal_attention_plain)

    records = []
    spatial = [((8, 320, 8, 32), False, True), ((96, 320, 8, 32), False, True),
               ((3, 77, 4, 64), True, False)]
    temporal = [((2560, 12, 8, 32), True), ((1000, 5, 3, 64), False)]
    cases = ([("K1'", s, c, main, fused_attention, fused_attention_plain)
              for s, c, main in spatial]
             + [("K3'", s, True, main, fused_temporal_attention,
                 fused_temporal_attention_plain) for s, main in temporal])
    for name, shape, causal, main, kernel, plain in cases:
        lead, H, D = shape[:2], shape[2], shape[3]
        extra = (causal,) if name == "K1'" else ()
        errs = {}
        for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL[name])):
            q, k, v = strided_qkv(lead, H, D, dtype, seed=len(records))
            errs[dtype] = check_kernel(kernel, plain, (q, k, v, *extra), tol,
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
        t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / BF16_FLOP_PER_S * 1e3
        src = {"K1'": ("fused_attention_fwd", "hma_tpu/ops/fused_attention.py:54"),
               "K3'": ("temporal_attention_fwd", "hma_tpu/ops/temporal_attention.py:36")}
        records.append({
            "name": name, "shape": list(shape), "dtype": "bf16",
            "route": "cuda", "source": f"hma_tpu_torch/csrc/{src[name][0]}.cu",
            "replaces": src[name][1], "launches": None,
            "max_abs_err": errs[torch.bfloat16], "max_err": errs[torch.bfloat16],
            "max_abs_err_fp32": errs[torch.float32],
            "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms})
        print(f"  {name} {shape} bf16: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
              f"sdpa {library_ms:.4f} ms  bound {max(t_bytes, t_ops):.4f} ms",
              flush=True)
    return records


def profile_rollout(label, go, secs):
    """One more rollout under torch.profiler: device-busy share and the
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
        print(f"  {label} rollout profile: the profiler saw no device time",
              flush=True)
        return
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    print(f"  {label} rollout profile: device busy {busy_ms:.2f} ms, "
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
        profile_rollout(label, go, sorted(secs)[len(secs) // 2])
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
        else:
            r["launches"] = f_k3
        require(r["launches"] > 0, f"{r['name']} {r['shape']} never launched")
    print(f"  peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    return cfg


def entry_point_phase(cfg):
    """Phase 5: the generate CLI on a 2-layer d256 checkpoint."""
    import torch

    from hma_tpu_torch.data.datasets import write_token_dataset
    from hma_tpu_torch.generate import main as generate_main
    from hma_tpu_torch.models.st_mask_git import STMaskGIT
    from hma_tpu_torch.ops.fused_attention import fused_attention
    from hma_tpu_torch.utils.checkpoint import save_checkpoint

    cfg.num_layers = 2
    model = STMaskGIT(cfg, device="cuda",
                      generator=torch.Generator("cuda").manual_seed(2))
    rng = np.random.default_rng(2)
    with tempfile.TemporaryDirectory() as tmp:
        n, side = 40, math.isqrt(cfg.S)
        write_token_dataset(
            Path(tmp) / "data",
            rng.integers(0, cfg.image_vocab_size, (n, side, side)).astype(np.uint32),
            np.repeat(np.arange(n // 20), 20),
            rng.normal(size=(n, cfg.d_actions[0])).astype(np.float32),
            {"name": "domain_0", "vocab_size": cfg.image_vocab_size})
        save_checkpoint(str(Path(tmp) / "ckpt"), model.state_dict(), cfg)
        fused_attention.launches = 0
        generate_main(["--checkpoint_dir", str(Path(tmp) / "ckpt"),
                       "--val_data_dir", str(Path(tmp) / "data"),
                       "--output_dir", str(Path(tmp) / "out"),
                       "--batch_size", "2", "--num_prompt_frames", "2",
                       "--device", "cuda"])
        meta = json.loads((Path(tmp) / "out" / "metadata.json").read_text())
        video = np.fromfile(Path(tmp) / "out" / "video.bin", dtype=np.uint32)
    require(meta["num_images"] == 2 * (2 * cfg.T - 2), f"metadata {meta}")
    require(video.size == meta["num_images"] * cfg.S, "video.bin size")
    require(int(video.max()) < cfg.image_vocab_size, "video.bin token range")
    require(fused_attention.launches > 0, "generate CLI did not launch K1'")
    print(f"  generate CLI: {meta['num_images']} frames written, "
          f"K1' launches {fused_attention.launches}", flush=True)


def main() -> int:
    import torch

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

    print("[3] kernels vs plain versions", flush=True)
    records = kernel_phase()
    print("[4] main path, d256 card", flush=True)
    cfg = main_path_phase(records)
    print("[5] entry point", flush=True)
    entry_point_phase(cfg)

    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
