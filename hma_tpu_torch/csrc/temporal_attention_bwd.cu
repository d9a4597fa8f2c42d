// K4': causal tiny-T temporal attention backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel hma_tpu/ops/temporal_attention.py:_bwd_kernel.
// At each of N sites and for each head, from the forward's out and fp32 lse,
// over the causal pairs s <= t only:
//   p[t,s]  = exp(q[t].k[s] - lse[t]),  dp[t,s] = dout[t].v[s]
//   delta[t] = dout[t].out[t],  ds[t,s] = p[t,s] (dp[t,s] - delta[t])
//   dq[t] = sum_s ds[t,s] k[s],  dk[s] = sum_t ds[t,s] q[t],  dv[s] = sum_t p[t,s] dout[t]
// Every intermediate is fp32 (nothing is rounded to the compute dtype before
// the outputs), exactly the TPU kernel's numerics; dq, dk, dv are written in
// the compute dtype. Layout (N, T, H, D) for q, k, v, out and dout with the
// strides of the first three axes passed in and a unit stride on D; lse is
// (N, H, T) fp32; dq, dk, dv are written contiguous (N, T, H, D).
//
// The body (a tile of (site, head) rows with all their frames staged into
// shared memory by 16-byte cp.async; phase (a), a thread per (row, t): delta,
// p and ds of its causal row into shared memory in fp32, and dq; phase (b),
// after a barrier, a thread per (row, j): dk and dv; no atomics, one exp a
// pair) is `hma_temporal::bwd_kernel` in temporal_attention.cuh, which K5'
// shares; here the sites are one axis (S = 1). At D 16, 32 and 64 rows must
// start 16-byte aligned; any other D up to 64 takes the ragged path (each
// row's covering 16-byte-aligned chunks copied, then shifted into place and
// zero-padded in shared memory). See hma_tpu_torch/ops/temporal_attention.py
// for the reasoning.
//
// C entry point: hma_temporal_attention_bwd, returns cudaGetLastError().

#include "temporal_attention.cuh"

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, (site, frame,
// head) for q, k, v, out, dout in that order. delta is unused (the spatial
// backward's scratch; the temporal kernel keeps delta in a register).
extern "C" int hma_temporal_attention_bwd(
    const void* q, const void* k, const void* v, const void* out, const void* lse,
    const void* dout, void* dq, void* dk, void* dv, void* delta,
    int N, int T_len, int H, int D, int dtype,
    long long q_sn, long long q_st, long long q_sh,
    long long k_sn, long long k_st, long long k_sh,
    long long v_sn, long long v_st, long long v_sh,
    long long o_sn, long long o_st, long long o_sh,
    long long d_sn, long long d_st, long long d_sh, void* stream) {
  (void)delta;
  using hma_temporal::Map;
  return hma_temporal::launch_bwd(
      q, k, v, out, lse, dout, dq, dk, dv, N, 1, T_len, H, D, dtype,
      Map{q_sn, q_st, 0, q_sh}, Map{k_sn, k_st, 0, k_sh}, Map{v_sn, v_st, 0, v_sh},
      Map{o_sn, o_st, 0, o_sh}, Map{d_sn, d_st, 0, d_sh}, (long long)H * D,
      static_cast<cudaStream_t>(stream));
}
