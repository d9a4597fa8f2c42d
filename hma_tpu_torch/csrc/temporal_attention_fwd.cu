// K3': causal tiny-T temporal attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel hma_tpu/ops/temporal_attention.py:_fwd_kernel.
// At each of N sites and for each head: out[t] = sum_{s<=t} p[t,s] v[s] with
// p = softmax over s <= t of q[t].k[s] (q pre-scaled), and the fp32 lse[t].
// Layout (N, T, H, D) with the strides of the first three axes passed in and
// a unit stride on D; out is written contiguous (N, T, H, D), lse as (N, H, T).
//
// The body (a thread per query row (site, head, frame), as the TPU kernel puts
// sites over lanes; a tile of (site, head) rows with all their frames staged
// into shared memory by 16-byte cp.async; fp32 softmax and p v in the thread,
// only out rounded) is `hma_temporal::fwd_kernel` in temporal_attention.cuh,
// which K5' shares; here the sites are one axis (S = 1). At D 16, 32 and 64
// rows must start 16-byte aligned; any other D up to 64 takes the ragged path
// (each row's covering 16-byte-aligned chunks copied, then shifted into place
// and zero-padded in shared memory). See hma_tpu_torch/ops/temporal_attention.py
// for the reasoning.
//
// C entry point: hma_temporal_attention_fwd, returns cudaGetLastError().

#include "temporal_attention.cuh"

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements.
extern "C" int hma_temporal_attention_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse,
    int N, int T_len, int H, int D, int dtype,
    long long q_sn, long long q_st, long long q_sh,
    long long k_sn, long long k_st, long long k_sh,
    long long v_sn, long long v_st, long long v_sh, void* stream) {
  using hma_temporal::Map;
  return hma_temporal::launch_fwd(
      q, k, v, out, lse, N, 1, T_len, H, D, dtype, Map{q_sn, q_st, 0, q_sh},
      Map{k_sn, k_st, 0, k_sh}, Map{v_sn, v_st, 0, v_sh},
      static_cast<cudaStream_t>(stream));
}
