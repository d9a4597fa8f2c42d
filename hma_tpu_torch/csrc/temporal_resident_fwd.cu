// K5' forward: causal tiny-T temporal attention in the resident layout, for
// Hopper (sm_90a).
//
// Replaces the forward of the Pallas TPU kernel entry
// hma_tpu/ops/temporal_attention.py:fused_temporal_attention_kl (its
// _vjp_fwd_kl), which the resident ST block (temporal_layout="resident")
// feeds in the TPU's sites-on-lanes (H, T, D, N) layout. The kernel keeps the
// sites spread over threads (temporal_attention.cuh) but reads q, k, v where
// the qkv projection of the (B, T, S, C) residual stream leaves them: (B, T, S, H, D)
// views of the (B, T, S, 3, H, D) projection, in which the site n = b S + s
// has one stride for b and another for s, with the frame axis between them.
// Each tensor's four strides (b, t, s, h) are passed in (unit stride on D);
// out is written contiguous (B, T, S, H, D), which is the (B, T, S, C) that
// the output projection reads, and lse as (B*S, H, T) fp32.
//
// What it computes is what K3' computes, with the same body
// (`hma_temporal::fwd_kernel`, temporal_attention.cuh; only the strides of the
// row copies differ), so the two agree bit for bit on the same values. At D
// 16, 32 and 64 rows must start 16-byte aligned (any other D up to 64 takes
// the ragged path). Bound by bytes: at the d512 card's
// (8, 12, 128, 8, 64) in bf16 it reads q, k, v and writes out, 50 MB (~15 us at
// 3.35 TB/s).
//
// C entry point: hma_temporal_resident_fwd, returns cudaGetLastError().

#include "temporal_attention.cuh"

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, (b, t, s, h) for
// q, k, v in that order.
extern "C" int hma_temporal_resident_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse,
    int B, int T_len, int S, int H, int D, int dtype,
    long long q_sb, long long q_st, long long q_ss, long long q_sh,
    long long k_sb, long long k_st, long long k_ss, long long k_sh,
    long long v_sb, long long v_st, long long v_ss, long long v_sh, void* stream) {
  using hma_temporal::Map;
  if (B <= 0) return (int)cudaErrorInvalidValue;
  return hma_temporal::launch_fwd(
      q, k, v, out, lse, (long long)B * S, S, T_len, H, D, dtype,
      Map{q_sb, q_st, q_ss, q_sh}, Map{k_sb, k_st, k_ss, k_sh},
      Map{v_sb, v_st, v_ss, v_sh}, static_cast<cudaStream_t>(stream));
}
