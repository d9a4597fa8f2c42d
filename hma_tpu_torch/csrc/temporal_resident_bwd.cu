// K5' backward: causal tiny-T temporal attention in the resident layout, for
// Hopper (sm_90a).
//
// Replaces the backward of the Pallas TPU kernel entry
// hma_tpu/ops/temporal_attention.py:fused_temporal_attention_kl (its
// _vjp_bwd_kl). It reads q, k, v, out and dout with four strides each
// (b, t, s, h; unit stride on D), lse as (B*S, H, T) fp32 from K5''s forward,
// and writes dq, dk and dv into the three slots of ONE contiguous
// (B, T, S, 3, H, D) buffer, the layout of the qkv projection's output, so
// that projection's backward gets its gradient as one tensor with no copy.
//
// What it computes is what K4' computes, with the same body
// (`hma_temporal::bwd_kernel`, temporal_attention.cuh; only the strides of the
// row copies differ): all fp32 inside, only dq, dk, dv rounded. At D 16, 32
// and 64 rows must start 16-byte aligned (any other D up to 64 takes the
// ragged path). Bound by bytes: at (8, 12, 128, 8, 64) in bf16 it
// reads q, k, v, out, dout and writes dq, dk, dv, 101 MB (~30 us at 3.35 TB/s).
//
// C entry point: hma_temporal_resident_bwd, returns cudaGetLastError().

#include "temporal_attention.cuh"

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, (b, t, s, h) for
// q, k, v, out, dout in that order. dqkv: (B, T, S, 3, H, D) contiguous.
extern "C" int hma_temporal_resident_bwd(
    const void* q, const void* k, const void* v, const void* out, const void* lse,
    const void* dout, void* dqkv,
    int B, int T_len, int S, int H, int D, int dtype,
    long long q_sb, long long q_st, long long q_ss, long long q_sh,
    long long k_sb, long long k_st, long long k_ss, long long k_sh,
    long long v_sb, long long v_st, long long v_ss, long long v_sh,
    long long o_sb, long long o_st, long long o_ss, long long o_sh,
    long long d_sb, long long d_st, long long d_ss, long long d_sh, void* stream) {
  using hma_temporal::Map;
  if (B <= 0 || D <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const size_t slot = (size_t)H * D * (dtype == 0 ? sizeof(float) : sizeof(__nv_bfloat16));
  char* base = static_cast<char*>(dqkv);
  return hma_temporal::launch_bwd(
      q, k, v, out, lse, dout, base, base + slot, base + 2 * slot, (long long)B * S, S,
      T_len, H, D, dtype, Map{q_sb, q_st, q_ss, q_sh}, Map{k_sb, k_st, k_ss, k_sh},
      Map{v_sb, v_st, v_ss, v_sh}, Map{o_sb, o_st, o_ss, o_sh},
      Map{d_sb, d_st, d_ss, d_sh}, 3LL * H * D, static_cast<cudaStream_t>(stream));
}
