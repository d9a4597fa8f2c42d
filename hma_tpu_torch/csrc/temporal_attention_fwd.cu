// K3': causal tiny-T temporal attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel hma_tpu/ops/temporal_attention.py:_fwd_kernel.
// At each of N sites and for each head: out[t] = sum_{s<=t} p[t,s] v[s] with
// p = softmax over s <= t of q[t].k[s] (q pre-scaled), and the fp32 lse[t].
// Layout (N, T, H, D) with the strides of the first three axes passed in and
// a unit stride on D; out is written contiguous (N, T, H, D), lse as (N, H, T).
//
// Design (see hma_tpu_torch/ops/temporal_attention.py for the reasoning):
// one warp per (site, head), lanes over D (D / 32 values each). The warp
// loads q, k, v of all T <= MAX_T frames into registers with coalesced
// D-contiguous reads, then for each query frame t forms the t + 1 causal
// scores with warp-shuffle sums, the fp32 softmax statistics, the probs
// rounded to the compute dtype, and p v. Pairs s > t are never computed.
//
// C entry point: hma_temporal_attention_fwd, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAX_T = 16;
constexpr int WARPS = 8;  // warps per block

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(WARPS * 32)
temporal_attention_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, float* __restrict__ lse, int N, int T_len, int H,
    long long q_sn, long long q_st, long long q_sh,
    long long k_sn, long long k_st, long long k_sh,
    long long v_sn, long long v_st, long long v_sh) {
  constexpr int E = D / 32;  // values per lane
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= (long long)N * H) return;  // whole warps leave together
  const long long n = warp / H;
  const int h = (int)(warp % H);

  float qr[MAX_T][E], kr[MAX_T][E], vr[MAX_T][E];
#pragma unroll
  for (int t = 0; t < MAX_T; ++t) {
    if (t < T_len) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int d = lane + 32 * e;
        qr[t][e] = to_f(q[n * q_sn + t * q_st + h * q_sh + d]);
        kr[t][e] = to_f(k[n * k_sn + t * k_st + h * k_sh + d]);
        vr[t][e] = to_f(v[n * v_sn + t * v_st + h * v_sh + d]);
      }
    }
  }

#pragma unroll
  for (int t = 0; t < MAX_T; ++t) {
    if (t >= T_len) break;
    float sc[MAX_T];
    float m = -INFINITY;
#pragma unroll
    for (int s = 0; s <= t; ++s) {
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) part = fmaf(qr[t][e], kr[s][e], part);
      sc[s] = warp_sum(part);
      m = fmaxf(m, sc[s]);
    }
    float l = 0.f;
#pragma unroll
    for (int s = 0; s <= t; ++s) l += expf(sc[s] - m);
    float acc[E];
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = 0.f;
#pragma unroll
    for (int s = 0; s <= t; ++s) {
      const float p = round_to<T>(expf(sc[s] - m) / l);
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = fmaf(p, vr[s][e], acc[e]);
    }
    T* orow = out + ((n * T_len + t) * H + h) * D;
#pragma unroll
    for (int e = 0; e < E; ++e) orow[lane + 32 * e] = from_f<T>(acc[e]);
    if (lane == 0) lse[(n * H + h) * T_len + t] = m + logf(l);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, void* lse,
                   int N, int T_len, int H, const long long* st, cudaStream_t stream) {
  const long long warps = (long long)N * H;
  const unsigned blocks = (unsigned)((warps + WARPS - 1) / WARPS);
  temporal_attention_fwd_kernel<T, D><<<blocks, WARPS * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(lse), N, T_len, H,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8]);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements.
extern "C" int hma_temporal_attention_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse,
    int N, int T_len, int H, int D, int dtype,
    long long q_sn, long long q_st, long long q_sh,
    long long k_sn, long long k_st, long long k_sh,
    long long v_sn, long long v_st, long long v_sh, void* stream) {
  const long long st[9] = {q_sn, q_st, q_sh, k_sn, k_st, k_sh, v_sn, v_st, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 0 || H <= 0 || T_len <= 0 || T_len > MAX_T) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && D == 32) return (int)launch<float, 32>(q, k, v, out, lse, N, T_len, H, st, s);
  if (dtype == 0 && D == 64) return (int)launch<float, 64>(q, k, v, out, lse, N, T_len, H, st, s);
  if (dtype == 1 && D == 32)
    return (int)launch<__nv_bfloat16, 32>(q, k, v, out, lse, N, T_len, H, st, s);
  if (dtype == 1 && D == 64)
    return (int)launch<__nv_bfloat16, 64>(q, k, v, out, lse, N, T_len, H, st, s);
  return (int)cudaErrorInvalidValue;
}
