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
// Design (see hma_tpu_torch/ops/temporal_attention.py for the reasoning),
// mirroring K3': one warp per (site, head), lanes over D (D / 32 values each).
// The warp loads q, k, v and dout of all T <= MAX_T frames into registers with
// coalesced D-contiguous reads; out is only read once to form delta[t] (a
// warp-shuffle sum), so it is never held. For each query frame t the warp walks
// s <= t: two warp-shuffle dot products (q.k and dout.v) per pair, dq[t] in a
// local accumulator written at the end of t, dk[s] and dv[s] in registers
// until the end. Pairs s > t are never computed.
//
// C entry point: hma_temporal_attention_bwd, returns cudaGetLastError().

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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

struct Strides {  // (site, frame, head) strides in elements
  long long n, t, h;
};

template <typename T, int D>
__global__ void __launch_bounds__(WARPS * 32)
temporal_attention_bwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ out, const float* __restrict__ lse, const T* __restrict__ dout,
    T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv, int N, int T_len, int H,
    Strides sq, Strides sk, Strides sv, Strides so, Strides sd) {
  constexpr int E = D / 32;  // values per lane
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= (long long)N * H) return;  // whole warps leave together
  const long long n = warp / H;
  const int h = (int)(warp % H);

  float qr[MAX_T][E], kr[MAX_T][E], vr[MAX_T][E], dr[MAX_T][E];
  float dka[MAX_T][E], dva[MAX_T][E];
  float delta[MAX_T], lr[MAX_T];
#pragma unroll
  for (int t = 0; t < MAX_T; ++t) {
    if (t < T_len) {
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int d = lane + 32 * e;
        qr[t][e] = to_f(q[n * sq.n + t * sq.t + h * sq.h + d]);
        kr[t][e] = to_f(k[n * sk.n + t * sk.t + h * sk.h + d]);
        vr[t][e] = to_f(v[n * sv.n + t * sv.t + h * sv.h + d]);
        dr[t][e] = to_f(dout[n * sd.n + t * sd.t + h * sd.h + d]);
        part = fmaf(dr[t][e], to_f(out[n * so.n + t * so.t + h * so.h + d]), part);
        dka[t][e] = 0.f;
        dva[t][e] = 0.f;
      }
      delta[t] = warp_sum(part);
      lr[t] = lse[(n * H + h) * T_len + t];
    }
  }

#pragma unroll
  for (int t = 0; t < MAX_T; ++t) {
    if (t >= T_len) break;
    float dqa[E];
#pragma unroll
    for (int e = 0; e < E; ++e) dqa[e] = 0.f;
#pragma unroll
    for (int s = 0; s <= t; ++s) {
      float qk = 0.f, dp = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        qk = fmaf(qr[t][e], kr[s][e], qk);
        dp = fmaf(dr[t][e], vr[s][e], dp);
      }
      const float p = expf(warp_sum(qk) - lr[t]);
      const float ds = p * (warp_sum(dp) - delta[t]);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        dqa[e] = fmaf(ds, kr[s][e], dqa[e]);
        dka[s][e] = fmaf(ds, qr[t][e], dka[s][e]);
        dva[s][e] = fmaf(p, dr[t][e], dva[s][e]);
      }
    }
    T* row = dq + ((n * T_len + t) * H + h) * D;
#pragma unroll
    for (int e = 0; e < E; ++e) row[lane + 32 * e] = from_f<T>(dqa[e]);
  }

#pragma unroll
  for (int t = 0; t < MAX_T; ++t) {
    if (t >= T_len) break;
    const long long o = ((n * T_len + t) * H + h) * D;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      dk[o + lane + 32 * e] = from_f<T>(dka[t][e]);
      dv[o + lane + 32 * e] = from_f<T>(dva[t][e]);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* out,
                   const void* lse, const void* dout, void* dq, void* dk, void* dv,
                   int N, int T_len, int H, const long long* st, cudaStream_t stream) {
  const long long warps = (long long)N * H;
  const unsigned blocks = (unsigned)((warps + WARPS - 1) / WARPS);
  temporal_attention_bwd_kernel<T, D><<<blocks, WARPS * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(out), static_cast<const float*>(lse),
      static_cast<const T*>(dout), static_cast<T*>(dq), static_cast<T*>(dk),
      static_cast<T*>(dv), N, T_len, H, Strides{st[0], st[1], st[2]},
      Strides{st[3], st[4], st[5]}, Strides{st[6], st[7], st[8]},
      Strides{st[9], st[10], st[11]}, Strides{st[12], st[13], st[14]});
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, (site, frame,
// head) for q, k, v, out, dout in that order. delta is unused (the spatial
// backward's scratch; the temporal kernel keeps delta in registers).
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
  const long long st[15] = {q_sn, q_st, q_sh, k_sn, k_st, k_sh, v_sn, v_st, v_sh,
                            o_sn, o_st, o_sh, d_sn, d_st, d_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 0 || H <= 0 || T_len <= 0 || T_len > MAX_T) return (int)cudaErrorInvalidValue;
#define HMA_LAUNCH(T, DD) \
  launch<T, DD>(q, k, v, out, lse, dout, dq, dk, dv, N, T_len, H, st, s)
  if (dtype == 0 && D == 32) return (int)HMA_LAUNCH(float, 32);
  if (dtype == 0 && D == 64) return (int)HMA_LAUNCH(float, 64);
  if (dtype == 1 && D == 32) return (int)HMA_LAUNCH(__nv_bfloat16, 32);
  if (dtype == 1 && D == 64) return (int)HMA_LAUNCH(__nv_bfloat16, 64);
#undef HMA_LAUNCH
  return (int)cudaErrorInvalidValue;
}
