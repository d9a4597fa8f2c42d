// The warp-per-(site, head) bodies of the causal tiny-T temporal attention
// kernels, shared by K3'/K4' (temporal_attention_{fwd,bwd}.cu, sites in one
// (N, T, H, D) axis) and K5' (temporal_resident_{fwd,bwd}.cu, sites split into
// (B, S) around the frame axis). Both compute the same thing, instruction for
// instruction: only where a row of q, k, v, out or dout starts differs, which
// each tensor's `Map` states.
//
// Numerics (the TPU kernels' own, hma_tpu/ops/temporal_attention.py): every
// intermediate in fp32 (scores, softmax statistics and probs, dp, delta, ds,
// accumulators); only out, dq, dk, dv are rounded to the compute dtype.
//
// Design: one warp per (site, head), lanes over D (D / 32 values each). The
// warp loads q, k, v (and dout) of all T <= MAX_T frames into registers with
// coalesced D-contiguous reads, so no layout ever needs a transpose; causal
// pairs s > t are never computed. Bound by bytes (see the entry files).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace hma_temporal {

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

// Where the D-long row of (site n = b * S + s, frame t, head h) starts, in
// elements: b * b_ + t * t_ + s * s_ + h * h_. (N, T, H, D) tensors use S = 1,
// s_ = 0 and b_ = the site stride.
struct Map {
  long long b_, t_, s_, h_;
  __device__ __forceinline__ long long at(long long b, int t, long long s, int h) const {
    return b * b_ + t * t_ + s * s_ + h * h_;
  }
};

// out (written contiguous as (B, T, S, H, D)) and the fp32 lse ((B*S, H, T)).
template <typename T, int D>
__global__ void __launch_bounds__(WARPS * 32)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           T* __restrict__ out, float* __restrict__ lse, long long N, int S, int T_len,
           int H, Map mq, Map mk, Map mv) {
  constexpr int E = D / 32;  // values per lane
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= N * H) return;  // whole warps leave together
  const long long n = warp / H;
  const int h = (int)(warp % H);
  const long long b = n / S, s = n % S;

  float qr[MAX_T][E], kr[MAX_T][E], vr[MAX_T][E];
#pragma unroll
  for (int t = 0; t < MAX_T; ++t) {
    if (t < T_len) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int d = lane + 32 * e;
        qr[t][e] = to_f(q[mq.at(b, t, s, h) + d]);
        kr[t][e] = to_f(k[mk.at(b, t, s, h) + d]);
        vr[t][e] = to_f(v[mv.at(b, t, s, h) + d]);
      }
    }
  }

#pragma unroll
  for (int t = 0; t < MAX_T; ++t) {
    if (t >= T_len) break;
    float sc[MAX_T];
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j <= t; ++j) {
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) part = fmaf(qr[t][e], kr[j][e], part);
      sc[j] = warp_sum(part);
      m = fmaxf(m, sc[j]);
    }
    float l = 0.f;
#pragma unroll
    for (int j = 0; j <= t; ++j) l += expf(sc[j] - m);
    float acc[E];
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = 0.f;
#pragma unroll
    for (int j = 0; j <= t; ++j) {
      const float p = expf(sc[j] - m) / l;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = fmaf(p, vr[j][e], acc[e]);
    }
    T* orow = out + (((b * T_len + t) * S + s) * H + h) * D;
#pragma unroll
    for (int e = 0; e < E; ++e) orow[lane + 32 * e] = from_f<T>(acc[e]);
    if (lane == 0) lse[(n * H + h) * T_len + t] = m + logf(l);
  }
}

// dq, dk, dv: the row of (b, t, s) starts at ((b * T + t) * S + s) * g_row + h * D
// of its own pointer; g_row = H * D for three contiguous (B, T, S, H, D)
// tensors, 3 * H * D for the three slots of one (B, T, S, 3, H, D) buffer.
template <typename T, int D>
__global__ void __launch_bounds__(WARPS * 32)
bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const T* __restrict__ out, const float* __restrict__ lse,
           const T* __restrict__ dout, T* __restrict__ dq, T* __restrict__ dk,
           T* __restrict__ dv, long long N, int S, int T_len, int H, Map mq, Map mk,
           Map mv, Map mo, Map md, long long g_row) {
  constexpr int E = D / 32;  // values per lane
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= N * H) return;  // whole warps leave together
  const long long n = warp / H;
  const int h = (int)(warp % H);
  const long long b = n / S, s = n % S;

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
        qr[t][e] = to_f(q[mq.at(b, t, s, h) + d]);
        kr[t][e] = to_f(k[mk.at(b, t, s, h) + d]);
        vr[t][e] = to_f(v[mv.at(b, t, s, h) + d]);
        dr[t][e] = to_f(dout[md.at(b, t, s, h) + d]);
        part = fmaf(dr[t][e], to_f(out[mo.at(b, t, s, h) + d]), part);
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
    for (int j = 0; j <= t; ++j) {
      float qk = 0.f, dp = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        qk = fmaf(qr[t][e], kr[j][e], qk);
        dp = fmaf(dr[t][e], vr[j][e], dp);
      }
      const float p = expf(warp_sum(qk) - lr[t]);
      const float ds = p * (warp_sum(dp) - delta[t]);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        dqa[e] = fmaf(ds, kr[j][e], dqa[e]);
        dka[j][e] = fmaf(ds, qr[t][e], dka[j][e]);
        dva[j][e] = fmaf(p, dr[t][e], dva[j][e]);
      }
    }
    T* row = dq + ((b * T_len + t) * S + s) * g_row + h * D;
#pragma unroll
    for (int e = 0; e < E; ++e) row[lane + 32 * e] = from_f<T>(dqa[e]);
  }

#pragma unroll
  for (int t = 0; t < MAX_T; ++t) {
    if (t >= T_len) break;
    const long long o = ((b * T_len + t) * S + s) * g_row + h * D;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      dk[o + lane + 32 * e] = from_f<T>(dka[t][e]);
      dv[o + lane + 32 * e] = from_f<T>(dva[t][e]);
    }
  }
}

inline unsigned blocks_for(long long N, int H) {
  return (unsigned)((N * H + WARPS - 1) / WARPS);
}

// Launch the forward for dtype 0 (float32) or 1 (bfloat16) and D 32 or 64;
// returns cudaGetLastError(), or cudaErrorInvalidValue for anything else.
inline int launch_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                      long long N, int S, int T_len, int H, int D, int dtype, Map mq,
                      Map mk, Map mv, cudaStream_t stream) {
  if (N <= 0 || S <= 0 || H <= 0 || T_len <= 0 || T_len > MAX_T)
    return (int)cudaErrorInvalidValue;
#define HMA_FWD(TT, DD)                                                          \
  fwd_kernel<TT, DD><<<blocks_for(N, H), WARPS * 32, 0, stream>>>(               \
      static_cast<const TT*>(q), static_cast<const TT*>(k),                      \
      static_cast<const TT*>(v), static_cast<TT*>(out), static_cast<float*>(lse), \
      N, S, T_len, H, mq, mk, mv)
  if (dtype == 0 && D == 32) HMA_FWD(float, 32);
  else if (dtype == 0 && D == 64) HMA_FWD(float, 64);
  else if (dtype == 1 && D == 32) HMA_FWD(__nv_bfloat16, 32);
  else if (dtype == 1 && D == 64) HMA_FWD(__nv_bfloat16, 64);
  else return (int)cudaErrorInvalidValue;
#undef HMA_FWD
  return (int)cudaGetLastError();
}

inline int launch_bwd(const void* q, const void* k, const void* v, const void* out,
                      const void* lse, const void* dout, void* dq, void* dk, void* dv,
                      long long N, int S, int T_len, int H, int D, int dtype, Map mq,
                      Map mk, Map mv, Map mo, Map md, long long g_row,
                      cudaStream_t stream) {
  if (N <= 0 || S <= 0 || H <= 0 || T_len <= 0 || T_len > MAX_T)
    return (int)cudaErrorInvalidValue;
#define HMA_BWD(TT, DD)                                                             \
  bwd_kernel<TT, DD><<<blocks_for(N, H), WARPS * 32, 0, stream>>>(                  \
      static_cast<const TT*>(q), static_cast<const TT*>(k),                         \
      static_cast<const TT*>(v), static_cast<const TT*>(out),                       \
      static_cast<const float*>(lse), static_cast<const TT*>(dout),                 \
      static_cast<TT*>(dq), static_cast<TT*>(dk), static_cast<TT*>(dv), N, S,       \
      T_len, H, mq, mk, mv, mo, md, g_row)
  if (dtype == 0 && D == 32) HMA_BWD(float, 32);
  else if (dtype == 0 && D == 64) HMA_BWD(float, 64);
  else if (dtype == 1 && D == 32) HMA_BWD(__nv_bfloat16, 32);
  else if (dtype == 1 && D == 64) HMA_BWD(__nv_bfloat16, 64);
  else return (int)cudaErrorInvalidValue;
#undef HMA_BWD
  return (int)cudaGetLastError();
}

}  // namespace hma_temporal
