// K1': whole-block softmax attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel hma_tpu/ops/fused_attention.py:_fwd_kernel.
// For each (batch b, head h): out = softmax(q k^T [causal]) v, q pre-scaled,
// and lse = the fp32 row log-sum-exp. Layout (B, S, H, D) with the strides of
// the first three axes passed in and a unit stride on D; out is written
// contiguous (B, S, H, D), lse as (B, H, S).
//
// Design (see hma_tpu_torch/ops/fused_attention.py for the reasoning):
//   grid (ceil(S / ROWS), H, B), one thread per query row. Each thread keeps
//   its q row and fp32 output accumulator in registers. Keys and values pass
//   through shared memory in KT-key tiles held as fp32; every thread of a warp
//   reads the same key at once, so shared loads are broadcasts. Sweep 1 finds
//   the row max m and sum l online; sweep 2 forms p = exp(s - m) / l, rounds p
//   to the compute dtype (as the TPU kernel and the XLA path do) and
//   accumulates p * v in fp32.
//
// C entry point: hma_fused_attention_fwd, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int ROWS = 64;  // query rows (threads) per block
constexpr int KT = 64;    // keys per shared-memory tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to the compute dtype T, returned as fp32
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// Stage keys [j0, j0 + KT) of one (b, h) into dst as fp32; rows past n_keys are 0.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float (*dst)[D], const T* __restrict__ src,
                                          long long row_stride, int j0, int n_keys) {
  for (int i = threadIdx.x; i < KT * D; i += ROWS) {
    const int j = i / D, d = i % D;
    dst[j][d] = (j0 + j < n_keys) ? to_f(src[(long long)(j0 + j) * row_stride + d]) : 0.f;
  }
}

template <int D>
__device__ __forceinline__ float dot_row(const float (&qr)[D], const float* __restrict__ kr) {
  const float4* k4 = reinterpret_cast<const float4*>(kr);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < D / 4; ++i) {
    const float4 kv = k4[i];
    s = fmaf(qr[4 * i + 0], kv.x, s);
    s = fmaf(qr[4 * i + 1], kv.y, s);
    s = fmaf(qr[4 * i + 2], kv.z, s);
    s = fmaf(qr[4 * i + 3], kv.w, s);
  }
  return s;
}

template <typename T, int D>
__global__ void __launch_bounds__(ROWS)
spatial_attention_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, float* __restrict__ lse, int S, int H, int causal,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh) {
  __shared__ __align__(16) float ks[KT][D];
  __shared__ __align__(16) float vs[KT][D];

  const int b = blockIdx.z, h = blockIdx.y;
  const int row = blockIdx.x * ROWS + threadIdx.x;
  const bool live = row < S;
  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;

  float qr[D];
#pragma unroll
  for (int d = 0; d < D; ++d) qr[d] = live ? to_f(qb[(long long)row * q_ss + d]) : 0.f;

  // keys any row of this block attends to (uniform across the block)
  const int n_keys = causal ? min(S, (int)(blockIdx.x + 1) * ROWS) : S;
  const int last_key = causal ? row : S - 1;  // inclusive, per row

  // sweep 1: row max m and sum l = sum_j exp(s_j - m), online
  float m = -INFINITY, l = 0.f;
  for (int j0 = 0; j0 < n_keys; j0 += KT) {
    __syncthreads();
    load_tile<T, D>(ks, kb, k_ss, j0, n_keys);
    __syncthreads();
    const int jn = min(KT, min(n_keys, last_key + 1) - j0);
    if (live) {
      for (int j = 0; j < jn; ++j) {
        const float s = dot_row<D>(qr, ks[j]);
        if (s > m) {
          l = l * expf(m - s) + 1.f;
          m = s;
        } else {
          l += expf(s - m);
        }
      }
    }
  }

  // sweep 2: out = sum_j round(exp(s_j - m) / l) * v_j
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  for (int j0 = 0; j0 < n_keys; j0 += KT) {
    __syncthreads();
    load_tile<T, D>(ks, kb, k_ss, j0, n_keys);
    load_tile<T, D>(vs, vb, v_ss, j0, n_keys);
    __syncthreads();
    const int jn = min(KT, min(n_keys, last_key + 1) - j0);
    if (live) {
      for (int j = 0; j < jn; ++j) {
        const float p = round_to<T>(expf(dot_row<D>(qr, ks[j]) - m) / l);
        const float4* v4 = reinterpret_cast<const float4*>(vs[j]);
#pragma unroll
        for (int i = 0; i < D / 4; ++i) {
          const float4 vv = v4[i];
          acc[4 * i + 0] = fmaf(p, vv.x, acc[4 * i + 0]);
          acc[4 * i + 1] = fmaf(p, vv.y, acc[4 * i + 1]);
          acc[4 * i + 2] = fmaf(p, vv.z, acc[4 * i + 2]);
          acc[4 * i + 3] = fmaf(p, vv.w, acc[4 * i + 3]);
        }
      }
    }
  }

  if (live) {
    T* orow = out + (((long long)b * S + row) * H + h) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) orow[d] = from_f<T>(acc[d]);
    lse[((long long)b * H + h) * S + row] = m + logf(l);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, void* lse,
                   int B, int S, int H, int causal, const long long* st,
                   cudaStream_t stream) {
  const dim3 grid((S + ROWS - 1) / ROWS, H, B);
  spatial_attention_fwd_kernel<T, D><<<grid, ROWS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(lse), S, H, causal,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8]);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements.
extern "C" int hma_fused_attention_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse,
    int B, int S, int H, int D, int dtype, int causal,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, void* stream) {
  const long long st[9] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || H <= 0 || B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && D == 32) return (int)launch<float, 32>(q, k, v, out, lse, B, S, H, causal, st, s);
  if (dtype == 0 && D == 64) return (int)launch<float, 64>(q, k, v, out, lse, B, S, H, causal, st, s);
  if (dtype == 1 && D == 32)
    return (int)launch<__nv_bfloat16, 32>(q, k, v, out, lse, B, S, H, causal, st, s);
  if (dtype == 1 && D == 64)
    return (int)launch<__nv_bfloat16, 64>(q, k, v, out, lse, B, S, H, causal, st, s);
  return (int)cudaErrorInvalidValue;
}
