// K2': whole-block softmax attention backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel hma_tpu/ops/fused_attention.py:_bwd_kernel.
// For each (batch b, head h), from the forward's out and fp32 lse:
//   p     = exp(q k^T - lse)           fp32, 0 above the diagonal when causal
//   dv    = round(p)^T dout
//   dp    = dout v^T,  delta = rowsum(dout * out)   fp32
//   ds    = round(p * (dp - delta))
//   dq    = ds k,  dk = ds^T q
// with round() to the compute dtype, fp32 accumulation and dq, dk, dv written
// in the compute dtype, exactly the TPU kernel's numerics. Layout (B, S, H, D)
// for q, k, v, out and dout with the strides of the first three axes passed
// in and a unit stride on D; lse and the delta scratch are (B, H, S) fp32;
// dq, dk, dv are written contiguous (B, S, H, D).
//
// Design (see hma_tpu_torch/ops/fused_attention.py for the reasoning): the TPU
// kernel holds a head's whole S x S fp32 score block in VMEM (400 KB at
// S = 320); a Hopper block has at most 227 KB, so no score block exists here.
// Two passes, deterministic and without atomics, FlashAttention-2 style:
//   (a) dq pass, grid (ceil(S / ROWS), H, B), one thread per query row. It
//       computes its delta from its own dout and out rows and stores it to the
//       scratch, then streams key/value tiles through shared memory (fp32,
//       read as warp-wide broadcasts) and recomputes p, dp and ds per key.
//   (b) dk/dv pass, the same grid, one thread per key row. It streams q,
//       dout, lse and delta tiles and accumulates dk and dv in registers.
// Scores are recomputed in both passes: the price of keeping no score block.
//
// C entry point: hma_fused_attention_bwd, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int ROWS = 64;  // rows (threads) per block
constexpr int KT = 64;    // rows per shared-memory tile

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

// Stage rows [r0, r0 + KT) of one (b, h) into dst as fp32; rows past n are 0.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float (*dst)[D], const T* __restrict__ src,
                                          long long row_stride, int r0, int n) {
  for (int i = threadIdx.x; i < KT * D; i += ROWS) {
    const int r = i / D, d = i % D;
    dst[r][d] = (r0 + r < n) ? to_f(src[(long long)(r0 + r) * row_stride + d]) : 0.f;
  }
}

template <int D>
__device__ __forceinline__ float dot_row(const float (&a)[D], const float* __restrict__ b) {
  const float4* b4 = reinterpret_cast<const float4*>(b);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < D / 4; ++i) {
    const float4 x = b4[i];
    s = fmaf(a[4 * i + 0], x.x, s);
    s = fmaf(a[4 * i + 1], x.y, s);
    s = fmaf(a[4 * i + 2], x.z, s);
    s = fmaf(a[4 * i + 3], x.w, s);
  }
  return s;
}

// acc += w * row, row a 16-byte-aligned fp32 row in shared memory
template <int D>
__device__ __forceinline__ void axpy_row(float (&acc)[D], float w, const float* __restrict__ row) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int i = 0; i < D / 4; ++i) {
    const float4 x = r4[i];
    acc[4 * i + 0] = fmaf(w, x.x, acc[4 * i + 0]);
    acc[4 * i + 1] = fmaf(w, x.y, acc[4 * i + 1]);
    acc[4 * i + 2] = fmaf(w, x.z, acc[4 * i + 2]);
    acc[4 * i + 3] = fmaf(w, x.w, acc[4 * i + 3]);
  }
}

struct Strides {  // (batch, row, head) strides in elements
  long long b, s, h;
};

// (a): dq and delta, one thread per query row
template <typename T, int D>
__global__ void __launch_bounds__(ROWS)
spatial_attention_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ out, const float* __restrict__ lse, const T* __restrict__ dout,
    T* __restrict__ dq, float* __restrict__ delta, int S, int H, int causal,
    Strides qs, Strides ks_, Strides vs_, Strides os, Strides ds_) {
  __shared__ __align__(16) float ks[KT][D];
  __shared__ __align__(16) float vs[KT][D];

  const int b = blockIdx.z, h = blockIdx.y;
  const int row = blockIdx.x * ROWS + threadIdx.x;
  const bool live = row < S;
  const long long bh = (long long)b * H + h;
  const T* qr_p = q + b * qs.b + h * qs.h + (long long)row * qs.s;
  const T* or_p = out + b * os.b + h * os.h + (long long)row * os.s;
  const T* dr_p = dout + b * ds_.b + h * ds_.h + (long long)row * ds_.s;
  const T* kb = k + b * ks_.b + h * ks_.h;
  const T* vb = v + b * vs_.b + h * vs_.h;

  float qr[D], dr[D];
  float dl = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = live ? to_f(qr_p[d]) : 0.f;
    dr[d] = live ? to_f(dr_p[d]) : 0.f;
    dl = fmaf(dr[d], live ? to_f(or_p[d]) : 0.f, dl);
  }
  const float l = live ? lse[bh * S + row] : 0.f;
  if (live) delta[bh * S + row] = dl;

  // keys any row of this block attends to (uniform across the block)
  const int n_keys = causal ? min(S, (int)(blockIdx.x + 1) * ROWS) : S;
  const int last_key = causal ? row : S - 1;  // inclusive, per row

  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  for (int j0 = 0; j0 < n_keys; j0 += KT) {
    __syncthreads();
    load_tile<T, D>(ks, kb, ks_.s, j0, n_keys);
    load_tile<T, D>(vs, vb, vs_.s, j0, n_keys);
    __syncthreads();
    const int jn = min(KT, min(n_keys, last_key + 1) - j0);
    if (live) {
      for (int j = 0; j < jn; ++j) {
        const float p = expf(dot_row<D>(qr, ks[j]) - l);
        const float dp = dot_row<D>(dr, vs[j]);
        axpy_row<D>(acc, round_to<T>(p * (dp - dl)), ks[j]);
      }
    }
  }
  if (live) {
    T* o = dq + (((long long)b * S + row) * H + h) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) o[d] = from_f<T>(acc[d]);
  }
}

// (b): dk and dv, one thread per key row
template <typename T, int D>
__global__ void __launch_bounds__(ROWS)
spatial_attention_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ lse, const T* __restrict__ dout,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    int S, int H, int causal, Strides qs_, Strides ks, Strides vs, Strides ds_) {
  __shared__ __align__(16) float qs[KT][D];
  __shared__ __align__(16) float dos[KT][D];
  __shared__ float ls[KT];
  __shared__ float dls[KT];

  const int b = blockIdx.z, h = blockIdx.y;
  const int key = blockIdx.x * ROWS + threadIdx.x;
  const bool live = key < S;
  const long long bh = (long long)b * H + h;
  const T* kr_p = k + b * ks.b + h * ks.h + (long long)key * ks.s;
  const T* vr_p = v + b * vs.b + h * vs.h + (long long)key * vs.s;
  const T* qb = q + b * qs_.b + h * qs_.h;
  const T* db = dout + b * ds_.b + h * ds_.h;

  float kr[D], vr[D], dka[D], dva[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    kr[d] = live ? to_f(kr_p[d]) : 0.f;
    vr[d] = live ? to_f(vr_p[d]) : 0.f;
    dka[d] = 0.f;
    dva[d] = 0.f;
  }

  // causal: only queries i >= key see this key; earlier tiles are skipped
  const int i_start = causal ? blockIdx.x * ROWS : 0;
  for (int i0 = i_start; i0 < S; i0 += KT) {
    __syncthreads();
    load_tile<T, D>(qs, qb, qs_.s, i0, S);
    load_tile<T, D>(dos, db, ds_.s, i0, S);
    for (int i = threadIdx.x; i < KT; i += ROWS) {
      ls[i] = (i0 + i < S) ? lse[bh * S + i0 + i] : 0.f;
      dls[i] = (i0 + i < S) ? delta[bh * S + i0 + i] : 0.f;
    }
    __syncthreads();
    const int in = min(KT, S - i0);
    const int i_first = causal ? max(0, key - i0) : 0;
    if (live) {
      for (int i = i_first; i < in; ++i) {
        const float p = expf(dot_row<D>(kr, qs[i]) - ls[i]);
        axpy_row<D>(dva, round_to<T>(p), dos[i]);
        const float dp = dot_row<D>(vr, dos[i]);
        axpy_row<D>(dka, round_to<T>(p * (dp - dls[i])), qs[i]);
      }
    }
  }
  if (live) {
    const long long o = (((long long)b * S + key) * H + h) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      dk[o + d] = from_f<T>(dka[d]);
      dv[o + d] = from_f<T>(dva[d]);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* out,
                   const void* lse, const void* dout, void* dq, void* dk, void* dv,
                   void* delta, int B, int S, int H, int causal, const long long* st,
                   cudaStream_t stream) {
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]}, sv{st[6], st[7], st[8]},
      so{st[9], st[10], st[11]}, sd{st[12], st[13], st[14]};
  const dim3 grid((S + ROWS - 1) / ROWS, H, B);
  spatial_attention_bwd_dq_kernel<T, D><<<grid, ROWS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(out), static_cast<const float*>(lse),
      static_cast<const T*>(dout), static_cast<T*>(dq), static_cast<float*>(delta),
      S, H, causal, sq, sk, sv, so, sd);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  spatial_attention_bwd_dkdv_kernel<T, D><<<grid, ROWS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(lse), static_cast<const T*>(dout),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv),
      S, H, causal, sq, sk, sv, sd);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, (batch, row,
// head) for q, k, v, out, dout in that order. delta: (B, H, S) fp32 scratch.
extern "C" int hma_fused_attention_bwd(
    const void* q, const void* k, const void* v, const void* out, const void* lse,
    const void* dout, void* dq, void* dk, void* dv, void* delta,
    int B, int S, int H, int D, int dtype, int causal,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    long long d_sb, long long d_ss, long long d_sh, void* stream) {
  const long long st[15] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                            o_sb, o_ss, o_sh, d_sb, d_ss, d_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || H <= 0 || B > 65535 || H > 65535 || delta == nullptr)
    return (int)cudaErrorInvalidValue;
#define HMA_LAUNCH(T, DD) \
  launch<T, DD>(q, k, v, out, lse, dout, dq, dk, dv, delta, B, S, H, causal, st, s)
  if (dtype == 0 && D == 32) return (int)HMA_LAUNCH(float, 32);
  if (dtype == 0 && D == 64) return (int)HMA_LAUNCH(float, 64);
  if (dtype == 1 && D == 32) return (int)HMA_LAUNCH(__nv_bfloat16, 32);
  if (dtype == 1 && D == 64) return (int)HMA_LAUNCH(__nv_bfloat16, 64);
#undef HMA_LAUNCH
  return (int)cudaErrorInvalidValue;
}
