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
// What bounds it: bytes (five inputs read, three outputs written: 127 MB at
// (B 96, S 320, H 8, D 32), 38 us at 3.35 TB/s); then the exponentials, one a
// score in each pass. The TPU kernel holds a head's whole S x S fp32 score
// block in VMEM (400 KB at S = 320); a Hopper block has at most 227 KB, so no
// score block exists here. Two passes, deterministic and without atomics,
// FlashAttention-2 style, each recomputing the scores from q, k and lse.
//
// bf16, the timed path: the five products on tensor cores (mma.sync
// m16n8k16, bf16 in, fp32 accumulate), tiles staged through a double-buffered
// shared-memory ring with 16-byte cp.async copies and read with ldmatrix.
//   (a) dq pass, grid (ceil(S / 16 W), H, B), W warps of 16 query rows. Each
//       warp keeps its q and dout rows as A fragments, computes delta as the
//       diagonal of dout out^T on the tensor cores, so that it sums its D
//       terms in the order dp does (where out equals v, dp - delta is exactly
//       0, as in the plain version), and stores it to the scratch. Then it
//       streams 64-key K and V tiles: per 16 keys s = q k^T, p = exp(s - lse)
//       (exp as ex2 of (s - lse) log2(e) on the special-function unit),
//       dp = dout v^T, ds = round(p (dp - delta)) packed from the accumulators
//       into an A fragment, dq += ds k.
//   (b) dk/dv pass, launched after (a) on the same stream: the same grid over
//       key rows; each warp keeps its k and v rows as A fragments and streams
//       64-query q, dout, lse and delta tiles: per 16 queries s^T = k q^T,
//       p^T, dv += round(p)^T dout, dp^T = v dout^T, dk += round(ds)^T q.
//   W is 4, or 2 when fewer than two 4-warp blocks per SM would exist.
//
// fp32: the CUDA-core body of the first port, kept because tensor cores have
// no full-fp32 product and TF32 would break the checks built on it (card vs
// CPU gradients to 1e-4). No timed path runs fp32. The same two passes, one
// thread per query (a) or key (b) row, tiles held as fp32 in shared memory
// and read as warp-wide broadcasts.
//
// Head dims: as K1' (fused_attention_fwd.cu): the bodies are templates on the
// width D they run at (16, 32 or 64); any other head dim D_true up to 64
// takes the ragged path: rows staged as their covering 16-byte-aligned
// chunks by cp.async and shifted into place with zero-filled columns (the
// reads stay inside each row's 16-byte-aligned extent), delta's out rows
// read element by element, and only the D_true real columns of dq, dk, dv
// stored.
//
// C entry point: hma_fused_attention_bwd, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "mma_bf16.cuh"

namespace {

constexpr int ROWS = 64;  // rows (threads) per block
constexpr int KT = 64;    // rows per shared-memory tile

__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

// x rounded to the compute dtype T, returned as fp32
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// Stage rows [r0, r0 + KT) of one (b, h) into dst as fp32 rows of DP; rows
// past n and (ragged) columns past D are 0.
template <typename T, int DP, bool RAGGED>
__device__ __forceinline__ void load_tile(float (*dst)[DP], const T* __restrict__ src,
                                          long long row_stride, int r0, int n, int D) {
  for (int i = threadIdx.x; i < KT * DP; i += ROWS) {
    const int r = i / DP, d = i % DP;
    dst[r][d] = (r0 + r < n && (!RAGGED || d < D))
                    ? to_f(src[(long long)(r0 + r) * row_stride + d]) : 0.f;
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
template <typename T, int D, bool RAGGED>
__global__ void __launch_bounds__(ROWS)
spatial_attention_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ out, const float* __restrict__ lse, const T* __restrict__ dout,
    T* __restrict__ dq, float* __restrict__ delta, int S, int H, int D_true, int causal,
    Strides qs, Strides ks_, Strides vs_, Strides os, Strides ds_) {
  __shared__ __align__(16) float ks[KT][D];
  __shared__ __align__(16) float vs[KT][D];

  const int b = blockIdx.z, h = blockIdx.y;
  const int row = blockIdx.x * ROWS + threadIdx.x;
  const bool live = row < S;
  const int Dn = RAGGED ? D_true : D;  // the row's real elements
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
    const bool in = live && d < Dn;
    qr[d] = in ? to_f(qr_p[d]) : 0.f;
    dr[d] = in ? to_f(dr_p[d]) : 0.f;
    dl = fmaf(dr[d], in ? to_f(or_p[d]) : 0.f, dl);
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
    load_tile<T, D, RAGGED>(ks, kb, ks_.s, j0, n_keys, Dn);
    load_tile<T, D, RAGGED>(vs, vb, vs_.s, j0, n_keys, Dn);
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
    T* o = dq + (((long long)b * S + row) * H + h) * Dn;
#pragma unroll
    for (int d = 0; d < D; ++d)
      if (d < Dn) o[d] = from_f<T>(acc[d]);
  }
}

// (b): dk and dv, one thread per key row
template <typename T, int D, bool RAGGED>
__global__ void __launch_bounds__(ROWS)
spatial_attention_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ lse, const T* __restrict__ dout,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    int S, int H, int D_true, int causal, Strides qs_, Strides ks, Strides vs, Strides ds_) {
  __shared__ __align__(16) float qs[KT][D];
  __shared__ __align__(16) float dos[KT][D];
  __shared__ float ls[KT];
  __shared__ float dls[KT];

  const int b = blockIdx.z, h = blockIdx.y;
  const int key = blockIdx.x * ROWS + threadIdx.x;
  const bool live = key < S;
  const int Dn = RAGGED ? D_true : D;  // the row's real elements
  const long long bh = (long long)b * H + h;
  const T* kr_p = k + b * ks.b + h * ks.h + (long long)key * ks.s;
  const T* vr_p = v + b * vs.b + h * vs.h + (long long)key * vs.s;
  const T* qb = q + b * qs_.b + h * qs_.h;
  const T* db = dout + b * ds_.b + h * ds_.h;

  float kr[D], vr[D], dka[D], dva[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    kr[d] = live && d < Dn ? to_f(kr_p[d]) : 0.f;
    vr[d] = live && d < Dn ? to_f(vr_p[d]) : 0.f;
    dka[d] = 0.f;
    dva[d] = 0.f;
  }

  // causal: only queries i >= key see this key; earlier tiles are skipped
  const int i_start = causal ? blockIdx.x * ROWS : 0;
  for (int i0 = i_start; i0 < S; i0 += KT) {
    __syncthreads();
    load_tile<T, D, RAGGED>(qs, qb, qs_.s, i0, S, Dn);
    load_tile<T, D, RAGGED>(dos, db, ds_.s, i0, S, Dn);
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
    const long long o = (((long long)b * S + key) * H + h) * Dn;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      if (d >= Dn) continue;
      dk[o + d] = from_f<T>(dka[d]);
      dv[o + d] = from_f<T>(dva[d]);
    }
  }
}

template <typename T, int D, bool RAGGED>
cudaError_t launch(const void* q, const void* k, const void* v, const void* out,
                   const void* lse, const void* dout, void* dq, void* dk, void* dv,
                   void* delta, int B, int S, int H, int D_true, int causal,
                   const long long* st, cudaStream_t stream) {
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]}, sv{st[6], st[7], st[8]},
      so{st[9], st[10], st[11]}, sd{st[12], st[13], st[14]};
  const dim3 grid((S + ROWS - 1) / ROWS, H, B);
  spatial_attention_bwd_dq_kernel<T, D, RAGGED><<<grid, ROWS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(out), static_cast<const float*>(lse),
      static_cast<const T*>(dout), static_cast<T*>(dq), static_cast<float*>(delta),
      S, H, D_true, causal, sq, sk, sv, so, sd);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  spatial_attention_bwd_dkdv_kernel<T, D, RAGGED><<<grid, ROWS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(lse), static_cast<const T*>(dout),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv),
      S, H, D_true, causal, sq, sk, sv, sd);
  return cudaGetLastError();
}


// ---- bf16 on tensor cores ----------------------------------------------

using bf16 = __nv_bfloat16;

// (a): dq and delta, 16 query rows a warp
template <int D, int WARPS, bool RAGGED>
__global__ void __launch_bounds__(WARPS * 32)
spatial_attention_bwd_dq_bf16(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ out, const float* __restrict__ lse, const bf16* __restrict__ dout,
    bf16* __restrict__ dq, float* __restrict__ delta, int S, int H, int D_true, int causal,
    Strides sq, Strides sk, Strides sv, Strides so, Strides sd) {
  using namespace hma_mma;
  constexpr int ROWS = 16 * WARPS, THREADS = 32 * WARPS, P = D + 8;
  // buffer 1 of the ring first holds the block's q and dout rows
  __shared__ __align__(16) bf16 ks[2][KT][P];
  __shared__ __align__(16) bf16 vs[2][KT][P];

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * ROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const long long bh = (long long)b * H + h;
  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;
  const int Dn = RAGGED ? D_true : D;  // the row's real elements
  const int n_keys = causal ? min(S, q0 + ROWS) : S;
  const int n_tiles = (n_keys + KT - 1) / KT;
  const int row = q0 + warp * 16 + g;  // and row + 8
  const int lim[2] = {causal ? min(row + 1, S) : S, causal ? min(row + 9, S) : S};

  auto issue = [&](int j) {
    stage_rows<KT, D, THREADS, RAGGED>(ks[j & 1], kb, sk.s, j * KT, n_keys, Dn);
    stage_rows<KT, D, THREADS, RAGGED>(vs[j & 1], vb, sv.s, j * KT, n_keys, Dn);
    cp_async_commit();
  };
  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* db = dout + b * sd.b + h * sd.h;
  stage_rows<ROWS, D, THREADS, RAGGED>(ks[1], qb, sq.s, q0, S, Dn);
  stage_rows<ROWS, D, THREADS, RAGGED>(vs[1], db, sd.s, q0, S, Dn);
  issue(0);
  cp_async_wait<0>();
  __syncthreads();
  if constexpr (RAGGED) {  // move the copied rows into place
    realign<ROWS, D, THREADS, RAGGED>(ks[1], qb, sq.s, q0, S, Dn);
    realign<ROWS, D, THREADS, RAGGED>(vs[1], db, sd.s, q0, S, Dn);
    realign<KT, D, THREADS, RAGGED>(ks[0], kb, sk.s, 0, n_keys, Dn);
    realign<KT, D, THREADS, RAGGED>(vs[0], vb, sv.s, 0, n_keys, Dn);
    __syncthreads();
  }
  uint32_t qa[D / 16][4], da[D / 16][4];
  load_a_frags<D>(qa, ks[1], warp * 16);
  load_a_frags<D>(da, vs[1], warp * 16);

  // delta: the diagonal of dout . out^T over the warp's 16 rows, the out rows
  // read straight into B fragments (n = row, k = d)
  float dd[2][4] = {};
  const bf16* ob = out + b * so.b + h * so.h;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int r = q0 + warp * 16 + nt * 8 + g;
      const bf16* orow = ob + (r < S ? (long long)r * so.s : 0);
      const int col = kc * 16 + 2 * t;
      const uint32_t b0 = r < S ? load_pair<RAGGED>(orow, col, Dn) : 0u;
      const uint32_t b1 = r < S ? load_pair<RAGGED>(orow, col + 8, Dn) : 0u;
      mma16816(dd[nt], da[kc], b0, b1);
    }
  // (g, g) sits in n-tile 0 and (g + 8, g + 8) in n-tile 1, both on the lane
  // with t = g / 2, as element g % 2 of its row pair
  const int src = (lane & ~3) | (g >> 1);
  const float dl[2] = {__shfl_sync(0xffffffffu, (g & 1) ? dd[0][1] : dd[0][0], src),
                       __shfl_sync(0xffffffffu, (g & 1) ? dd[1][3] : dd[1][2], src)};
  float ls[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = row + 8 * hf;
    ls[hf] = r < S ? lse[bh * S + r] : 0.f;
    if (t == 0 && r < S) delta[bh * S + r] = dl[hf];
  }
  __syncthreads();  // buffer 1 is free for the ring

  float acc[D / 8][4] = {};
  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) issue(j + 1);
    else cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int buf = j & 1;
    if (RAGGED && j > 0) {  // tile 0 was moved into place above
      realign<KT, D, THREADS, RAGGED>(ks[buf], kb, sk.s, j * KT, n_keys, Dn);
      realign<KT, D, THREADS, RAGGED>(vs[buf], vb, sv.s, j * KT, n_keys, Dn);
      __syncthreads();
    }
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      const int key0 = j * KT + kc * 16;
      if (key0 >= n_keys || (causal && key0 > q0 + warp * 16 + 15)) continue;  // all masked
      float s[2][4] = {}, dp[2][4] = {}, ds[2][4];
      mma_rows_t<D>(s[0], s[1], qa, ks[buf], kc * 16);
      mma_rows_t<D>(dp[0], dp[1], da, vs[buf], kc * 16);
      if (key0 + 16 > S || (causal && key0 + 16 > q0 + warp * 16 + 1)) {  // some masked
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (key0 + i * 8 + 2 * t + (e & 1) >= lim[e >> 1]) s[i][e] = -INFINITY;
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds[i][e] = exp2_ftz((s[i][e] - ls[e >> 1]) * LOG2E) * (dp[i][e] - dl[e >> 1]);
      uint32_t a[4];
      c_to_a(a, ds[0], ds[1]);
      mma_rows<D>(acc, a, ks[buf], kc * 16);
    }
    __syncthreads();  // the next tile refills this buffer
  }
  store_c<D, RAGGED>(dq + (b * (long long)S * H + h) * Dn, (long long)H * Dn, acc,
                     q0 + warp * 16, S, Dn);
}

// (b): dk and dv, 16 key rows a warp
template <int D, int WARPS, bool RAGGED>
__global__ void __launch_bounds__(WARPS * 32)
spatial_attention_bwd_dkdv_bf16(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ lse, const bf16* __restrict__ dout,
    const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv,
    int S, int H, int D_true, int causal, Strides sq, Strides sk, Strides sv, Strides sd) {
  using namespace hma_mma;
  constexpr int ROWS = 16 * WARPS, THREADS = 32 * WARPS, P = D + 8;
  // buffer 1 of the ring first holds the block's k and v rows
  __shared__ __align__(16) bf16 qs[2][KT][P];
  __shared__ __align__(16) bf16 dos[2][KT][P];
  __shared__ __align__(16) float lss[2][KT];
  __shared__ __align__(16) float dls[2][KT];

  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * ROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const long long bh = (long long)b * H + h;
  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* db = dout + b * sd.b + h * sd.h;
  const int Dn = RAGGED ? D_true : D;  // the row's real elements
  // causal: only queries i >= key see a key; tiles wholly before k0 are skipped
  const int i_start = causal ? k0 / KT * KT : 0;
  const int n_tiles = (S - i_start + KT - 1) / KT;
  const int key = k0 + warp * 16 + g;  // and key + 8

  auto issue = [&](int i) {
    const int i0 = i_start + i * KT, buf = i & 1;
    stage_rows<KT, D, THREADS, RAGGED>(qs[buf], qb, sq.s, i0, S, Dn);
    stage_rows<KT, D, THREADS, RAGGED>(dos[buf], db, sd.s, i0, S, Dn);
    load_floats<KT, THREADS>(lss[buf], lse + bh * S, i0, S);
    load_floats<KT, THREADS>(dls[buf], delta + bh * S, i0, S);
    cp_async_commit();
  };
  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;
  stage_rows<ROWS, D, THREADS, RAGGED>(qs[1], kb, sk.s, k0, S, Dn);
  stage_rows<ROWS, D, THREADS, RAGGED>(dos[1], vb, sv.s, k0, S, Dn);
  issue(0);
  cp_async_wait<0>();
  __syncthreads();
  if constexpr (RAGGED) {  // move the copied rows into place
    realign<ROWS, D, THREADS, RAGGED>(qs[1], kb, sk.s, k0, S, Dn);
    realign<ROWS, D, THREADS, RAGGED>(dos[1], vb, sv.s, k0, S, Dn);
    realign<KT, D, THREADS, RAGGED>(qs[0], qb, sq.s, i_start, S, Dn);
    realign<KT, D, THREADS, RAGGED>(dos[0], db, sd.s, i_start, S, Dn);
    __syncthreads();
  }
  uint32_t ka[D / 16][4], va[D / 16][4];
  load_a_frags<D>(ka, qs[1], warp * 16);
  load_a_frags<D>(va, dos[1], warp * 16);
  __syncthreads();  // buffer 1 is free for the ring

  float dka[D / 8][4] = {}, dva[D / 8][4] = {};
  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) issue(i + 1);
    else cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int buf = i & 1, i0 = i_start + i * KT;
    if (RAGGED && i > 0) {  // tile 0 was moved into place above
      realign<KT, D, THREADS, RAGGED>(qs[buf], qb, sq.s, i0, S, Dn);
      realign<KT, D, THREADS, RAGGED>(dos[buf], db, sd.s, i0, S, Dn);
      __syncthreads();
    }
#pragma unroll
    for (int qc = 0; qc < 4; ++qc) {
      const int c0 = qc * 16, q_first = i0 + c0;
      if (q_first >= S || (causal && q_first + 15 < k0 + warp * 16)) continue;  // all masked
      float st[2][4] = {}, dpt[2][4] = {}, p[2][4], ds[2][4];
      mma_rows_t<D>(st[0], st[1], ka, qs[buf], c0);
      if (q_first + 16 > S || (causal && q_first < k0 + warp * 16 + 15)) {  // some masked
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = q_first + n * 8 + 2 * t + (e & 1);
            if (qi >= S || (causal && qi < key + 8 * (e >> 1))) st[n][e] = -INFINITY;
          }
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[n][e] = exp2_ftz((st[n][e] - lss[buf][c0 + n * 8 + 2 * t + (e & 1)]) * LOG2E);
      uint32_t a[4];
      c_to_a(a, p[0], p[1]);
      mma_rows<D>(dva, a, dos[buf], c0);
      mma_rows_t<D>(dpt[0], dpt[1], va, dos[buf], c0);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds[n][e] = p[n][e] * (dpt[n][e] - dls[buf][c0 + n * 8 + 2 * t + (e & 1)]);
      c_to_a(a, ds[0], ds[1]);
      mma_rows<D>(dka, a, qs[buf], c0);
    }
    __syncthreads();  // the next tile refills this buffer
  }
  const long long o = (b * (long long)S * H + h) * Dn;
  store_c<D, RAGGED>(dk + o, (long long)H * Dn, dka, k0 + warp * 16, S, Dn);
  store_c<D, RAGGED>(dv + o, (long long)H * Dn, dva, k0 + warp * 16, S, Dn);
}

template <int D, int WARPS, bool RAGGED>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const void* out,
                        const void* lse, const void* dout, void* dq, void* dk, void* dv,
                        void* delta, int B, int S, int H, int D_true, int causal,
                        const long long* st, cudaStream_t stream) {
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]}, sv{st[6], st[7], st[8]},
      so{st[9], st[10], st[11]}, sd{st[12], st[13], st[14]};
  const dim3 grid((S + 16 * WARPS - 1) / (16 * WARPS), H, B);
  spatial_attention_bwd_dq_bf16<D, WARPS, RAGGED><<<grid, 32 * WARPS, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(out), static_cast<const float*>(lse),
      static_cast<const bf16*>(dout), static_cast<bf16*>(dq), static_cast<float*>(delta),
      S, H, D_true, causal, sq, sk, sv, so, sd);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  spatial_attention_bwd_dkdv_bf16<D, WARPS, RAGGED><<<grid, 32 * WARPS, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(lse), static_cast<const bf16*>(dout),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      S, H, D_true, causal, sq, sk, sv, sd);
  return cudaGetLastError();
}

// 4 warps a block, or 2 where 4-warp blocks would give fewer than two a SM
template <int D, bool RAGGED>
cudaError_t launch_bf16_any(const void* q, const void* k, const void* v, const void* out,
                            const void* lse, const void* dout, void* dq, void* dk, void* dv,
                            void* delta, int B, int S, int H, int D_true, int causal,
                            const long long* st, cudaStream_t stream) {
  if (hma_mma::few_blocks((long long)((S + 63) / 64) * H * B))
    return launch_bf16<D, 2, RAGGED>(q, k, v, out, lse, dout, dq, dk, dv, delta, B, S, H,
                                     D_true, causal, st, stream);
  return launch_bf16<D, 4, RAGGED>(q, k, v, out, lse, dout, dq, dk, dv, delta, B, S, H,
                                   D_true, causal, st, stream);
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
  return hma_mma::dispatch(dtype, D, [&](auto body) {
    using Bd = decltype(body);
    if constexpr (std::is_same_v<typename Bd::T, float>)
      return (int)launch<float, Bd::DP, Bd::RAGGED>(q, k, v, out, lse, dout, dq, dk, dv,
                                                    delta, B, S, H, D, causal, st, s);
    else
      return (int)launch_bf16_any<Bd::DP, Bd::RAGGED>(q, k, v, out, lse, dout, dq, dk, dv,
                                                      delta, B, S, H, D, causal, st, s);
  });
}
