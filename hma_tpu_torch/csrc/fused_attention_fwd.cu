// K1': whole-block softmax attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel hma_tpu/ops/fused_attention.py:_fwd_kernel.
// For each (batch b, head h): out = softmax(q k^T [causal]) v, q pre-scaled,
// and lse = the fp32 row log-sum-exp. Layout (B, S, H, D) with the strides of
// the first three axes passed in and a unit stride on D; out is written
// contiguous (B, S, H, D), lse as (B, H, S). The probabilities are normalised
// in fp32 and rounded to the compute dtype before the p v product, as the
// TPU kernel does (fused_attention.py:73).
//
// What bounds it: bytes (q, k, v read once, out and lse written once: 64 MB
// at (B 96, S 320, H 8, D 32), 19 us at 3.35 TB/s) and, close behind, the
// exponentials: two sweeps of one exp a score, 157 M at that shape, ~40 us at
// 16 a clock on each SM's special-function units. Not the products (~15 GFLOP,
// a few us on tensor cores).
//
// bf16, the timed path (spatial_attention_fwd_bf16): FlashAttention-2-shaped
// on tensor cores.
//   - grid (ceil(S / 16 W), H, B), W warps a block (4, or 2 when fewer than
//     two 4-warp blocks per SM would exist), each warp owning 16 query rows;
//   - the q tile and 64-key K and V tiles are copied into shared memory with
//     16-byte cp.async copies straight from the strided views (rows past S
//     zero-filled) and read into fragments with ldmatrix (.trans for v).
//     When all of a head's tiles fit in RESIDENT_BYTES they are all issued
//     up front, one copy group a tile, and sweep 2 rereads k from shared
//     memory; otherwise K (sweep 1) and K, V (sweep 2) stream through a
//     double-buffered ring one tile ahead;
//   - sweep 1: s = q k^T with mma.sync m16n8k16 (bf16 in, fp32 accumulate),
//     each lane keeping an online max and sum over its own columns, merged
//     across the lane quad that shares a row at the end (shfl_xor);
//   - sweep 2: s again, p = exp(s - m) / l in fp32 (exp as one fma and one
//     ex2 of the special-function unit, the division as a product with 1 / l),
//     rounded to bf16 as it is packed from the accumulator into the A
//     fragment of p v (the m16n8 C layout of two n-tiles is the m16n8k16 A
//     layout), out += p v on mma.sync;
//   - masking: keys past S and, when causal, above the diagonal score -inf
//     (key tiles wholly above a block's last row are never loaded); rows past
//     S are computed and not stored.
// The normalised, rounded p is what the TPU kernel multiplies by v; flash
// attention's rescaled unnormalised accumulator would be another rounding.
// exp2 and the product with 1 / l differ from the plain version's exp and
// division by an ulp or two, which flips a bf16 rounding of p now and then:
// well under 1 % of outputs.
//
// fp32 (spatial_attention_fwd_kernel): the CUDA-core body of the first port,
// kept because tensor cores have no full-fp32 product and TF32 would break the
// 1e-5 checks built on it (cached vs full, card vs CPU gradients). No timed
// path runs fp32. One thread per query row with its q row and fp32 output
// accumulator in registers; keys and values pass through shared memory in
// 64-key fp32 tiles read as warp-wide broadcasts; the same two sweeps.
//
// Head dims: the bodies are templates on the width D they run at, 16, 32 or
// 64 (at D 16 q k^T is one m16n8k16 k-step and p v two n8 tiles; the tile
// pitch of 24 elements keeps ldmatrix conflict-free). A head dim equal to it
// takes the aligned path above; any other head dim up to 64 (D_true, 61 on
// the magvit d512 card) takes the ragged path at the next width, at any
// 2-byte alignment: the 16-byte-aligned chunks covering each row copied by
// cp.async (hma_mma::load_rows_ragged; the reads stay inside the row's
// 16-byte-aligned extent), then the row shifted into place with columns
// D_true..D zero-filled (hma_mma::align_rows), so q k^T and p v equal the
// products over D_true, and only the D_true real columns stored (the fp32
// body guards its element loads and stores instead).
//
// C entry point: hma_fused_attention_fwd, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "mma_bf16.cuh"

namespace {

constexpr int ROWS = 64;  // query rows (threads) per block
constexpr int KT = 64;    // keys per shared-memory tile

__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

// x rounded to the compute dtype T, returned as fp32
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// Stage keys [j0, j0 + KT) of one (b, h) into dst as fp32 rows of DP; rows
// past n_keys and (ragged) columns past D are 0.
template <typename T, int DP, bool RAGGED>
__device__ __forceinline__ void load_tile(float (*dst)[DP], const T* __restrict__ src,
                                          long long row_stride, int j0, int n_keys, int D) {
  for (int i = threadIdx.x; i < KT * DP; i += ROWS) {
    const int j = i / DP, d = i % DP;
    dst[j][d] = (j0 + j < n_keys && (!RAGGED || d < D))
                    ? to_f(src[(long long)(j0 + j) * row_stride + d]) : 0.f;
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

template <typename T, int D, bool RAGGED>
__global__ void __launch_bounds__(ROWS)
spatial_attention_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, float* __restrict__ lse, int S, int H, int D_true, int causal,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh) {
  __shared__ __align__(16) float ks[KT][D];
  __shared__ __align__(16) float vs[KT][D];

  const int b = blockIdx.z, h = blockIdx.y;
  const int row = blockIdx.x * ROWS + threadIdx.x;
  const bool live = row < S;
  const int Dn = RAGGED ? D_true : D;  // the row's real elements
  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;

  float qr[D];
#pragma unroll
  for (int d = 0; d < D; ++d)
    qr[d] = live && d < Dn ? to_f(qb[(long long)row * q_ss + d]) : 0.f;

  // keys any row of this block attends to (uniform across the block)
  const int n_keys = causal ? min(S, (int)(blockIdx.x + 1) * ROWS) : S;
  const int last_key = causal ? row : S - 1;  // inclusive, per row

  // sweep 1: row max m and sum l = sum_j exp(s_j - m), online
  float m = -INFINITY, l = 0.f;
  for (int j0 = 0; j0 < n_keys; j0 += KT) {
    __syncthreads();
    load_tile<T, D, RAGGED>(ks, kb, k_ss, j0, n_keys, Dn);
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
    load_tile<T, D, RAGGED>(ks, kb, k_ss, j0, n_keys, Dn);
    load_tile<T, D, RAGGED>(vs, vb, v_ss, j0, n_keys, Dn);
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
    T* orow = out + (((long long)b * S + row) * H + h) * Dn;
#pragma unroll
    for (int d = 0; d < D; ++d)
      if (d < Dn) orow[d] = from_f<T>(acc[d]);
    lse[((long long)b * H + h) * S + row] = m + logf(l);
  }
}

template <typename T, int D, bool RAGGED>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, void* lse,
                   int B, int S, int H, int D_true, int causal, const long long* st,
                   cudaStream_t stream) {
  const dim3 grid((S + ROWS - 1) / ROWS, H, B);
  spatial_attention_fwd_kernel<T, D, RAGGED><<<grid, ROWS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(lse), S, H, D_true, causal,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8]);
  return cudaGetLastError();
}


// ---- bf16 on tensor cores ----------------------------------------------

using bf16 = __nv_bfloat16;

// Shared memory of one block: the q tile, then the k and v buffers. All of a
// head's key tiles stay resident when they fit in RESIDENT_BYTES (one copy
// group a tile, all issued up front, sweep 2 rereads k from shared memory);
// otherwise k and v stream through a ring of two buffers, one tile ahead.
constexpr int RESIDENT_BYTES = 64 * 1024;

template <int D>
__host__ __device__ constexpr int tile_bytes() { return KT * (D + 8) * 2; }

template <int D, int WARPS, bool RAGGED>
__global__ void __launch_bounds__(WARPS * 32)
spatial_attention_fwd_bf16(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ out, float* __restrict__ lse, int S, int H, int D_true, int causal,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh) {
  using namespace hma_mma;
  constexpr int ROWS = 16 * WARPS, THREADS = 32 * WARPS, P = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * ROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bf16* kb = k + b * k_sb + h * k_sh;
  const bf16* vb = v + b * v_sb + h * v_sh;
  const int Dn = RAGGED ? D_true : D;  // the row's real elements

  // keys any row of this block attends to, and each of the lane's two rows
  const int n_keys = causal ? min(S, q0 + ROWS) : S;
  const int n_tiles = (n_keys + KT - 1) / KT, n_steps = 2 * n_tiles;
  const int row = q0 + warp * 16 + g;  // and row + 8
  const int lim[2] = {causal ? min(row + 1, S) : S, causal ? min(row + 9, S) : S};
  const int n_buf = (S + KT - 1) / KT;  // as the launch sized shared memory
  const bool resident = 2 * n_buf * tile_bytes<D>() <= RESIDENT_BYTES;
  bf16(*qs)[P] = reinterpret_cast<bf16(*)[P]>(smem);
  bf16(*ks)[P] = qs + ROWS;
  bf16(*vs)[P] = ks + (resident ? n_buf : 2) * KT;

  // step i < n_tiles: k tile i (sweep 1); else v (and, streaming, k) tile
  // i - n_tiles; one copy group each
  auto issue = [&](int step) {
    const int j = step < n_tiles ? step : step - n_tiles;
    const int slot = resident ? j : step & 1;
    if (step < n_tiles || !resident)
      stage_rows<KT, D, THREADS, RAGGED>(ks + slot * KT, kb, k_ss, j * KT, n_keys, Dn);
    if (step >= n_tiles)
      stage_rows<KT, D, THREADS, RAGGED>(vs + slot * KT, vb, v_ss, j * KT, n_keys, Dn);
    cp_async_commit();
  };
  const bf16* qb = q + b * q_sb + h * q_sh;
  stage_rows<ROWS, D, THREADS, RAGGED>(qs, qb, q_ss, q0, S, Dn);
  const int ahead = resident ? n_steps : 1;  // steps whose copies are in flight
  for (int step = 0; step < ahead; ++step) issue(step);

  uint32_t qa[D / 16][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, rl[2], nm2[2];  // nm2 = -m log2(e)
  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;

  for (int step = 0; step < n_steps; ++step) {
    if (resident) {
      cp_async_wait_at_most(n_steps - 1 - step);
    } else {
      if (step + 1 < n_steps) issue(step + 1);
      else cp_async_commit();
      cp_async_wait<1>();
    }
    __syncthreads();
    const int j = step < n_tiles ? step : step - n_tiles, j0 = j * KT;
    const int slot = resident ? j : step & 1;
    if constexpr (RAGGED) {  // move this step's freshly copied rows into place
      if (step == 0) realign<ROWS, D, THREADS, RAGGED>(qs, qb, q_ss, q0, S, Dn);
      if (step < n_tiles || !resident)
        realign<KT, D, THREADS, RAGGED>(ks + slot * KT, kb, k_ss, j0, n_keys, Dn);
      if (step >= n_tiles)
        realign<KT, D, THREADS, RAGGED>(vs + slot * KT, vb, v_ss, j0, n_keys, Dn);
      __syncthreads();
    }
    if (step == 0) load_a_frags<D>(qa, qs, warp * 16);

    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int np = 0; np < 4; ++np)
      mma_rows_t<D>(s[2 * np], s[2 * np + 1], qa, ks + slot * KT, np * 16);
    // a tile with a masked key for some row of this warp: the ragged end, or
    // the causal diagonal
    if (j0 + KT > S || (causal && j0 + KT > q0 + warp * 16 + 1)) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j0 + nt * 8 + 2 * t + (e & 1) >= lim[e >> 1]) s[nt][e] = -INFINITY;
    }

    if (step < n_tiles) {  // sweep 1: online max and sum over this lane's columns
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float mx = m[hf];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * hf], s[nt][2 * hf + 1]));
        const float mu = mx == -INFINITY ? 0.f : mx;  // nothing seen yet
        const float nmu2 = -mu * LOG2E;
        float sum = l[hf] * exp2_ftz((m[hf] - mu) * LOG2E);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
          sum += exp2_ftz(fmaf(s[nt][2 * hf], LOG2E, nmu2)) +
                 exp2_ftz(fmaf(s[nt][2 * hf + 1], LOG2E, nmu2));
        m[hf] = mx;
        l[hf] = sum;
      }
      if (step == n_tiles - 1) {  // merge the quad's partial (m, l) of each row
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float mq = m[hf];
          mq = fmaxf(mq, __shfl_xor_sync(0xffffffffu, mq, 1));
          mq = fmaxf(mq, __shfl_xor_sync(0xffffffffu, mq, 2));
          float lq = l[hf] * exp2_ftz((m[hf] - mq) * LOG2E);
          lq += __shfl_xor_sync(0xffffffffu, lq, 1);
          lq += __shfl_xor_sync(0xffffffffu, lq, 2);
          nm2[hf] = -mq * LOG2E;
          rl[hf] = 1.f / lq;
          const int r = row + 8 * hf;
          if (t == 0 && r < S) lse[((long long)b * H + h) * S + r] = mq + logf(lq);
        }
      }
    } else {  // sweep 2: out += round(exp(s - m) / l) v
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        float p[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            p[i][e] = exp2_ftz(fmaf(s[2 * kc + i][e], LOG2E, nm2[e >> 1])) * rl[e >> 1];
        uint32_t pa[4];
        c_to_a(pa, p[0], p[1]);
        mma_rows<D>(o, pa, vs + slot * KT, kc * 16);
      }
    }
    if (!resident) __syncthreads();  // the next step refills this buffer
  }
  store_c<D, RAGGED>(out + ((long long)b * S * H + h) * Dn, (long long)H * Dn, o,
                     q0 + warp * 16, S, Dn);
}

template <int D, int WARPS, bool RAGGED>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* out, void* lse,
                        int B, int S, int H, int D_true, int causal, const long long* st,
                        cudaStream_t stream) {
  const int n_buf = (S + KT - 1) / KT;
  const int kv_bytes = 2 * n_buf * tile_bytes<D>() <= RESIDENT_BYTES
                           ? 2 * n_buf * tile_bytes<D>()
                           : 4 * tile_bytes<D>();
  const int bytes = 16 * WARPS * (D + 8) * 2 + kv_bytes;
  static unsigned opted_in = 0;  // a bit a device: above 48 KB a kernel must ask
  int dev = 0;
  cudaGetDevice(&dev);
  if (!(opted_in >> dev & 1u)) {
    const cudaError_t err = cudaFuncSetAttribute(spatial_attention_fwd_bf16<D, WARPS, RAGGED>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 16 * WARPS * (D + 8) * 2 + RESIDENT_BYTES);
    if (err != cudaSuccess) return err;
    opted_in |= 1u << dev;
  }
  const dim3 grid((S + 16 * WARPS - 1) / (16 * WARPS), H, B);
  spatial_attention_fwd_bf16<D, WARPS, RAGGED><<<grid, 32 * WARPS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), static_cast<float*>(lse), S, H, D_true, causal,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8]);
  return cudaGetLastError();
}

// 4 warps a block, or 2 where 4-warp blocks would give fewer than two a SM
template <int D, bool RAGGED>
cudaError_t launch_bf16_any(const void* q, const void* k, const void* v, void* out, void* lse,
                            int B, int S, int H, int D_true, int causal, const long long* st,
                            cudaStream_t stream) {
  if (hma_mma::few_blocks((long long)((S + 63) / 64) * H * B))
    return launch_bf16<D, 2, RAGGED>(q, k, v, out, lse, B, S, H, D_true, causal, st, stream);
  return launch_bf16<D, 4, RAGGED>(q, k, v, out, lse, B, S, H, D_true, causal, st, stream);
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
  return hma_mma::dispatch(dtype, D, [&](auto body) {
    using Bd = decltype(body);
    if constexpr (std::is_same_v<typename Bd::T, float>)
      return (int)launch<float, Bd::DP, Bd::RAGGED>(q, k, v, out, lse, B, S, H, D, causal, st,
                                                    s);
    else
      return (int)launch_bf16_any<Bd::DP, Bd::RAGGED>(q, k, v, out, lse, B, S, H, D, causal,
                                                      st, s);
  });
}
