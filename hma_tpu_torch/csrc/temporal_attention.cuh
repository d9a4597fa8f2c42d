// The bodies of the causal tiny-T temporal attention kernels, shared by
// K3'/K4' (temporal_attention_{fwd,bwd}.cu, sites in one (N, T, H, D) axis)
// and K5' (temporal_resident_{fwd,bwd}.cu, sites split into (B, S) around the
// frame axis). Both compute the same thing, instruction for instruction: only
// where a row of q, k, v, out or dout starts differs, which each tensor's
// `Map` states, so the two agree bit for bit on the same values.
//
// Numerics (the TPU kernels' own, hma_tpu/ops/temporal_attention.py): every
// intermediate in fp32 (scores, softmax statistics and probs, dp, delta, ds,
// accumulators); only out, dq, dk, dv are rounded to the compute dtype. So no
// tensor core: the products with p and ds stay fp32, on the CUDA cores.
//
// Design: sites over threads, as the TPU kernel puts sites over lanes
// (hma_tpu/ops/temporal_attention.py:9-14: every elementwise and reduce op on
// dense site vectors, the (T, T) scores of each site at their natural size).
// A thread owns one query row (site, head, frame t): its dot products run
// over D inside the thread, so no score is a cross-lane reduction, and each
// softmax scalar (max, sum, exp, p, ds) is computed once, by its owner.
//   - A block takes a tile of R (site, head) rows, R = 32 / F, with all their
//     frames: lane l of warp w owns row r = l % R at frame t = w F + l / R.
//     R = 32 where the tile fits the shared-memory budget; F = 2, 4 or 8
//     frames a warp where it does not (DP 64, the backward, fp32). Lanes of
//     one warp share their frame up to F, so their causal loops (t + 1 keys)
//     agree up to F - 1 steps.
//   - Staging: the tile's rows of q, k, v (and out, dout) are copied into
//     shared memory in 16-byte cp.async pieces, whatever the strides (rows
//     must start 16-byte aligned, which the wrappers check), neighbouring
//     threads on neighbouring pieces: a (site, head)'s rows at one frame sit
//     side by side in the qkv projection, so every global read is a full
//     line. The row pitch is D + 16 bytes, so the 32 rows a warp reads at one
//     offset (16 bytes a lane) fall in distinct bank groups per 8-lane phase.
//     One tile a block, a grid of one block a tile: the tile budget leaves
//     room for two or more resident blocks a SM, so one block's copies
//     overlap another's arithmetic (on an H100 this beat blocks that walk
//     several tiles with the next tile's copies in flight).
//   - Head dims: the bodies are instantiated at DP = 16, 32 and 64 (rows of
//     DP elements, a thread's row in DP registers). D == DP is the aligned
//     path above. Any other D up to 64 runs at the next DP on the ragged
//     path: its rows (4D or 2D bytes, 2-byte aligned inside a (..., 3, H, D)
//     projection, which no cp.async can read as rows) are copied as the
//     16-byte-aligned chunks that cover them, by the same cp.async, into
//     their slots (a slot's extra 16 bytes of pitch hold the lead), then
//     shifted to the slot's start in shared memory with columns D..DP
//     zero-filled, one warp a row; every dot product and axpy over DP then
//     equals the one over D, and only the D real elements of each output row
//     are stored, one by one.
//   - Outputs go back through shared memory (out over q's row, dq over
//     out's, dk and dv over k's and v's, each row overwritten only once its
//     last reader is done) as 16-byte stores of whole rows.
//   - Forward: q and k arrive as one group of copies, v as a second. Over
//     the keys j <= t the thread computes the scores and their maximum, then
//     one exp a pair and the sum l (the row's scores in shared memory, its
//     own column of the causal triangle) while v lands, then p = e / l and
//     out = sum p v, all in fp32.
//   - Backward, two phases in one block, no atomics, one exp a pair:
//     (a) the thread of (row, t) computes delta_t = dout_t . out_t, then for
//         each j <= t p = exp(q_t . k_j - lse_t), ds = p (dout_t . v_j -
//         delta_t) into shared memory (fp32, the causal triangle), and dq_t;
//     (b) after a barrier, the thread of (row, j) sums dk_j = sum_{t>=j} ds
//         q_t and dv_j = sum_{t>=j} p dout_t.
//     delta and dp are the same dot product (one summation order), so where
//     out_t equals v_t (t = 0) ds is exactly 0, as in the plain version.
// Bound by bytes (see the entry files).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

// Everything in an unnamed namespace: each library (one translation unit)
// keeps its own kernels and its own record of which devices granted them
// their shared memory. A function-local static of an inline function with
// external linkage is one object for all libraries in the process, even
// when each is loaded RTLD_LOCAL, and K3' and K5' would then share it.
namespace hma_temporal {
namespace {

constexpr int MAX_T = 16;
constexpr int MAX_SMEM = 227 * 1024;  // a block's dynamic shared memory on sm_90
// Shared memory a tile may take, where a tile of R = 32 rows does not fit:
// 113 KB leaves room for two forward blocks a SM, 75 KB for three backward
// ones (228 KB a SM, 1 KB of it reserved a block).
constexpr long long FWD_TILE_BYTES = 113 * 1024;
constexpr long long BWD_TILE_BYTES = 75 * 1024;

// Threads a block at most: MAX_T warps (512) at DP 16 and 32. At DP 64 the
// backward keeps q_t, dout_t and dq_t as 64 floats a thread, more than the
// 128 registers that 512 threads a block leave, so 256 (the forward, which
// needs fewer, takes the same bound).
template <int DP> constexpr int max_threads() { return DP == 64 ? 256 : 512; }

// Where the D-long row of (site n = b * S + s, frame t, head h) starts, in
// elements: b * b_ + t * t_ + s * s_ + h * h_. (N, T, H, D) tensors use S = 1,
// s_ = 0 and b_ = the site stride.
struct Map {
  long long b_, t_, s_, h_;
  __device__ __forceinline__ long long at(long long b, int t, long long s, int h) const {
    return b * b_ + t * t_ + s * s_ + h * h_;
  }
};

// A row of DP elements of type T in shared memory, read and written 16 bytes
// at a time: EPC elements a piece, PITCH elements from one row to the next.
// A head dim D below DP (the ragged path) fills columns D..DP with zeros.
template <typename T, int DP> struct Row {
  static constexpr int EPC = 16 / (int)sizeof(T);
  static constexpr int PIECES = DP / EPC;
  static constexpr int PITCH = DP + EPC;
};

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __ushort_as_bfloat16(0);
}

// 16 bytes of shared memory as floats.
__device__ __forceinline__ void load16(const float* p, float* x) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* x) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // a bf16 is the high half of its float
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Floats rounded to T, 16 bytes into shared memory.
__device__ __forceinline__ void store16(float* p, const float* x) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* x) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(hma_mma::pack_bf16(x[0], x[1]), hma_mma::pack_bf16(x[2], x[3]),
                 hma_mma::pack_bf16(x[4], x[5]), hma_mma::pack_bf16(x[6], x[7]));
}

template <typename T, int D>
__device__ __forceinline__ void load_row(const T* row, float (&x)[D]) {
  using R = Row<T, D>;
#pragma unroll
  for (int c = 0; c < R::PIECES; ++c) load16(row + c * R::EPC, x + c * R::EPC);
}

template <typename T, int D>
__device__ __forceinline__ void store_row(T* row, const float (&x)[D]) {
  using R = Row<T, D>;
#pragma unroll
  for (int c = 0; c < R::PIECES; ++c) store16(row + c * R::EPC, x + c * R::EPC);
}

// a . row in fp32, four partial sums (d mod 4) added pairwise at the end.
template <typename T, int D>
__device__ __forceinline__ float dot(const float (&a)[D], const T* row) {
  using R = Row<T, D>;
  float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int c = 0; c < R::PIECES; ++c) {
    float x[R::EPC];
    load16(row + c * R::EPC, x);
#pragma unroll
    for (int e = 0; e < R::EPC; ++e)
      part[e % 4] = fmaf(a[c * R::EPC + e], x[e], part[e % 4]);
  }
  return (part[0] + part[1]) + (part[2] + part[3]);
}

// acc += w * row in fp32.
template <typename T, int D>
__device__ __forceinline__ void axpy(float w, const T* row, float (&acc)[D]) {
  using R = Row<T, D>;
#pragma unroll
  for (int c = 0; c < R::PIECES; ++c) {
    float x[R::EPC];
    load16(row + c * R::EPC, x);
#pragma unroll
    for (int e = 0; e < R::EPC; ++e) acc[c * R::EPC + e] = fmaf(w, x[e], acc[c * R::EPC + e]);
  }
}

// A tile's rows: row index t * R + r in shared memory holds (row sh0 + r of
// the flattened (site, head) axis, frame t). `Tile` finds where a piece of it
// lives in global memory.
struct Tile {
  int sh0, NH, S, H, T_len, R, lr;  // lr = log2(R); the launcher keeps N H < 2^31

  // Shared row `row` of the tile: its (b, t, s, h); false past NH.
  __device__ __forceinline__ bool at(int row, int& b, int& t, int& s, int& h) const {
    t = row >> lr;
    const int sh = sh0 + (row & (R - 1));
    if (sh >= NH) return false;
    const int n = sh / H;
    h = sh - n * H;
    b = n / S;
    s = n - b * S;
    return true;
  }

  // Piece i of the tile, whose rows have `pieces` pieces: its shared row,
  // the element offset in it, and the row's (b, t, s, h); false past NH.
  __device__ __forceinline__ bool piece(int i, int pieces, int epc, int& row, int& e,
                                        int& b, int& t, int& s, int& h) const {
    row = i / pieces;
    e = (i - row * pieces) * epc;
    return at(row, b, t, s, h);
  }
};

// Copy COUNT tensors' rows of the tile into shared memory, src[c] with
// map[c] into dst + c * rows * PITCH, 16 bytes a cp.async, neighbouring
// threads on neighbouring pieces. Aligned path: the rows themselves. Ragged
// (D < DP, rows at any alignment): the 16-byte-aligned chunks that cover
// each row, from a - (a mod 16) for a row at byte address a, PIECES + 1 of
// them at most (a mod 16 + D sizeof(T) < PITCH sizeof(T)), as they stand;
// `align_tile` then moves each row to its slot's start. So up to 15 bytes
// before and after a row are read, never outside its 16-byte-aligned extent
// (no chunk past the one with the row's last element).
template <typename T, int DP, int COUNT, bool RAGGED>
__device__ __forceinline__ void stage_tile(const Tile& tl, T* dst,
                                           const T* const (&src)[COUNT],
                                           const Map (&map)[COUNT], int D) {
  using RW = Row<T, DP>;
  constexpr int PIECES = RAGGED ? RW::PIECES + 1 : RW::PIECES;
  const int rows = tl.T_len * tl.R;
  for (int i = threadIdx.x; i < rows * PIECES; i += blockDim.x) {
    int row, e, t, h, b = 0, s = 0;
    const bool valid = tl.piece(i, PIECES, RW::EPC, row, e, b, t, s, h);
#pragma unroll
    for (int c = 0; c < COUNT; ++c) {
      T* slot = dst + (c * rows + row) * RW::PITCH + e;
      if constexpr (RAGGED) {
        const uintptr_t a = reinterpret_cast<uintptr_t>(src[c] + (valid ? map[c].at(b, t, s, h) : 0));
        const int lead = (int)(a & 15);
        const bool live = valid && e * (int)sizeof(T) < lead + D * (int)sizeof(T);
        hma_mma::cp_async16(slot, reinterpret_cast<const void*>(
                                      (a - lead) + (live ? e * sizeof(T) : 0)), live);
      } else {
        hma_mma::cp_async16(slot, src[c] + (valid ? map[c].at(b, t, s, h) + e : 0), valid);
      }
    }
  }
}

// The ragged path, once stage_tile's copies have landed (and a barrier):
// shift each row of the COUNT tensors' tiles left by its lead (a mod 16
// bytes, as stage_tile found it) and zero columns D..DP, one warp a row, the
// COUNT tensors' reads before their writes. A barrier must follow before the
// tiles are read. Nothing on the aligned path.
template <typename T, int DP, int COUNT, bool RAGGED>
__device__ __forceinline__ void align_tile(const Tile& tl, T* dst, const T* const (&src)[COUNT],
                                           const Map (&map)[COUNT], int D) {
  if constexpr (RAGGED) {
    constexpr int PER = (DP + 31) / 32;
    const int lane = threadIdx.x & 31, rows = tl.T_len * tl.R;
    for (int row = threadIdx.x >> 5; row < rows; row += blockDim.x >> 5) {
      int t, h, b = 0, s = 0;
      const bool valid = tl.at(row, b, t, s, h);
      T x[COUNT][PER];
#pragma unroll
      for (int c = 0; c < COUNT; ++c) {
        const int shift =
            valid ? (int)(reinterpret_cast<uintptr_t>(src[c] + map[c].at(b, t, s, h)) & 15) /
                        (int)sizeof(T)
                  : 0;
        const T* r = dst + (c * rows + row) * Row<T, DP>::PITCH;
#pragma unroll
        for (int k = 0; k < PER; ++k) {
          const int j = lane + 32 * k;
          x[c][k] = j < D ? r[j + shift] : zero<T>();
        }
      }
      __syncwarp();
#pragma unroll
      for (int c = 0; c < COUNT; ++c)
#pragma unroll
        for (int k = 0; k < PER; ++k)
          if (lane + 32 * k < DP) dst[(c * rows + row) * Row<T, DP>::PITCH + lane + 32 * k] = x[c][k];
    }
  }
}

// The ragged path's output store: shared row `row` (pitch PITCH) of smem[c]
// goes to the global row of (b, t, s, h) at element offset ((b * T + t) * S
// + s) * g_row + h * D, its D real elements one by one, one warp a row. (The
// aligned path stores whole rows, 16 bytes a store, in the kernels.)
template <typename T, int DP, int COUNT>
__device__ __forceinline__ void store_tile_ragged(const Tile& tl, T* const (&dst)[COUNT],
                                                  const T* const (&smem)[COUNT],
                                                  long long g_row, int D) {
  const int lane = threadIdx.x & 31, rows = tl.T_len * tl.R;
  for (int row = threadIdx.x >> 5; row < rows; row += blockDim.x >> 5) {
    int t, h, b = 0, s = 0;
    if (!tl.at(row, b, t, s, h)) continue;
    const long long g = (((long long)b * tl.T_len + t) * tl.S + s) * g_row + h * D;
    for (int j = lane; j < D; j += 32)
#pragma unroll
      for (int c = 0; c < COUNT; ++c) dst[c][g + j] = smem[c][row * Row<T, DP>::PITCH + j];
  }
}

// out (written contiguous as (B, T, S, H, D)) and the fp32 lse ((B*S, H, T)).
// Dynamic shared memory: q, k, v of the tile (T_len * R rows each), then the
// scores of the causal triangle in fp32 (T_len (T_len + 1) / 2 pairs of R
// rows: the thread of (r, t) keeps its row's at (t (t + 1) / 2 + j) R + r).
// q and k arrive as one group of copies, v as a second, which lands while
// the scores are computed.
template <typename T, int D, bool RAGGED>
__global__ void __launch_bounds__(max_threads<D>())
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           T* __restrict__ out, float* __restrict__ lse, long long N, int S, int T_len,
           int H, int R, int D_true, Map mq, Map mk, Map mv) {
  using RW = Row<T, D>;
  const int Dn = RAGGED ? D_true : D;  // a row's real elements
  constexpr int P = RW::PITCH;
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = T_len * R;
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + rows * P;
  T* Vs = Ks + rows * P;
  float* Ss = reinterpret_cast<float*>(Vs + rows * P);
  const Tile tl{(int)blockIdx.x * R, (int)(N * H), S, H, T_len, R, __ffs(R) - 1};
  const T* const qk[2] = {q, k};
  const Map mqk[2] = {mq, mk};
  const T* const vv[1] = {v};
  const Map mvv[1] = {mv};
  stage_tile<T, D, 2, RAGGED>(tl, Qs, qk, mqk, Dn);
  hma_mma::cp_async_commit();
  stage_tile<T, D, 1, RAGGED>(tl, Vs, vv, mvv, Dn);
  hma_mma::cp_async_commit();
  hma_mma::cp_async_wait<1>();
  __syncthreads();
  if constexpr (RAGGED) {
    align_tile<T, D, 2, RAGGED>(tl, Qs, qk, mqk, Dn);
    __syncthreads();
  }

  const int lane = threadIdx.x & 31;
  const int r = lane & (R - 1);
  const int t = (threadIdx.x >> 5) * (32 / R) + (lane >> tl.lr);
  const int sh = tl.sh0 + r;
  const bool mine = t < T_len && sh < tl.NH;
  float* sc = Ss + (t * (t + 1) / 2) * R + r;  // sc[j * R]: this row's scores
  float m = -INFINITY, l = 0.f;
  if (mine) {
    {
      float qf[D];
      load_row<T, D>(Qs + (t * R + r) * P, qf);
#pragma unroll 1
      for (int j = 0; j <= t; ++j) {
        const float s = dot<T, D>(qf, Ks + (j * R + r) * P);
        sc[j * R] = s;
        m = fmaxf(m, s);
      }
    }
#pragma unroll 1
    for (int j = 0; j <= t; ++j) {
      const float e = expf(sc[j * R] - m);
      sc[j * R] = e;
      l += e;
    }
  }
  hma_mma::cp_async_wait<0>();
  __syncthreads();
  if constexpr (RAGGED) {
    align_tile<T, D, 1, RAGGED>(tl, Vs, vv, mvv, Dn);
    __syncthreads();
  }
  if (mine) {
    float acc[D];
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] = 0.f;
#pragma unroll 1
    for (int j = 0; j <= t; ++j) axpy<T, D>(sc[j * R] / l, Vs + (j * R + r) * P, acc);
    store_row<T, D>(Qs + (t * R + r) * P, acc);  // out over q: only this thread read it
    lse[(long long)sh * T_len + t] = m + logf(l);
  }
  __syncthreads();

  if constexpr (RAGGED) {
    T* const dst[1] = {out};
    const T* const src[1] = {Qs};
    store_tile_ragged<T, D, 1>(tl, dst, src, (long long)H * Dn, Dn);
  } else {
    for (int i = threadIdx.x; i < rows * RW::PIECES; i += blockDim.x) {
      int row, e, t2, h, b = 0, s = 0;
      if (!tl.piece(i, RW::PIECES, RW::EPC, row, e, b, t2, s, h)) continue;
      *reinterpret_cast<uint4*>(out + ((((long long)b * T_len + t2) * S + s) * H + h) * D + e) =
          *reinterpret_cast<const uint4*>(Qs + row * P + e);
    }
  }
}

// dq, dk, dv: the row of (b, t, s) starts at ((b * T + t) * S + s) * g_row + h * D
// of its own pointer; g_row = H * D for three contiguous (B, T, S, H, D)
// tensors, 3 * H * D for the three slots of one (B, T, S, 3, H, D) buffer.
// Dynamic shared memory: q, k, v, out, dout of the tile (T_len * R rows
// each), then p and ds in fp32 over the causal triangle (T_len (T_len + 1) / 2
// pairs of R rows each).
template <typename T, int D, bool RAGGED>
__global__ void __launch_bounds__(max_threads<D>())
bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const T* __restrict__ out, const float* __restrict__ lse,
           const T* __restrict__ dout, T* __restrict__ dq, T* __restrict__ dk,
           T* __restrict__ dv, long long N, int S, int T_len, int H, int R, int D_true,
           Map mq, Map mk, Map mv, Map mo, Map md, long long g_row) {
  using RW = Row<T, D>;
  const int Dn = RAGGED ? D_true : D;  // a row's real elements
  constexpr int P = RW::PITCH;
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = T_len * R;
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + rows * P;
  T* Vs = Ks + rows * P;
  T* Os = Vs + rows * P;
  T* Ds = Os + rows * P;
  float* Ps = reinterpret_cast<float*>(Ds + rows * P);
  float* DSs = Ps + (T_len * (T_len + 1) / 2) * R;
  const Tile tl{(int)blockIdx.x * R, (int)(N * H), S, H, T_len, R, __ffs(R) - 1};
  {
    const T* const src[5] = {q, k, v, out, dout};
    const Map map[5] = {mq, mk, mv, mo, md};
    stage_tile<T, D, 5, RAGGED>(tl, Qs, src, map, Dn);
    hma_mma::cp_async_commit();
    if constexpr (RAGGED) {
      hma_mma::cp_async_wait<0>();
      __syncthreads();
      align_tile<T, D, 5, RAGGED>(tl, Qs, src, map, Dn);
    }
  }
  hma_mma::cp_async_wait<0>();
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int r = lane & (R - 1);
  const int t = (threadIdx.x >> 5) * (32 / R) + (lane >> tl.lr);  // phase (b): j
  const int sh = tl.sh0 + r;
  const bool mine = t < T_len && sh < tl.NH;

  // (a) the thread of (r, t): delta_t, p and ds of its causal row, dq_t
  if (mine) {
    float dof[D], qf[D], dqa[D];
    load_row<T, D>(Ds + (t * R + r) * P, dof);
    load_row<T, D>(Qs + (t * R + r) * P, qf);
    const float delta = dot<T, D>(dof, Os + (t * R + r) * P);
    const float lt = lse[(long long)sh * T_len + t];
#pragma unroll
    for (int d = 0; d < D; ++d) dqa[d] = 0.f;
    const int tri = t * (t + 1) / 2;
#pragma unroll 1
    for (int j = 0; j <= t; ++j) {
      const T* krow = Ks + (j * R + r) * P;
      const float p = expf(dot<T, D>(qf, krow) - lt);
      const float ds = p * (dot<T, D>(dof, Vs + (j * R + r) * P) - delta);
      Ps[(tri + j) * R + r] = p;
      DSs[(tri + j) * R + r] = ds;
      axpy<T, D>(ds, krow, dqa);
    }
    store_row<T, D>(Os + (t * R + r) * P, dqa);  // dq over out: only this thread read it
  }
  __syncthreads();

  // (b) the thread of (r, j = t): dk_j and dv_j over the frames t >= j
  if (mine) {
    const int j = t;
    float dka[D], dva[D];
#pragma unroll
    for (int d = 0; d < D; ++d) dka[d] = dva[d] = 0.f;
#pragma unroll 1
    for (int tt = j; tt < T_len; ++tt) {
      const int idx = (tt * (tt + 1) / 2 + j) * R + r;
      axpy<T, D>(DSs[idx], Qs + (tt * R + r) * P, dka);
      axpy<T, D>(Ps[idx], Ds + (tt * R + r) * P, dva);
    }
    store_row<T, D>(Ks + (j * R + r) * P, dka);  // k and v are read no more
    store_row<T, D>(Vs + (j * R + r) * P, dva);
  }
  __syncthreads();

  if constexpr (RAGGED) {
    T* const dst[3] = {dq, dk, dv};
    const T* const src[3] = {Os, Ks, Vs};
    store_tile_ragged<T, D, 3>(tl, dst, src, g_row, Dn);
  } else {
    for (int i = threadIdx.x; i < rows * RW::PIECES; i += blockDim.x) {
      int row, e, t2, h, b = 0, s = 0;
      if (!tl.piece(i, RW::PIECES, RW::EPC, row, e, b, t2, s, h)) continue;
      const long long g = (((long long)b * T_len + t2) * S + s) * g_row + h * D + e;
      const int o = row * P + e;
      *reinterpret_cast<uint4*>(dq + g) = *reinterpret_cast<const uint4*>(Os + o);
      *reinterpret_cast<uint4*>(dk + g) = *reinterpret_cast<const uint4*>(Ks + o);
      *reinterpret_cast<uint4*>(dv + g) = *reinterpret_cast<const uint4*>(Vs + o);
    }
  }
}

template <typename T, int D>
constexpr long long fwd_bytes(int T_len, int R) {
  return 3LL * T_len * R * Row<T, D>::PITCH * (long long)sizeof(T) +
         (T_len * (T_len + 1) / 2) * R * (long long)sizeof(float);
}

template <typename T, int D>
constexpr long long bwd_bytes(int T_len, int R) {
  return 5LL * T_len * R * Row<T, D>::PITCH * (long long)sizeof(T) +
         2LL * (T_len * (T_len + 1) / 2) * R * (long long)sizeof(float);
}

// The tile's rows R (32, 16, 8 or 4): the largest whose shared memory fits
// `budget` with at most `threads` threads, else the largest that fits a
// block at all; 0 if none does.
inline int tile_rows(int T_len, int threads, long long budget,
                     long long (*bytes)(int, int)) {
  const long long budgets[2] = {budget, MAX_SMEM};
  for (long long b : budgets)
    for (int R = 32; R >= 4; R /= 2)
      if (32 * ((T_len + 32 / R - 1) / (32 / R)) <= threads && bytes(T_len, R) <= b)
        return R;
  return 0;
}

// Above 48 KB a kernel must ask for its shared memory, once a device.
template <typename K>
inline cudaError_t opt_in(K kernel, unsigned& done) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (done >> dev & 1u) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (err == cudaSuccess) done |= 1u << dev;
  return err;
}

template <typename T, int D, bool RAGGED>
int launch_fwd_t(const void* q, const void* k, const void* v, void* out, void* lse,
                 long long N, int S, int T_len, int H, int D_true, Map mq, Map mk, Map mv,
                 cudaStream_t stream) {
  static unsigned opted_in = 0;
  const int R = tile_rows(T_len, max_threads<D>(), FWD_TILE_BYTES, fwd_bytes<T, D>);
  if (R == 0) return (int)cudaErrorInvalidValue;
  const cudaError_t err = opt_in(fwd_kernel<T, D, RAGGED>, opted_in);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (N * H + R - 1) / R;
  const int threads = 32 * ((T_len + 32 / R - 1) / (32 / R));
  fwd_kernel<T, D, RAGGED>
      <<<(unsigned)tiles, threads, (size_t)fwd_bytes<T, D>(T_len, R), stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
          static_cast<T*>(out), static_cast<float*>(lse), N, S, T_len, H, R, D_true, mq, mk,
          mv);
  return (int)cudaGetLastError();
}

template <typename T, int D, bool RAGGED>
int launch_bwd_t(const void* q, const void* k, const void* v, const void* out,
                 const void* lse, const void* dout, void* dq, void* dk, void* dv,
                 long long N, int S, int T_len, int H, int D_true, Map mq, Map mk, Map mv,
                 Map mo, Map md, long long g_row, cudaStream_t stream) {
  static unsigned opted_in = 0;
  const int R = tile_rows(T_len, max_threads<D>(), BWD_TILE_BYTES, bwd_bytes<T, D>);
  if (R == 0) return (int)cudaErrorInvalidValue;
  const cudaError_t err = opt_in(bwd_kernel<T, D, RAGGED>, opted_in);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (N * H + R - 1) / R;
  const int threads = 32 * ((T_len + 32 / R - 1) / (32 / R));
  bwd_kernel<T, D, RAGGED>
      <<<(unsigned)tiles, threads, (size_t)bwd_bytes<T, D>(T_len, R), stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
          static_cast<const T*>(out), static_cast<const float*>(lse),
          static_cast<const T*>(dout), static_cast<T*>(dq), static_cast<T*>(dk),
          static_cast<T*>(dv), N, S, T_len, H, R, D_true, mq, mk, mv, mo, md, g_row);
  return (int)cudaGetLastError();
}

// Launch the forward for dtype 0 (float32) or 1 (bfloat16) and any head dim
// D from 1 to 64; returns cudaGetLastError(), or cudaErrorInvalidValue for
// anything else.
inline int launch_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                      long long N, int S, int T_len, int H, int D, int dtype, Map mq,
                      Map mk, Map mv, cudaStream_t stream) {
  if (N <= 0 || S <= 0 || H <= 0 || T_len <= 0 || T_len > MAX_T || N * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  return hma_mma::dispatch(dtype, D, [&](auto body) {
    using B = decltype(body);
    return launch_fwd_t<typename B::T, B::DP, B::RAGGED>(q, k, v, out, lse, N, S, T_len, H,
                                                          D, mq, mk, mv, stream);
  });
}

inline int launch_bwd(const void* q, const void* k, const void* v, const void* out,
                      const void* lse, const void* dout, void* dq, void* dk, void* dv,
                      long long N, int S, int T_len, int H, int D, int dtype, Map mq,
                      Map mk, Map mv, Map mo, Map md, long long g_row,
                      cudaStream_t stream) {
  if (N <= 0 || S <= 0 || H <= 0 || T_len <= 0 || T_len > MAX_T || N * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  return hma_mma::dispatch(dtype, D, [&](auto body) {
    using B = decltype(body);
    return launch_bwd_t<typename B::T, B::DP, B::RAGGED>(q, k, v, out, lse, dout, dq, dk, dv,
                                                          N, S, T_len, H, D, mq, mk, mv, mo,
                                                          md, g_row, stream);
  });
}

}  // namespace
}  // namespace hma_temporal
