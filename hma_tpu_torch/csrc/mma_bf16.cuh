// Tensor-core and asynchronous-copy building blocks of the bf16 spatial
// attention kernels (K1' forward, K2' backward), for sm_90a.
//
// Fragment layouts of mma.sync.m16n8k16 (bf16 operands, fp32 accumulators),
// with g = lane / 4 and t = lane % 4:
//   A (16 x 16, row-major), 4 registers of two bf16 (low half = lower column):
//     a0 = (g, 2t..2t+1)  a1 = (g+8, 2t..2t+1)  a2 = (g, 8+2t..)  a3 = (g+8, 8+2t..)
//   B (16 x 8, k x n), 2 registers: b0 = (k 2t..2t+1, n g)  b1 = (k 8+2t.., n g)
//   C (16 x 8 fp32), 4 floats: c0, c1 = (g, 2t..2t+1)  c2, c3 = (g+8, 2t..2t+1)
// So the C fragments of two neighbouring n-tiles, packed to bf16 pairwise, are
// the A fragment of their 16 columns: {pack(c0,c1) of tile 0, pack(c2,c3) of
// tile 0, pack(c0,c1) of tile 1, pack(c2,c3) of tile 1}.
//
// Tiles live in shared memory as rows of DP bf16 with a pitch of DP + 8
// elements (48, 80 or 144 bytes at DP 16, 32, 64): the eight 16-byte rows an
// ldmatrix phase reads then fall in eight different bank groups, and every
// row start stays 16-byte aligned for cp.async.
//
// Head dims: DP is 16, 32 or 64, the width the products run at. A head dim D
// of exactly DP takes the aligned path (16-byte cp.async copies, 2-element
// stores). Any other D <= 64 takes the ragged path at the next DP: its rows
// (D elements, 2-byte aligned inside a (..., 3, H, D) projection) are copied
// as the 16-byte-aligned chunks that cover them, then shifted into place in
// shared memory with columns D..DP zero-filled, so every product over the DP
// columns equals the product over D (the extra terms are 0 x 0), the padded
// output columns come out 0, and only the D real columns are stored.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hma_mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !valid (src is
// then not read, but must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes global -> shared; zero-filled when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Wait until at most n groups are pending (n clamped to 7: waiting for more
// groups than needed is always safe).
__device__ __forceinline__ void cp_async_wait_at_most(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

constexpr float LOG2E = 1.4426950408889634f;

// 2^x on the special-function unit, subnormal results flushed to 0 (they
// are below what a bf16 probability next to a maximum of 1 can hold). The
// kernels take exp(s - c) as exp2(s log2(e) - c log2(e)), one fma and this.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Four 8 x 8 b16 matrices; lane l gives the row address of matrix l / 8,
// row l % 8. Register i holds matrix i's (row g, columns 2t..2t+1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The same, transposed: register i holds matrix i's (rows 2t..2t+1, column g).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a b, one m16n8k16 product, bf16 in, fp32 accumulate
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 values rounded to nearest bf16, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Stage rows [r0, r0 + ROWS) of a (row-strided, unit-D-stride) bf16 matrix
// into a shared tile of pitch D + 8, 16 bytes a copy; rows >= n are zeros.
template <int ROWS, int D, int THREADS>
__device__ __forceinline__ void load_rows(__nv_bfloat16 (*dst)[D + 8],
                                          const __nv_bfloat16* __restrict__ src,
                                          long long row_stride, int r0, int n) {
  constexpr int CHUNKS = D / 8;  // 16-byte pieces a row
  static_assert(ROWS * CHUNKS % THREADS == 0, "whole copies a thread");
#pragma unroll
  for (int k = 0; k < ROWS * CHUNKS / THREADS; ++k) {
    const int i = threadIdx.x + k * THREADS;
    const int r = i / CHUNKS, c = i % CHUNKS;
    const bool valid = r0 + r < n;
    const __nv_bfloat16* p = src + (valid ? (long long)(r0 + r) * row_stride + c * 8 : 0);
    cp_async16(&dst[r][c * 8], p, valid);
  }
}

// The ragged path's load_rows: rows of D < DP elements at any 2-byte
// alignment. The row starting at byte address a lies in the 16-byte chunks
// from a - (a mod 16) on; those that hold its elements, at most DP / 8 + 1 of
// them (a mod 16 + 2 D < 2 DP + 16 bytes, the slot's pitch), are copied by
// 16-byte cp.async into its slot as they stand. `align_rows` then moves each
// row to the slot's start. Rows >= n are zeros. So up to 15 bytes before and
// after the row are read, never outside its 16-byte-aligned extent (no chunk
// past the one with the row's last element).
template <int ROWS, int DP, int THREADS>
__device__ __forceinline__ void load_rows_ragged(__nv_bfloat16 (*dst)[DP + 8],
                                                 const __nv_bfloat16* __restrict__ src,
                                                 long long row_stride, int r0, int n, int D) {
  constexpr int CHUNKS = DP / 8 + 1;  // 16-byte pieces a slot
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = i % CHUNKS;
    const bool live = r0 + r < n;
    const uintptr_t a = reinterpret_cast<uintptr_t>(src + (live ? (long long)(r0 + r) * row_stride : 0));
    const int lead = (int)(a & 15);
    const bool valid = live && 16 * c < lead + 2 * D;
    cp_async16(&dst[r][c * 8], reinterpret_cast<const void*>((a - lead) + (valid ? 16 * c : 0)),
               valid);
  }
}

// After the ragged path's copies have landed (and a barrier): shift each row
// of the tile left by its lead (a mod 16 bytes, as load_rows_ragged found it)
// and zero columns D..DP, one warp a row, U rows a warp at a time (all their
// reads before their writes). A barrier must follow before the tile is read.
template <int ROWS, int DP, int THREADS>
__device__ __forceinline__ void align_rows(__nv_bfloat16 (*tile)[DP + 8],
                                           const __nv_bfloat16* __restrict__ src,
                                           long long row_stride, int r0, int n, int D) {
  constexpr int PER = (DP + 31) / 32, WARPS = THREADS / 32;
  constexpr int U = ROWS / WARPS < 4 ? ROWS / WARPS : 4;
  static_assert(ROWS % (WARPS * U) == 0, "whole batches of rows a warp");
  const int lane = threadIdx.x & 31;
  for (int r1 = (threadIdx.x >> 5) * U; r1 < ROWS; r1 += WARPS * U) {
    unsigned short x[U][PER];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = r1 + u;
      const int shift = r0 + r < n ? (int)(reinterpret_cast<uintptr_t>(
                                               src + (long long)(r0 + r) * row_stride) & 15) / 2
                                   : 0;
      const unsigned short* row = reinterpret_cast<const unsigned short*>(tile[r]);
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int j = lane + 32 * k;
        x[u][k] = j < D ? row[j + shift] : 0;
      }
    }
    __syncwarp();
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int k = 0; k < PER; ++k)
        if (lane + 32 * k < DP) reinterpret_cast<unsigned short*>(tile[r1 + u])[lane + 32 * k] = x[u][k];
  }
}

// Stage rows as the path of (DP, RAGGED) does: 16-byte cp.async copies of
// whole rows, or (ragged) of the chunks covering each row, which `realign`
// then moves into place.
template <int ROWS, int DP, int THREADS, bool RAGGED>
__device__ __forceinline__ void stage_rows(__nv_bfloat16 (*dst)[DP + 8],
                                           const __nv_bfloat16* __restrict__ src,
                                           long long row_stride, int r0, int n, int D) {
  if constexpr (RAGGED) load_rows_ragged<ROWS, DP, THREADS>(dst, src, row_stride, r0, n, D);
  else load_rows<ROWS, DP, THREADS>(dst, src, row_stride, r0, n);
}

// The ragged path's second step of stage_rows (nothing on the aligned path).
template <int ROWS, int DP, int THREADS, bool RAGGED>
__device__ __forceinline__ void realign(__nv_bfloat16 (*tile)[DP + 8],
                                        const __nv_bfloat16* __restrict__ src,
                                        long long row_stride, int r0, int n, int D) {
  if constexpr (RAGGED) align_rows<ROWS, DP, THREADS>(tile, src, row_stride, r0, n, D);
}

// Stage floats [r0, r0 + N) of an fp32 vector into shared memory; zeros past n.
template <int N, int THREADS>
__device__ __forceinline__ void load_floats(float* dst, const float* __restrict__ src,
                                            int r0, int n) {
  for (int i = threadIdx.x; i < N; i += THREADS) {
    const bool valid = r0 + i < n;
    cp_async4(dst + i, src + (valid ? r0 + i : 0), valid);
  }
}

// A fragments of a warp's 16 rows x D columns from a shared tile: a[kc]
// covers columns 16 kc .. 16 kc + 15.
template <int D>
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[D / 16][4],
                                             const __nv_bfloat16 (*tile)[D + 8], int row0) {
  const int lane = threadIdx.x & 31, idx = lane >> 3, r = lane & 7;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc)
    ldmatrix_x4(a[kc], &tile[row0 + r + (idx & 1) * 8][kc * 16 + (idx >> 1) * 8]);
}

// (c0, c1) += a . tile[n0 .. n0 + 16)^T: a warp's A fragments (16 x D)
// times 16 rows of a shared tile read as the B operand (k = the D columns,
// n = the rows), two n-tiles of 8.
template <int D>
__device__ __forceinline__ void mma_rows_t(float (&c0)[4], float (&c1)[4],
                                           const uint32_t (&a)[D / 16][4],
                                           const __nv_bfloat16 (*tile)[D + 8], int n0) {
  const int lane = threadIdx.x & 31, idx = lane >> 3, r = lane & 7;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    uint32_t b[4];
    ldmatrix_x4(b, &tile[n0 + r + (idx >> 1) * 8][kc * 16 + (idx & 1) * 8]);
    mma16816(c0, a[kc], b[0], b[1]);
    mma16816(c1, a[kc], b[2], b[3]);
  }
}

// c[0 .. D/8) += a . tile[k0 .. k0 + 16): a 16 x 16 A fragment times 16 rows
// of a shared tile read as the B operand (k = the rows, n = the D columns).
template <int D>
__device__ __forceinline__ void mma_rows(float (&c)[D / 8][4], const uint32_t (&a)[4],
                                         const __nv_bfloat16 (*tile)[D + 8], int k0) {
  const int lane = threadIdx.x & 31, idx = lane >> 3, r = lane & 7;
#pragma unroll
  for (int dn = 0; dn < D / 16; ++dn) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, &tile[k0 + r + (idx & 1) * 8][dn * 16 + (idx >> 1) * 8]);
    mma16816(c[2 * dn], a, b[0], b[1]);
    mma16816(c[2 * dn + 1], a, b[2], b[3]);
  }
}

// The A fragment of two C n-tiles (16 x 16), each value rounded to bf16.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Write a warp's 16 x DP fp32 C fragments as bf16 rows row0 + (g, g + 8) of
// a (row-strided) output; rows >= n are not written. Aligned path: two
// elements a store. Ragged: one element a store, columns >= D not written.
template <int DP, bool RAGGED = false>
__device__ __forceinline__ void store_c(__nv_bfloat16* __restrict__ dst, long long row_stride,
                                        const float (&c)[DP / 8][4], int row0, int n,
                                        int D = DP) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + g + 8 * half;
    if (row >= n) continue;
    __nv_bfloat16* o = dst + (long long)row * row_stride + 2 * t;
#pragma unroll
    for (int nt = 0; nt < DP / 8; ++nt) {
      if constexpr (RAGGED) {
        const int col = nt * 8 + 2 * t;
        if (col < D) o[nt * 8] = __float2bfloat16_rn(c[nt][2 * half]);
        if (col + 1 < D) o[nt * 8 + 1] = __float2bfloat16_rn(c[nt][2 * half + 1]);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(o + nt * 8) =
            __floats2bfloat162_rn(c[nt][2 * half], c[nt][2 * half + 1]);
      }
    }
  }
}

// Two bf16 of a global row at columns col and col + 1 as a B-fragment
// register (col in the low half); ragged: each element past D reads as 0.
template <bool RAGGED>
__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* __restrict__ row, int col,
                                              int D) {
  if constexpr (!RAGGED) return *reinterpret_cast<const uint32_t*>(row + col);
  const unsigned short* s = reinterpret_cast<const unsigned short*>(row);
  const uint32_t lo = col < D ? s[col] : 0u, hi = col + 1 < D ? s[col + 1] : 0u;
  return lo | hi << 16;
}

// The padded width a head dim runs at: 16, 32 or 64 (0 past 64).
__host__ __device__ constexpr int padded_dim(int D) {
  return D <= 0 ? 0 : D <= 16 ? 16 : D <= 32 ? 32 : D <= 64 ? 64 : 0;
}

// The body an attention entry launches: compute type T, padded width DP,
// and whether it takes the ragged path.
template <typename T_, int DP_, bool RAGGED_> struct Body {
  using T = T_;
  static constexpr int DP = DP_;
  static constexpr bool RAGGED = RAGGED_;
};

// Host: return fn(Body<T, DP, RAGGED>{}) for dtype 0 (float32) or 1
// (bfloat16) and head dim D: DP = padded_dim(D), the aligned path where
// D == DP, the ragged one otherwise; cudaErrorInvalidValue for any other
// dtype or a D outside 1..64. fn returns an int.
template <typename F> inline int dispatch(int dtype, int D, F&& fn) {
  const int DP = padded_dim(D);
  const bool ragged = D != DP;
#define HMA_BODY(TT, DD)                                              \
  if (DP == DD) return ragged ? fn(Body<TT, DD, true>{}) : fn(Body<TT, DD, false>{});
  if (dtype == 0) {
    HMA_BODY(float, 16) HMA_BODY(float, 32) HMA_BODY(float, 64)
  } else if (dtype == 1) {
    HMA_BODY(__nv_bfloat16, 16) HMA_BODY(__nv_bfloat16, 32) HMA_BODY(__nv_bfloat16, 64)
  }
#undef HMA_BODY
  return (int)cudaErrorInvalidValue;
}

// Host: whether n blocks would give the current device fewer than two a SM
// (then a launcher halves its blocks' rows to double their number).
inline bool few_blocks(long long n) {
  static const int sms = [] {
    int dev = 0, count = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count > 0 ? count : 132;
  }();
  return n < 2LL * sms;
}

}  // namespace hma_mma
