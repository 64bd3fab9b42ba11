// Building blocks of the tensor-core patch-attention kernels
// (patch_attention_fwd.cu, patch_attention_bwd.cu), for Hopper (sm_90a);
// subm_conv.cu takes its copy, ldmatrix and mma primitives.
//
// Each warp owns 16 rows of one side as m16n8k16 A fragments; the other side
// streams through shared memory in bf16 tiles (cp.async, 16 bytes a thread),
// rows padded by 16 bytes so that ldmatrix is free of bank conflicts. Rows
// carry scene tags for the three tiers of masking (see Span). The constants a
// kernel tunes (rows per tile, warps per block) stay in its own source and
// reach these helpers as template arguments.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <initializer_list>

namespace {

using bf16 = __nv_bfloat16;

constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; zeros when !pred
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a b: a 16x16 bf16 (row), b 16x8 bf16 (col), c 16x8 f32
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a b + c, c in other registers (no copy into d first)
__device__ __forceinline__ void mma_c(float d[4], const uint32_t a[4], uint32_t b0,
                                      uint32_t b1, const float c[4]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(c[0]),
        "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}
__device__ __forceinline__ float2 unpack(uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
}

// The A fragment (m16n8k16) of one warp's 16 rows of an (N, H, D) array:
// rows lo = row0 + lane / 4 and hi = lo + 8 at element offsets base_lo and
// base_hi, columns 16 ks + 2 (lane % 4) (+ 8); zeros for rows outside the
// patch.
template <int D>
__device__ __forceinline__ void load_a(uint32_t a[D / 16][4], const bf16* x,
                                       int64_t base_lo, int64_t base_hi,
                                       bool in_lo, bool in_hi, int tq) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool in = (i & 1) ? in_hi : in_lo;
      const int64_t off = ((i & 1) ? base_hi : base_lo) + 16 * ks + 8 * (i >> 1) + 2 * tq;
      a[ks][i] = in ? __ldg(reinterpret_cast<const unsigned int*>(x + off)) : 0u;
    }
  }
}

// mul * an f32 accumulator of 16 x D (D / 8 tiles of m16n8) to bf16 rows.
template <int D>
__device__ __forceinline__ void store_c(bf16* x, const float c[D / 8][4], float mul,
                                        int64_t base_lo, int64_t base_hi,
                                        bool in_lo, bool in_hi, int tq) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = 8 * n + 2 * tq;
    if (in_lo) {
      *reinterpret_cast<uint32_t*>(x + base_lo + col) = pack(c[n][0] * mul, c[n][1] * mul);
    }
    if (in_hi) {
      *reinterpret_cast<uint32_t*>(x + base_hi + col) = pack(c[n][2] * mul, c[n][3] * mul);
    }
  }
}

// Rows of one side carry a scene tag: the scene id where the row takes part
// (a valid key; a query row of the patch, in the backward only one with a
// finite lse), else a negative value (-1 for keys, -2 for queries, so the
// two never match). A pair is allowed iff the
// tags are equal. A Span is the range of the tags >= 0 over a warp's rows
// (lo = INT_MAX and hi < 0 when there is none); `one` says that every row
// has the same tag >= 0.
struct Span {
  int lo, hi;
  bool one;
};

// the span over the warp of the tags of N rows in each lane
template <int N>
__device__ __forceinline__ Span span_of(const int (&tag)[N]) {
  int lo = INT_MAX, hi = INT_MIN;
  bool all = true;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    lo = min(lo, tag[i] >= 0 ? tag[i] : INT_MAX);
    hi = max(hi, tag[i]);
    all = all && tag[i] >= 0;
  }
  Span s;
  s.lo = __reduce_min_sync(kAll, lo);
  s.hi = __reduce_max_sync(kAll, hi);
  s.one = __all_sync(kAll, all) && s.lo == s.hi;
  return s;
}

__device__ __forceinline__ bool overlap(const Span& a, int lo, int hi) {
  return a.lo <= hi && a.hi >= lo;
}

// a streamed tile (n_tiles when there is none left) and the span of its tags
struct Next {
  int t;
  Span span;
};

// The tag range [lo, hi] over the block's Warps warps. All threads must
// call it.
template <int Warps>
__device__ __forceinline__ void block_range(const Span& w, int* lo, int* hi) {
  __shared__ int lo_s[Warps], hi_s[Warps];
  if ((threadIdx.x & 31) == 0) {
    lo_s[threadIdx.x >> 5] = w.lo;
    hi_s[threadIdx.x >> 5] = w.hi;
  }
  __syncthreads();
  *lo = INT_MAX;
  *hi = INT_MIN;
#pragma unroll
  for (int i = 0; i < Warps; ++i) {
    *lo = min(*lo, lo_s[i]);
    *hi = max(*hi, hi_s[i]);
  }
}

// Start the copy of rows t0 .. t0 + Cols - 1 of two (N, H, D) arrays into
// padded shared tiles, by a block of Threads threads: a and b point at the
// patch's first row of one head, rows are `stride` elements apart; rows past
// the patch read zeros.
template <int D, int Cols, int Threads>
__device__ __forceinline__ void load_tiles(bf16 (*a_dst)[D + 8], bf16 (*b_dst)[D + 8],
                                           const bf16* a, const bf16* b, int stride,
                                           int t0, int patch) {
  constexpr int kPieces = Cols * D / 8;  // 16-byte pieces of one tile
#pragma unroll
  for (int c0 = 0; c0 < 2 * kPieces; c0 += Threads) {
    const int c = c0 + threadIdx.x;
    if (c < 2 * kPieces) {
      const bool second = c >= kPieces;
      const int i = second ? c - kPieces : c;
      const int r = i / (D / 8), part = i % (D / 8);
      const bool in = t0 + r < patch;
      const bf16* from =
          (second ? b : a) + (in ? static_cast<int64_t>(t0 + r) * stride + 8 * part : 0);
      cp_async16(&(second ? b_dst : a_dst)[r][8 * part], from, in);
    }
  }
}

// Shared-memory addresses of the ldmatrix.x4 that gives the B fragments of
// two n8 tiles (rows r0 .. r0 + 15 of a tile) at k16 step ks: without .trans
// the tile's rows are the n index (s = q k^T), with .trans they are the k
// index (o += p v, dq += ds k).
template <int D>
__device__ __forceinline__ const bf16* b_rows(const bf16 (*t)[D + 8], int r0, int ks,
                                              int lane) {
  return &t[r0 + (lane & 7) + ((lane >> 4) << 3)][16 * ks + 8 * ((lane >> 3) & 1)];
}
template <int D>
__device__ __forceinline__ const bf16* b_cols(const bf16 (*t)[D + 8], int r0, int np,
                                              int lane) {
  return &t[r0 + (lane & 15)][16 * np + 8 * (lane >> 4)];
}

// The first tile of Cols keys from t on that a row of the block (tags in
// [lo, hi]) can see, with the span of its key tags; warp 0 writes the tags
// to `tags`. Every warp computes the same answer. The loads do not depend on
// each other (an index past the patch reads its last row), so they overlap.
template <int Cols>
__device__ __forceinline__ Next next_key_tile(int t, int n_tiles, int lo, int hi,
                                              const int32_t* __restrict__ batch,
                                              const uint8_t* __restrict__ valid,
                                              int64_t first, int patch, int* tags) {
  const int lane = threadIdx.x & 31;
  for (; t < n_tiles; ++t) {
    int tag[Cols / 32];
#pragma unroll
    for (int i = 0; i < Cols / 32; ++i) {
      const int key = t * Cols + 32 * i + lane;
      const int64_t at = first + min(key, patch - 1);
      const int scene = batch[at];
      const bool ok = key < patch && valid[at];
      tag[i] = ok ? scene : -1;
    }
    const Span span = span_of(tag);
    if (overlap(span, lo, hi)) {
      if (threadIdx.x < 32) {
#pragma unroll
        for (int i = 0; i < Cols / 32; ++i) tags[32 * i + lane] = tag[i];
      }
      return Next{t, span};
    }
  }
  return Next{n_tiles, Span{}};
}

// ---------------------------------------------------------------------------
// host side of the launches

bool bad_shape(int n, int heads, int head_dim, int patch) {
  return n <= 0 || patch <= 0 || heads <= 0 || n % patch != 0 ||
         n / patch > 65535 || heads > 65535 || (head_dim != 16 && head_dim != 32);
}

// the tensor-core kernels copy 16-byte pieces and read 4-byte pairs
bool misaligned(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs) {
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return true;
  }
  return false;
}

}  // namespace
