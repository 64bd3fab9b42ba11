// Masked patch attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel cdsegnet_tpu/ops/pallas/flash_attention.py::_attn_kernel.
// Points are serialized and cut into patches of `patch` consecutive rows; a
// query row attends to the keys of its own patch that are valid and belong to
// the same scene. q, k, v are contiguous (N, H, D) arrays, N = P * patch.
//
// What bounds it on this card: per allowed (query, key) pair and head the
// products are 4 D FLOPs (s = q.k, o += p v), cheap on the tensor cores at
// D = 16. What remains per pair is f32 work on the CUDA cores: one
// exponential on the SFU (16 a clock per SM, against 128 FMAs), the scale and
// max subtraction, the row max and sum, the pack to bf16 and, on boundary
// tiles, the mask. The bytes (q, k, v read once, o written once) are far
// below either.
//
// bf16 (the shipped type): patch_attention_fwd_mma_kernel, built as the
// backward's tensor-core kernels are (patch_attention_bwd.cu, with the
// building blocks in attention_tiles.cuh):
//  - one block per (patch, head, kRows query rows), kWarps warps of 16 query
//    rows; each warp holds its q rows as m16n8k16 A fragments; keys and
//    values stream through shared memory in bf16 tiles of kCols rows,
//    cp.async, double-buffered, rows padded against bank conflicts;
//  - s = q k^T (ldmatrix) and o += p v (ldmatrix.trans) with mma.sync, bf16
//    in, f32 accumulate; the f32 accumulator of two adjacent n8 tiles of s,
//    packed to bf16, is the A fragment of one k16 step of p v, so p never
//    leaves registers;
//  - the online softmax in log2 units, kChunk keys at a time: the scale is
//    applied to the f32 accumulator, not folded into q (which would round q
//    twice); a row's max is taken over the quad of lanes that holds it; the
//    running sums rescale by ex2(m_old - m_new); p = ex2.approx; the row sum
//    l adds the f32 p, so lse keeps f32 accuracy for the backward, and p is
//    rounded to bf16 only as the operand of p v, as the TPU kernel rounds p
//    to v's type before its product;
//  - masking in the backward's three tiers of scene tags (query: the row's
//    scene, -2 past the patch; key: the scene of a valid key, else -1): a key
//    tile that no row of the block can see is not loaded, one that no row of
//    the warp can see is not computed, and one that a single scene fills,
//    with the warp's rows in it too, takes an instantiation with no
//    per-element test.
//
// f32: patch_attention_fwd_kernel, the CUDA-core kernel of the first port and
// the exact route the f32 gates hold the port to: one block per (patch,
// head, 128 query rows), one query row per thread with q and an f32
// accumulator of D values in registers; keys and values stream through
// shared memory in f32 tiles of 64 keys; f32 FMAs, exp2f with scale *
// log2(e) folded into q; a key tile that no query of the block can see is
// skipped.
//
// Masking is exact: a masked key contributes exp2(-inf) = 0. A row with no
// allowed key (only padding rows have none: a valid row always sees itself)
// is written as zeros, so every output row is finite. Neither kernel takes
// -inf - -inf: the bf16 one subtracts 0 while a row's running max is -inf.
//
// Training passes `lse`, an f32 (N, H) array, and gets the row's natural
// log-sum-exp of the scaled logits, (m + log2 l) * ln 2; -inf on rows with
// no allowed key. The backward kernels (patch_attention_bwd.cu) recompute p
// from it. Inference passes null, and the bf16 kernel's instantiation
// without lse has no store of it.
//
// Plain C interface, loaded with ctypes; returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tiles.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// f32: CUDA-core kernel

constexpr int kQueryTile = 128;  // query rows per block, one per thread
constexpr int kKeyTile = 64;     // keys per shared-memory tile

template <int D>
__global__ void __launch_bounds__(kQueryTile)
patch_attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v,
                           const int32_t* __restrict__ batch,
                           const uint8_t* __restrict__ valid,
                           float* __restrict__ out, float* __restrict__ lse,
                           int heads, int patch, float scale_log2) {
  __shared__ __align__(16) float k_tile[kKeyTile][D];
  __shared__ __align__(16) float v_tile[kKeyTile][D];
  __shared__ int32_t key_scene[kKeyTile];
  __shared__ int key_visible[kKeyTile];
  __shared__ int32_t scene_lo, scene_hi;

  const int tid = threadIdx.x;
  const int head = blockIdx.y;
  const int64_t first = static_cast<int64_t>(blockIdx.z) * patch;
  const int row = blockIdx.x * kQueryTile + tid;  // row within the patch
  const bool active = row < patch;
  const int64_t qrow = first + (active ? row : 0);

  float qf[D];
  float acc[D];
  const float* qp = q + (qrow * heads + head) * D;
#pragma unroll
  for (int e = 0; e < D; ++e) {
    qf[e] = __ldg(qp + e) * scale_log2;
    acc[e] = 0.f;
  }
  const int32_t scene = batch[qrow];

  // scene range of this block's queries: keys outside it are seen by none
  if (tid == 0) {
    scene_lo = 0x7fffffff;
    scene_hi = -0x7fffffff - 1;
  }
  __syncthreads();
  if (active) {
    atomicMin(&scene_lo, scene);
    atomicMax(&scene_hi, scene);
  }
  __syncthreads();
  const int32_t lo = scene_lo;
  const int32_t hi = scene_hi;

  float m = -INFINITY;  // running max of the logits, in log2 units
  float l = 0.f;        // running sum of exp2(logit - m)
  for (int t0 = 0; t0 < patch; t0 += kKeyTile) {
    int visible = 0;
    if (tid < kKeyTile) {
      const int key = t0 + tid;
      int32_t b = 0;
      if (key < patch) {
        b = batch[first + key];
        visible = valid[first + key] && b >= lo && b <= hi;
      }
      key_scene[tid] = b;
      key_visible[tid] = visible;
    }
    // barrier for the key metadata; a tile no query can see is skipped
    if (!__syncthreads_or(visible)) continue;
    for (int i = tid; i < kKeyTile * D; i += kQueryTile) {
      const int j = i / D;
      const int e = i % D;
      const int key = t0 + j;
      float kx = 0.f, vx = 0.f;
      if (key < patch) {
        const int64_t off = ((first + key) * heads + head) * D + e;
        kx = __ldg(k + off);
        vx = __ldg(v + off);
      }
      k_tile[j][e] = kx;
      v_tile[j][e] = vx;
    }
    __syncthreads();
    if (active) {
      float s[kKeyTile];
      float tile_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < kKeyTile; ++j) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < D; ++e) dot = fmaf(qf[e], k_tile[j][e], dot);
        s[j] = (key_visible[j] && key_scene[j] == scene) ? dot : -INFINITY;
        tile_max = fmaxf(tile_max, s[j]);
      }
      if (tile_max > -INFINITY) {
        const float m_new = fmaxf(m, tile_max);
        const float corr = exp2f(m - m_new);  // 0 while m is still -inf
        l *= corr;
#pragma unroll
        for (int e = 0; e < D; ++e) acc[e] *= corr;
#pragma unroll
        for (int j = 0; j < kKeyTile; ++j) {
          const float p = exp2f(s[j] - m_new);
          l += p;
#pragma unroll
          for (int e = 0; e < D; ++e) acc[e] = fmaf(p, v_tile[j][e], acc[e]);
        }
        m = m_new;
      }
    }
    __syncthreads();
  }

  if (active) {
    const float inv = l > 0.f ? 1.f / l : 0.f;
    float* op = out + (qrow * heads + head) * D;
#pragma unroll
    for (int e = 0; e < D; ++e) op[e] = acc[e] * inv;
    if (lse != nullptr) {
      lse[qrow * heads + head] = l > 0.f ? (m + log2f(l)) * kLn2 : -INFINITY;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor-core kernel

constexpr int kWarps = 8;           // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // query rows per block, 16 per warp
constexpr int kCols = 128;          // keys per shared-memory tile
// keys per rescale of the online softmax: 32 keep the kernel at 64
// registers at D = 16, four blocks per SM; s of a whole 128-key tile (64 f32
// registers a thread) spills, or leaves room for one block per SM
constexpr int kChunk = 32;

// One warp's share of a key tile, kChunk keys at a time: s = q k^T, the
// online softmax of rows lo and hi (running max m and sum l, log2 units),
// then o += p v. kOpen: every pair is allowed, so no tag is compared (a
// separate instantiation keeps the test out of that path).
template <int D, bool kOpen>
__device__ __forceinline__ void fwd_tile(float acc[D / 8][4], float m[2], float l[2],
                                         const uint32_t qa[D / 16][4],
                                         const bf16 (*k_t)[D + 8], const bf16 (*v_t)[D + 8],
                                         const int* tags, int tag_lo, int tag_hi,
                                         float scale_log2, int lane) {
  static_assert(kCols % kChunk == 0 && kChunk % 16 == 0, "chunks of 16 keys");
  const int tq = lane & 3;
#pragma unroll
  for (int c0 = 0; c0 < kCols; c0 += kChunk) {
    float s[kChunk / 8][4];
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[2 * kk][e] = s[2 * kk + 1][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        uint32_t b[4];
        ldmatrix_x4(b, b_rows<D>(k_t, c0 + 16 * kk, ks, lane));
        mma(s[2 * kk], qa[ks], b[0], b[1]);
        mma(s[2 * kk + 1], qa[ks], b[2], b[3]);
      }
    }
    // the chunk's max of each row (masked pairs become -inf), over the quad
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kChunk / 8; ++n) {
      int2 key_tag = make_int2(0, 0);
      if (!kOpen) key_tag = *reinterpret_cast<const int2*>(&tags[c0 + 8 * n + 2 * tq]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!kOpen && ((e & 1) ? key_tag.y : key_tag.x) != (e < 2 ? tag_lo : tag_hi)) {
          s[n][e] = -INFINITY;
        }
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    }
    float sub[2];  // what the exponents subtract: the new max, 0 while it is -inf
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kAll, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kAll, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r] * scale_log2);
      sub[r] = m_new == -INFINITY ? 0.f : m_new;
      const float corr = ex2(m[r] - sub[r]);
      m[r] = m_new;
      l[r] *= corr;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][2 * r] *= corr;
        acc[n][2 * r + 1] *= corr;
      }
    }
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk) {
      uint32_t a[4];  // p of keys c0 + 16 kk .. + 15: the A fragment of p v
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = ex2(fmaf(s[2 * kk + n][e], scale_log2, -sub[e >> 1]));
          l[e >> 1] += p[e];
        }
        a[2 * n] = pack(p[0], p[1]);
        a[2 * n + 1] = pack(p[2], p[3]);
      }
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, b_cols<D>(v_t, c0 + 16 * kk, np, lane));
        mma(acc[2 * np], a, b[0], b[1]);
        mma(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
  }
}

// One block per (patch, head, kRows query rows); each warp owns 16 query
// rows, keys and values stream through shared memory. kLse: also write the
// row log-sum-exp.
template <int D, bool kLse>
__global__ void __launch_bounds__(kThreads)
patch_attention_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                               const bf16* __restrict__ v,
                               const int32_t* __restrict__ batch,
                               const uint8_t* __restrict__ valid, bf16* __restrict__ out,
                               float* __restrict__ lse, int heads, int patch,
                               float scale_log2) {
  __shared__ __align__(16) bf16 k_s[2][kCols][D + 8];
  __shared__ __align__(16) bf16 v_s[2][kCols][D + 8];
  __shared__ __align__(8) int tag_s[2][kCols];

  const int lane = threadIdx.x & 31;
  const int tq = lane & 3;
  const int head = blockIdx.y;
  const int64_t first = static_cast<int64_t>(blockIdx.z) * patch;
  const int r_lo = blockIdx.x * kRows + (threadIdx.x >> 5) * 16 + (lane >> 2);
  const int r_hi = r_lo + 8;
  const bool in_lo = r_lo < patch, in_hi = r_hi < patch;
  const int64_t h_lo = (first + (in_lo ? r_lo : 0)) * heads + head;
  const int64_t h_hi = (first + (in_hi ? r_hi : 0)) * heads + head;

  uint32_t qa[D / 16][4];
  load_a<D>(qa, q, h_lo * D, h_hi * D, in_lo, in_hi, tq);
  // padding rows carry the sentinel scene, which no valid key has
  const int tag_lo = in_lo ? batch[first + r_lo] : -2;
  const int tag_hi = in_hi ? batch[first + r_hi] : -2;
  const int row_tags[2] = {tag_lo, tag_hi};
  const Span rows = span_of(row_tags);
  int block_lo, block_hi;
  block_range<kWarps>(rows, &block_lo, &block_hi);

  const int n_tiles = (patch + kCols - 1) / kCols;

  float acc[D / 8][4] = {};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  int buf = 0;
  Next cur = next_key_tile<kCols>(0, n_tiles, block_lo, block_hi, batch, valid, first,
                                  patch, tag_s[0]);
  const int stride = heads * D;
  const bf16* k_patch = k + (first * heads + head) * D;
  const bf16* v_patch = v + (first * heads + head) * D;
  if (cur.t < n_tiles) {
    load_tiles<D, kCols, kThreads>(k_s[0], v_s[0], k_patch, v_patch, stride,
                                   cur.t * kCols, patch);
  }
  cp_async_commit();
  while (cur.t < n_tiles) {
    const Next after = next_key_tile<kCols>(cur.t + 1, n_tiles, block_lo, block_hi, batch,
                                            valid, first, patch, tag_s[buf ^ 1]);
    if (after.t < n_tiles) {
      load_tiles<D, kCols, kThreads>(k_s[buf ^ 1], v_s[buf ^ 1], k_patch, v_patch, stride,
                                     after.t * kCols, patch);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const Span& span = cur.span;
    if (overlap(span, rows.lo, rows.hi)) {
      // every pair of the tile and the warp allowed: no per-element test
      if (span.one && rows.one && span.lo == rows.lo) {
        fwd_tile<D, true>(acc, m, l, qa, k_s[buf], v_s[buf], tag_s[buf], tag_lo, tag_hi,
                          scale_log2, lane);
      } else {
        fwd_tile<D, false>(acc, m, l, qa, k_s[buf], v_s[buf], tag_s[buf], tag_lo, tag_hi,
                           scale_log2, lane);
      }
    }
    __syncthreads();
    cur = after;
    buf ^= 1;
  }

  // each lane of a quad summed its own columns of the row
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kAll, l[r], 1);
    l[r] += __shfl_xor_sync(kAll, l[r], 2);
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][2 * r] *= inv;
      acc[n][2 * r + 1] *= inv;
    }
  }
  store_c<D>(out, acc, 1.f, h_lo * D, h_hi * D, in_lo, in_hi, tq);
  if (kLse && tq == 0) {
    if (in_lo) lse[h_lo] = l[0] > 0.f ? (m[0] + log2f(l[0])) * kLn2 : -INFINITY;
    if (in_hi) lse[h_hi] = l[1] > 0.f ? (m[1] + log2f(l[1])) * kLn2 : -INFINITY;
  }
}

// ---------------------------------------------------------------------------
// launches

template <int D>
void launch(const void* q, const void* k, const void* v, const void* batch,
            const void* valid, void* out, float* lse, int n, int heads, int patch,
            float scale, bool is_bf16, cudaStream_t stream) {
  const auto b = static_cast<const int32_t*>(batch);
  const auto m = static_cast<const uint8_t*>(valid);
  if (is_bf16) {
    const dim3 grid((patch + kRows - 1) / kRows, heads, n / patch);
    const auto kernel = lse != nullptr ? patch_attention_fwd_mma_kernel<D, true>
                                       : patch_attention_fwd_mma_kernel<D, false>;
    kernel<<<grid, kThreads, 0, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), b, m, static_cast<bf16*>(out), lse, heads, patch,
        scale * kLog2e);
  } else {
    const dim3 grid((patch + kQueryTile - 1) / kQueryTile, heads, n / patch);
    patch_attention_fwd_kernel<D><<<grid, kQueryTile, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), b, m, static_cast<float*>(out), lse, heads, patch,
        scale * kLog2e);
  }
}

}  // namespace

// q, k, v, out: contiguous (n, heads, head_dim), float32 (is_bf16 = 0) or
// bfloat16 (is_bf16 = 1, 16-byte aligned). batch: int32 (n,) scene ids;
// valid: bool (n,). lse: null, or float32 (n, heads). n must be a positive
// multiple of patch; head_dim must be 16 or 32.
extern "C" int cdseg_patch_attention_fwd(const void* q, const void* k,
                                         const void* v, const void* batch,
                                         const void* valid, void* out,
                                         void* lse, int n, int heads,
                                         int head_dim, int patch, float scale,
                                         int is_bf16, void* stream) {
  if (bad_shape(n, heads, head_dim, patch)) return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16 && misaligned({q, k, v, out})) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (head_dim == 16) {
    launch<16>(q, k, v, batch, valid, out, l, n, heads, patch, scale, is_bf16, s);
  } else {
    launch<32>(q, k, v, batch, valid, out, l, n, heads, patch, scale, is_bf16, s);
  }
  return static_cast<int>(cudaGetLastError());
}
