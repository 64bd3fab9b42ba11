// Masked patch attention, backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel
// cdsegnet_tpu/ops/pallas/flash_attention.py::_attn_bwd_kernel. Same
// masking as the forward (patch_attention_fwd.cu): a query row attends to the
// keys of its own patch that are valid and belong to the same scene. Given
// the forward's output o and its row log-sum-exp lse (natural log, f32), and
// the output gradient g, with p = exp(q.k * scale - lse):
//
//   delta_i = sum_e g_ie o_ie         (= rowsum(dp * p), from o)
//   ds_ij   = p_ij (g_i.v_j - delta_i)
//   dq_i    = scale * sum_j ds_ij k_j
//   dk_j    = scale * sum_i ds_ij q_i
//   dv_j    = sum_i p_ij g_i
//
// Two kernels, FlashAttention-2 style, with no atomics (so the gradients are
// deterministic): the dq kernel (which also writes delta to an f32 (N, H)
// scratch), then the dk/dv kernel. The TPU kernel holds the whole 1024 x 1024
// p tile in VMEM; an SM cannot, so both recompute p from lse.
//
// bf16 (the shipped type): tensor cores. Per allowed (query, key) pair and
// head the products are 6*D FLOPs in the dq kernel (s = q.k, dp = g.v,
// dq += ds k) and 8*D in the dk/dv kernel (s, dp, dv += p g, dk += ds q). On
// CUDA-core FMAs they bound the kernels; on the tensor cores they are cheap
// at D = 16. What remains per pair is f32 work on the CUDA cores: one
// exponential on the SFU (16 a clock per SM, against 128 FMAs) and a few ALU
// operations (scale and subtract lse, ds = p (dp - delta), pack to bf16, and
// the mask select on boundary tiles), with the latency of the chain mma ->
// ex2 -> pack -> mma. That elementwise work, not the FLOPs or the bytes,
// bounds these kernels (PERF.md has the measured split). What the design
// does about it:
//  - products on the tensor cores with warp-level mma.sync m16n8k16 (bf16
//    in, f32 accumulate, as the TPU kernel's DEFAULT precision for bf16);
//    wgmma would raise a rate that does not bind here. The f32 accumulator
//    of two adjacent n8 tiles of s (or dp) is, once packed to bf16, the A
//    fragment of one k16 step of the next product, so p and ds never leave
//    registers. The exponential is one ex2.approx; dp's accumulator starts
//    at -delta, so the mma gives dp - delta;
//  - each warp owns 16 rows (queries for dq, keys for dk/dv), a block of
//    kWarps warps shares one (patch, head); the other side streams through
//    shared memory in bf16 tiles of kCols rows, loaded with cp.async (16
//    bytes a thread) and double-buffered, rows padded by 16 bytes so that
//    ldmatrix (with .trans for the operand that needs a transpose) is free of
//    bank conflicts;
//  - masking in three tiers: a tile that no row of the block can see is not
//    loaded and a tile that no row of the warp can see is not computed (both
//    warp-uniform: rows are sorted by scene); a tile whose rows and the
//    warp's 16 rows all share one scene, all allowed, takes a separate
//    instantiation with no per-element test, which is nearly every tile of a
//    training step; only boundary tiles compare scene tags per element;
//  - p and ds are rounded to bf16 before their products (dv, dq, dk), as the
//    TPU kernel and autograd through the bf16 plain version round p.
// The forward kernel shares these building blocks (attention_tiles.cuh).
//
// f32: the CUDA-core kernels of the first port, one row per thread (q, g, dq
// or k, v, dk, dv in f32 registers), the other side streamed through shared
// memory in tiles of 64 as f32, f32 FMAs in the forward's order. They are the
// exact route the f32 gates hold the port to.
//
// Rows with no allowed key (only padding rows, whose scene is the sentinel)
// have lse = -inf: p is taken as 0 there (never exp2(-inf - -inf)), so dq of
// such a row is 0, and a key no query can see gets dk = dv = 0. The plain
// version gives those rows the uniform mean over the patch instead; the two
// agree wherever g is 0 on the padding rows, as it is in the model.
//
// Plain C interface, loaded with ctypes; each entry point launches one
// kernel and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tiles.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// f32: CUDA-core kernels

constexpr int kRowTile = 128;  // rows per block, one per thread
constexpr int kTile = 64;      // streamed rows per shared-memory tile

// Scene range [lo, hi] of this block's rows that pass `member`; lo > hi when
// none does. All threads of the block must call it.
__device__ __forceinline__ void block_scene_range(bool member, int32_t scene,
                                                  int32_t* lo_out,
                                                  int32_t* hi_out) {
  __shared__ int32_t lo, hi;
  if (threadIdx.x == 0) {
    lo = 0x7fffffff;
    hi = -0x7fffffff - 1;
  }
  __syncthreads();
  if (member) {
    atomicMin(&lo, scene);
    atomicMax(&hi, scene);
  }
  __syncthreads();
  *lo_out = lo;
  *hi_out = hi;
}

// dq and delta. One block per (patch, head, tile of 128 query rows).
template <int D>
__global__ void __launch_bounds__(kRowTile)
patch_attention_bwd_dq_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ o,
                              const float* __restrict__ g,
                              const float* __restrict__ lse,
                              const int32_t* __restrict__ batch,
                              const uint8_t* __restrict__ valid,
                              float* __restrict__ dq, float* __restrict__ delta,
                              int heads, int patch, float scale_log2,
                              float scale) {
  __shared__ __align__(16) float k_tile[kTile][D];
  __shared__ __align__(16) float v_tile[kTile][D];
  __shared__ int32_t key_scene[kTile];
  __shared__ int key_visible[kTile];

  const int tid = threadIdx.x;
  const int head = blockIdx.y;
  const int64_t first = static_cast<int64_t>(blockIdx.z) * patch;
  const int row = blockIdx.x * kRowTile + tid;
  const bool active = row < patch;
  const int64_t qrow = first + (active ? row : 0);
  const int64_t base = (qrow * heads + head) * D;

  float qf[D], gf[D], acc[D];
  float dl = 0.f;
#pragma unroll
  for (int e = 0; e < D; ++e) {
    qf[e] = __ldg(q + base + e) * scale_log2;
    gf[e] = __ldg(g + base + e);
    dl = fmaf(gf[e], __ldg(o + base + e), dl);
    acc[e] = 0.f;
  }
  const float lse2 = lse[qrow * heads + head] * kLog2e;
  const bool has_keys = lse2 > -INFINITY;
  const int32_t scene = batch[qrow];
  if (active) delta[qrow * heads + head] = dl;

  int32_t lo, hi;
  block_scene_range(active && has_keys, scene, &lo, &hi);

  for (int t0 = 0; t0 < patch; t0 += kTile) {
    int visible = 0;
    if (tid < kTile) {
      const int key = t0 + tid;
      int32_t b = 0;
      if (key < patch) {
        b = batch[first + key];
        visible = valid[first + key] && b >= lo && b <= hi;
      }
      key_scene[tid] = b;
      key_visible[tid] = visible;
    }
    if (!__syncthreads_or(visible)) continue;
    for (int i = tid; i < kTile * D; i += kRowTile) {
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
    if (active && has_keys) {
#pragma unroll 4
      for (int j = 0; j < kTile; ++j) {
        if (!(key_visible[j] && key_scene[j] == scene)) continue;
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int e = 0; e < D; ++e) {
          s = fmaf(qf[e], k_tile[j][e], s);
          dp = fmaf(gf[e], v_tile[j][e], dp);
        }
        const float ds = exp2f(s - lse2) * (dp - dl);
#pragma unroll
        for (int e = 0; e < D; ++e) acc[e] = fmaf(ds, k_tile[j][e], acc[e]);
      }
    }
    __syncthreads();
  }

  if (active) {
#pragma unroll
    for (int e = 0; e < D; ++e) dq[base + e] = acc[e] * scale;
  }
}

// dk and dv. One block per (patch, head, tile of 128 key rows).
template <int D>
__global__ void __launch_bounds__(kRowTile)
patch_attention_bwd_dkdv_kernel(const float* __restrict__ q,
                                const float* __restrict__ k,
                                const float* __restrict__ v,
                                const float* __restrict__ g,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta,
                                const int32_t* __restrict__ batch,
                                const uint8_t* __restrict__ valid,
                                float* __restrict__ dk, float* __restrict__ dv,
                                int heads, int patch, float scale_log2) {
  __shared__ __align__(16) float q_tile[kTile][D];  // q * scale * log2 e
  __shared__ __align__(16) float g_tile[kTile][D];
  __shared__ float lse_tile[kTile];  // in log2 units
  __shared__ float delta_tile[kTile];
  __shared__ int32_t query_scene[kTile];
  __shared__ int query_visible[kTile];

  const int tid = threadIdx.x;
  const int head = blockIdx.y;
  const int64_t first = static_cast<int64_t>(blockIdx.z) * patch;
  const int row = blockIdx.x * kRowTile + tid;
  const bool active = row < patch;
  const int64_t krow = first + (active ? row : 0);
  const int64_t base = (krow * heads + head) * D;

  float kf[D], vf[D], dk_acc[D], dv_acc[D];
#pragma unroll
  for (int e = 0; e < D; ++e) {
    kf[e] = __ldg(k + base + e);
    vf[e] = __ldg(v + base + e);
    dk_acc[e] = 0.f;
    dv_acc[e] = 0.f;
  }
  const int32_t scene = batch[krow];
  const bool key_valid = active && valid[krow];

  // only valid keys are ever allowed, so only their scenes matter
  int32_t lo, hi;
  block_scene_range(key_valid, scene, &lo, &hi);

  for (int t0 = 0; t0 < patch; t0 += kTile) {
    int visible = 0;
    if (tid < kTile) {
      const int qi = t0 + tid;
      int32_t b = 0;
      float l2 = -INFINITY, dl = 0.f;
      if (qi < patch) {
        const int64_t idx = (first + qi) * heads + head;
        b = batch[first + qi];
        l2 = lse[idx] * kLog2e;
        dl = delta[idx];
        visible = l2 > -INFINITY && b >= lo && b <= hi;
      }
      query_scene[tid] = b;
      query_visible[tid] = visible;
      lse_tile[tid] = l2;
      delta_tile[tid] = dl;
    }
    if (!__syncthreads_or(visible)) continue;
    for (int i = tid; i < kTile * D; i += kRowTile) {
      const int j = i / D;
      const int e = i % D;
      const int qi = t0 + j;
      float qx = 0.f, gx = 0.f;
      if (qi < patch) {
        const int64_t off = ((first + qi) * heads + head) * D + e;
        qx = __ldg(q + off) * scale_log2;
        gx = __ldg(g + off);
      }
      q_tile[j][e] = qx;
      g_tile[j][e] = gx;
    }
    __syncthreads();
    if (key_valid) {
#pragma unroll 4
      for (int i = 0; i < kTile; ++i) {
        if (!(query_visible[i] && query_scene[i] == scene)) continue;
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int e = 0; e < D; ++e) {
          s = fmaf(q_tile[i][e], kf[e], s);
          dp = fmaf(g_tile[i][e], vf[e], dp);
        }
        const float p = exp2f(s - lse_tile[i]);
        const float ds = p * (dp - delta_tile[i]);
#pragma unroll
        for (int e = 0; e < D; ++e) {
          dv_acc[e] = fmaf(p, g_tile[i][e], dv_acc[e]);
          dk_acc[e] = fmaf(ds, q_tile[i][e], dk_acc[e]);
        }
      }
    }
    __syncthreads();
  }

  if (active) {
    // q_tile holds q * scale * log2 e, and dk = scale * sum_i ds_ij q_i
#pragma unroll
    for (int e = 0; e < D; ++e) {
      dk[base + e] = dk_acc[e] * (1.f / kLog2e);
      dv[base + e] = dv_acc[e];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor-core kernels

constexpr int kWarps = 8;             // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;    // rows per block, 16 per warp
constexpr int kCols = 128;            // streamed rows per shared-memory tile

// As next_key_tile (attention_tiles.cuh), for a tile of queries; warp 0 also
// writes their lse (log2 units) and -delta, zeros where the tag is negative.
__device__ __forceinline__ Next next_query_tile(int t, int n_tiles, int lo, int hi,
                                                const int32_t* __restrict__ batch,
                                                const float* __restrict__ lse,
                                                const float* __restrict__ delta,
                                                int64_t first, int patch, int heads,
                                                int head, int* tags, float* lse2,
                                                float* minus_dl) {
  const int lane = threadIdx.x & 31;
  for (; t < n_tiles; ++t) {
    int tag[kCols / 32];
    float l2[kCols / 32], d[kCols / 32];
#pragma unroll
    for (int i = 0; i < kCols / 32; ++i) {
      const int qi = t * kCols + 32 * i + lane;
      const int64_t at = first + min(qi, patch - 1);
      const int scene = batch[at];
      const float l = lse[at * heads + head];
      d[i] = delta[at * heads + head];
      tag[i] = qi < patch && l > -INFINITY ? scene : -2;
      l2[i] = l * kLog2e;
    }
    const Span span = span_of(tag);
    if (overlap(span, lo, hi)) {
      if (threadIdx.x < 32) {
#pragma unroll
        for (int i = 0; i < kCols / 32; ++i) {
          tags[32 * i + lane] = tag[i];
          lse2[32 * i + lane] = tag[i] >= 0 ? l2[i] : 0.f;
          minus_dl[32 * i + lane] = tag[i] >= 0 ? -d[i] : 0.f;
        }
      }
      return Next{t, span};
    }
  }
  return Next{n_tiles, Span{}};
}

// One warp's share of a key tile in the dq kernel: s = q k^T and dp = g v^T
// for 16 keys at a time, then ds = p (dp - delta) and dq += ds k. kOpen: every
// pair is allowed, so no tag is compared (a separate instantiation keeps the
// test out of that path).
template <int D, bool kOpen>
__device__ __forceinline__ void dq_tile(float acc[D / 8][4], const uint32_t qa[D / 16][4],
                                        const uint32_t ga[D / 16][4],
                                        const bf16 (*k_t)[D + 8], const bf16 (*v_t)[D + 8],
                                        const int* tags, const float minus_dl[4],
                                        float l2_lo, float l2_hi, int tag_lo, int tag_hi,
                                        float scale_log2, int lane) {
  const int tq = lane & 3;
#pragma unroll
  for (int kk = 0; kk < kCols / 16; ++kk) {
    float s[2][4] = {}, dp[2][4];
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t b[4];
      ldmatrix_x4(b, b_rows<D>(k_t, 16 * kk, ks, lane));
      mma(s[0], qa[ks], b[0], b[1]);
      mma(s[1], qa[ks], b[2], b[3]);
      ldmatrix_x4(b, b_rows<D>(v_t, 16 * kk, ks, lane));
      if (ks == 0) {  // the dp accumulators start at -delta
        mma_c(dp[0], ga[ks], b[0], b[1], minus_dl);
        mma_c(dp[1], ga[ks], b[2], b[3], minus_dl);
      } else {
        mma(dp[0], ga[ks], b[0], b[1]);
        mma(dp[1], ga[ks], b[2], b[3]);
      }
    }
    // ds, packed as the A fragment of keys 16 kk .. 16 kk + 15
    uint32_t a[4];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      int2 key_tag = make_int2(0, 0);
      if (!kOpen) key_tag = *reinterpret_cast<const int2*>(&tags[16 * kk + 8 * n + 2 * tq]);
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool lo = e < 2;
        float p = ex2(fmaf(s[n][e], scale_log2, -(lo ? l2_lo : l2_hi)));
        if (!kOpen) p = ((e & 1) ? key_tag.y : key_tag.x) == (lo ? tag_lo : tag_hi) ? p : 0.f;
        ds[e] = p * dp[n][e];
      }
      a[2 * n] = pack(ds[0], ds[1]);
      a[2 * n + 1] = pack(ds[2], ds[3]);
    }
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, b_cols<D>(k_t, 16 * kk, np, lane));
      mma(acc[2 * np], a, b[0], b[1]);
      mma(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// One warp's share of a query tile in the dk/dv kernel: s^T = k q^T and
// dp^T = v g^T for 16 queries at a time, then p^T, ds^T = p^T (dp^T - delta)
// with lse and delta per column, dv += p^T g and dk += ds^T q.
template <int D, bool kOpen>
__device__ __forceinline__ void dkdv_tile(float dk_acc[D / 8][4], float dv_acc[D / 8][4],
                                          const uint32_t ka[D / 16][4],
                                          const uint32_t va[D / 16][4],
                                          const bf16 (*q_t)[D + 8], const bf16 (*g_t)[D + 8],
                                          const int* tags, const float* lse2,
                                          const float* minus_dl, int tag_lo, int tag_hi,
                                          float scale_log2, int lane) {
  const int tq = lane & 3;
#pragma unroll
  for (int kk = 0; kk < kCols / 16; ++kk) {
    float2 l2[2];
    float c[2][4];  // the dp accumulators start at -delta of their column
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int col = 16 * kk + 8 * n + 2 * tq;
      l2[n] = *reinterpret_cast<const float2*>(&lse2[col]);
      const float2 dl = *reinterpret_cast<const float2*>(&minus_dl[col]);
      c[n][0] = c[n][2] = dl.x;
      c[n][1] = c[n][3] = dl.y;
    }
    float s[2][4] = {}, dp[2][4];
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t b[4];
      ldmatrix_x4(b, b_rows<D>(q_t, 16 * kk, ks, lane));
      mma(s[0], ka[ks], b[0], b[1]);
      mma(s[1], ka[ks], b[2], b[3]);
      ldmatrix_x4(b, b_rows<D>(g_t, 16 * kk, ks, lane));
      if (ks == 0) {
        mma_c(dp[0], va[ks], b[0], b[1], c[0]);
        mma_c(dp[1], va[ks], b[2], b[3], c[1]);
      } else {
        mma(dp[0], va[ks], b[0], b[1]);
        mma(dp[1], va[ks], b[2], b[3]);
      }
    }
    uint32_t pa[4], da[4];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      int2 query_tag = make_int2(0, 0);
      if (!kOpen) query_tag = *reinterpret_cast<const int2*>(&tags[16 * kk + 8 * n + 2 * tq]);
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool c1 = e & 1;
        p[e] = ex2(fmaf(s[n][e], scale_log2, -(c1 ? l2[n].y : l2[n].x)));
        if (!kOpen) {
          p[e] = (c1 ? query_tag.y : query_tag.x) == (e < 2 ? tag_lo : tag_hi) ? p[e] : 0.f;
        }
        ds[e] = p[e] * dp[n][e];
      }
      pa[2 * n] = pack(p[0], p[1]);
      pa[2 * n + 1] = pack(p[2], p[3]);
      da[2 * n] = pack(ds[0], ds[1]);
      da[2 * n + 1] = pack(ds[2], ds[3]);
    }
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, b_cols<D>(g_t, 16 * kk, np, lane));
      mma(dv_acc[2 * np], pa, b[0], b[1]);
      mma(dv_acc[2 * np + 1], pa, b[2], b[3]);
      ldmatrix_x4_trans(b, b_cols<D>(q_t, 16 * kk, np, lane));
      mma(dk_acc[2 * np], da, b[0], b[1]);
      mma(dk_acc[2 * np + 1], da, b[2], b[3]);
    }
  }
}

// dq and delta. One block per (patch, head, kRows query rows); each warp
// owns 16 query rows, keys and values stream through shared memory.
template <int D>
__global__ void __launch_bounds__(kThreads)
patch_attention_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                  const bf16* __restrict__ v, const bf16* __restrict__ o,
                                  const bf16* __restrict__ g,
                                  const float* __restrict__ lse,
                                  const int32_t* __restrict__ batch,
                                  const uint8_t* __restrict__ valid,
                                  bf16* __restrict__ dq, float* __restrict__ delta,
                                  int heads, int patch, float scale_log2, float scale) {
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

  uint32_t qa[D / 16][4], ga[D / 16][4];
  load_a<D>(qa, q, h_lo * D, h_hi * D, in_lo, in_hi, tq);
  load_a<D>(ga, g, h_lo * D, h_hi * D, in_lo, in_hi, tq);
  float dl_lo = 0.f, dl_hi = 0.f;
  {
    uint32_t oa[D / 16][4];
    load_a<D>(oa, o, h_lo * D, h_hi * D, in_lo, in_hi, tq);
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 gf = unpack(ga[ks][i]), of = unpack(oa[ks][i]);
        float& dl = (i & 1) ? dl_hi : dl_lo;
        dl = fmaf(gf.y, of.y, fmaf(gf.x, of.x, dl));
      }
    }
#pragma unroll
    for (int m = 1; m <= 2; m <<= 1) {
      dl_lo += __shfl_xor_sync(kAll, dl_lo, m);
      dl_hi += __shfl_xor_sync(kAll, dl_hi, m);
    }
  }
  const float l2_lo = in_lo ? lse[h_lo] * kLog2e : -INFINITY;
  const float l2_hi = in_hi ? lse[h_hi] * kLog2e : -INFINITY;
  const int tag_lo = l2_lo > -INFINITY ? batch[first + r_lo] : -2;
  const int tag_hi = l2_hi > -INFINITY ? batch[first + r_hi] : -2;
  if (tq == 0) {
    if (in_lo) delta[h_lo] = dl_lo;
    if (in_hi) delta[h_hi] = dl_hi;
  }
  const int row_tags[2] = {tag_lo, tag_hi};
  const Span rows = span_of(row_tags);
  int block_lo, block_hi;
  block_range<kWarps>(rows, &block_lo, &block_hi);
  // the dp accumulators start at -delta, so the mma gives dp - delta
  const float minus_dl[4] = {-dl_lo, -dl_lo, -dl_hi, -dl_hi};

  const int n_tiles = (patch + kCols - 1) / kCols;

  float acc[D / 8][4] = {};
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
        dq_tile<D, true>(acc, qa, ga, k_s[buf], v_s[buf], tag_s[buf], minus_dl, l2_lo, l2_hi,
                         tag_lo, tag_hi, scale_log2, lane);
      } else {
        dq_tile<D, false>(acc, qa, ga, k_s[buf], v_s[buf], tag_s[buf], minus_dl, l2_lo, l2_hi,
                          tag_lo, tag_hi, scale_log2, lane);
      }
    }
    __syncthreads();
    cur = after;
    buf ^= 1;
  }
  store_c<D>(dq, acc, scale, h_lo * D, h_hi * D, in_lo, in_hi, tq);
}

// dk and dv. One block per (patch, head, kRows key rows); each warp owns 16
// key rows, queries, output gradients, lse and delta stream through shared
// memory.
template <int D>
__global__ void __launch_bounds__(kThreads)
patch_attention_bwd_dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                    const bf16* __restrict__ v, const bf16* __restrict__ g,
                                    const float* __restrict__ lse,
                                    const float* __restrict__ delta,
                                    const int32_t* __restrict__ batch,
                                    const uint8_t* __restrict__ valid,
                                    bf16* __restrict__ dk, bf16* __restrict__ dv,
                                    int heads, int patch, float scale_log2, float scale) {
  __shared__ __align__(16) bf16 q_s[2][kCols][D + 8];
  __shared__ __align__(16) bf16 g_s[2][kCols][D + 8];
  __shared__ __align__(8) int tag_s[2][kCols];
  __shared__ __align__(8) float lse_s[2][kCols];  // in log2 units
  __shared__ __align__(8) float dl_s[2][kCols];  // -delta

  const int lane = threadIdx.x & 31;
  const int tq = lane & 3;
  const int head = blockIdx.y;
  const int64_t first = static_cast<int64_t>(blockIdx.z) * patch;
  const int r_lo = blockIdx.x * kRows + (threadIdx.x >> 5) * 16 + (lane >> 2);
  const int r_hi = r_lo + 8;
  const bool in_lo = r_lo < patch, in_hi = r_hi < patch;
  const int64_t h_lo = (first + (in_lo ? r_lo : 0)) * heads + head;
  const int64_t h_hi = (first + (in_hi ? r_hi : 0)) * heads + head;

  uint32_t ka[D / 16][4], va[D / 16][4];
  load_a<D>(ka, k, h_lo * D, h_hi * D, in_lo, in_hi, tq);
  load_a<D>(va, v, h_lo * D, h_hi * D, in_lo, in_hi, tq);
  const int tag_lo = (in_lo && valid[first + r_lo]) ? batch[first + r_lo] : -1;
  const int tag_hi = (in_hi && valid[first + r_hi]) ? batch[first + r_hi] : -1;
  const int row_tags[2] = {tag_lo, tag_hi};
  const Span rows = span_of(row_tags);
  int block_lo, block_hi;
  block_range<kWarps>(rows, &block_lo, &block_hi);

  const int n_tiles = (patch + kCols - 1) / kCols;

  float dk_acc[D / 8][4] = {}, dv_acc[D / 8][4] = {};
  int buf = 0;
  Next cur = next_query_tile(0, n_tiles, block_lo, block_hi, batch, lse, delta, first,
                             patch, heads, head, tag_s[0], lse_s[0], dl_s[0]);
  const int stride = heads * D;
  const bf16* q_patch = q + (first * heads + head) * D;
  const bf16* g_patch = g + (first * heads + head) * D;
  if (cur.t < n_tiles) {
    load_tiles<D, kCols, kThreads>(q_s[0], g_s[0], q_patch, g_patch, stride,
                                   cur.t * kCols, patch);
  }
  cp_async_commit();
  while (cur.t < n_tiles) {
    const Next after = next_query_tile(cur.t + 1, n_tiles, block_lo, block_hi, batch, lse,
                                       delta, first, patch, heads, head, tag_s[buf ^ 1],
                                       lse_s[buf ^ 1], dl_s[buf ^ 1]);
    if (after.t < n_tiles) {
      load_tiles<D, kCols, kThreads>(q_s[buf ^ 1], g_s[buf ^ 1], q_patch, g_patch, stride,
                                     after.t * kCols, patch);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const Span& span = cur.span;
    if (overlap(span, rows.lo, rows.hi)) {
      if (span.one && rows.one && span.lo == rows.lo) {
        dkdv_tile<D, true>(dk_acc, dv_acc, ka, va, q_s[buf], g_s[buf], tag_s[buf], lse_s[buf],
                           dl_s[buf], tag_lo, tag_hi, scale_log2, lane);
      } else {
        dkdv_tile<D, false>(dk_acc, dv_acc, ka, va, q_s[buf], g_s[buf], tag_s[buf], lse_s[buf],
                            dl_s[buf], tag_lo, tag_hi, scale_log2, lane);
      }
    }
    __syncthreads();
    cur = after;
    buf ^= 1;
  }
  store_c<D>(dk, dk_acc, scale, h_lo * D, h_hi * D, in_lo, in_hi, tq);
  store_c<D>(dv, dv_acc, 1.f, h_lo * D, h_hi * D, in_lo, in_hi, tq);
}

// ---------------------------------------------------------------------------
// launches

template <int D>
void launch_dq(const void* q, const void* k, const void* v, const void* o,
               const void* g, const void* lse, const void* batch,
               const void* valid, void* dq, void* delta, int n, int heads,
               int patch, float scale, bool is_bf16, cudaStream_t stream) {
  const auto b = static_cast<const int32_t*>(batch);
  const auto m = static_cast<const uint8_t*>(valid);
  const auto l = static_cast<const float*>(lse);
  const auto dl = static_cast<float*>(delta);
  if (is_bf16) {
    const dim3 grid((patch + kRows - 1) / kRows, heads, n / patch);
    patch_attention_bwd_dq_mma_kernel<D><<<grid, kThreads, 0, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(o),
        static_cast<const bf16*>(g), l, b, m, static_cast<bf16*>(dq), dl, heads,
        patch, scale * kLog2e, scale);
  } else {
    const dim3 grid((patch + kRowTile - 1) / kRowTile, heads, n / patch);
    patch_attention_bwd_dq_kernel<D><<<grid, kRowTile, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(o),
        static_cast<const float*>(g), l, b, m, static_cast<float*>(dq), dl,
        heads, patch, scale * kLog2e, scale);
  }
}

template <int D>
void launch_dkdv(const void* q, const void* k, const void* v, const void* g,
                 const void* lse, const void* delta, const void* batch,
                 const void* valid, void* dk, void* dv, int n, int heads,
                 int patch, float scale, bool is_bf16, cudaStream_t stream) {
  const auto b = static_cast<const int32_t*>(batch);
  const auto m = static_cast<const uint8_t*>(valid);
  const auto l = static_cast<const float*>(lse);
  const auto dl = static_cast<const float*>(delta);
  if (is_bf16) {
    const dim3 grid((patch + kRows - 1) / kRows, heads, n / patch);
    patch_attention_bwd_dkdv_mma_kernel<D><<<grid, kThreads, 0, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(g), l, dl, b, m,
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), heads, patch,
        scale * kLog2e, scale);
  } else {
    const dim3 grid((patch + kRowTile - 1) / kRowTile, heads, n / patch);
    patch_attention_bwd_dkdv_kernel<D><<<grid, kRowTile, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(g), l, dl, b, m,
        static_cast<float*>(dk), static_cast<float*>(dv), heads, patch,
        scale * kLog2e);
  }
}

}  // namespace

// q, k, v, o, g, dq: contiguous (n, heads, head_dim), float32 (is_bf16 = 0)
// or bfloat16 (is_bf16 = 1, 16-byte aligned). lse (from the forward) and
// delta (written here): float32 (n, heads). batch: int32 (n,) scene ids;
// valid: bool (n,). n must be a positive multiple of patch; head_dim must be
// 16 or 32.
extern "C" int cdseg_patch_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* o, const void* g,
    const void* lse, const void* batch, const void* valid, void* dq,
    void* delta, int n, int heads, int head_dim, int patch, float scale,
    int is_bf16, void* stream) {
  if (bad_shape(n, heads, head_dim, patch)) return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16 && misaligned({q, k, v, o, g, dq})) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 16) {
    launch_dq<16>(q, k, v, o, g, lse, batch, valid, dq, delta, n, heads, patch, scale, is_bf16, s);
  } else {
    launch_dq<32>(q, k, v, o, g, lse, batch, valid, dq, delta, n, heads, patch, scale, is_bf16, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// As above; delta is the dq kernel's output. dk, dv: like k and v.
extern "C" int cdseg_patch_attention_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* g,
    const void* lse, const void* delta, const void* batch, const void* valid,
    void* dk, void* dv, int n, int heads, int head_dim, int patch, float scale,
    int is_bf16, void* stream) {
  if (bad_shape(n, heads, head_dim, patch)) return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16 && misaligned({q, k, v, g, dk, dv})) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 16) {
    launch_dkdv<16>(q, k, v, g, lse, delta, batch, valid, dk, dv, n, heads, patch, scale, is_bf16, s);
  } else {
    launch_dkdv<32>(q, k, v, g, lse, delta, batch, valid, dk, dv, n, heads, patch, scale, is_bf16, s);
  }
  return static_cast<int>(cudaGetLastError());
}
