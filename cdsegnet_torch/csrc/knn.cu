// The k nearest references of each query, distances and selection fused,
// for Hopper (sm_90a): ops/pointops.py::knn on CUDA tensors.
//
// Replaces no TPU kernel: cdsegnet_tpu/ops/pointops.py computes the kNN in
// XLA (_pairwise_dist2, then lax.top_k over the whole distance matrix). On
// this card the same form wrote every distance to device memory in tiles of
// 2^26, read them again in a radix top-k and a tie check that synchronised
// with the host once a tile. This kernel writes no distance to device
// memory: each thread keeps its query's k best (distance, index) pairs in
// registers and writes only those.
//
// The definition is JAX's, bit for bit (knn_dense): the squared distance by
// the expansion qq - 2 q.r + rr, q.r as the multiply-add chain
// fma(q2, r2, fma(q1, r1, q0 r0)) (qq and rr come in precomputed by the
// caller, in the same rounding), qq - 2 q.r rounded once (the doubling is
// exact), then + rr, then clamped at 0; ascending (distance, reference
// index), ties to the lower index. Explicit __fmul_rn / __fmaf_rn /
// __fadd_rn keep nvcc's contraction from changing a bit.
//
// What bounds it: FP32 issue, at 128 lanes a clock on each SM. A pair
// needs five FP32 instructions for its distance (the product, two
// multiply-adds, the -2 c multiply-add, the add of rr) and about one for
// the test against the k-th value (four distances share one min and one
// branch): some 6 instructions, the bound chip_smoke.py reports. This
// kernel issues about 9 a pair: the broadcast shared-memory load of the
// reference (x, y, z, rr) and the loop come on top.
//
// Layout: the caller sorts queries and references by scene (valid points
// only, ascending index within a scene) and packs them as float4 (x, y, z,
// squared norm). A launch covers up to kMaxScenes scenes; a block owns
// kThreads consecutive queries of one scene, one per thread, and streams
// that scene's references through shared memory in tiles of kTile
// (cp.async, double-buffered). The scan starts at the tile centred on the
// block's own share of the scene and wraps around: points come sorted in
// space (crop radius, grid-cell order), so the first tile holds most of the
// neighbours and the k-th value is tight from then on. A candidate enters
// only if it precedes the k-th entry in (distance, index) order, so the
// result does not depend on the scan order; such insertions are rare (about
// 90 a query at PTv2's finest level, against some 4,000 when scanning in
// index order), so the k best are a sorted list in registers, K slots (K in
// {1, 4, 8, 16, 32, 64}, the smallest not below k), and the first k are
// written. Plain C interface, loaded with ctypes; the entry point returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "attention_tiles.cuh"

namespace {

constexpr int kThreads = 256;   // queries a block
constexpr int kTile = 1024;     // references a shared-memory tile (16 KiB)
constexpr int kGroup = 4;       // distances tested together against the k-th
constexpr int kMaxScenes = 64;  // scenes a launch
constexpr float kBig = 1e30f;   // pointops.BIG: the distance of an empty slot
constexpr int kEmpty = INT_MAX; // the position of an empty slot

// The scenes of one launch, blocks laid out scene after scene: scene s owns
// blocks [first_block[s], first_block[s + 1]), its queries [q0, q1) and its
// references [r0, r1) in the packed, scene-sorted arrays.
struct KnnScenes {
  int count;
  int first_block[kMaxScenes + 1];
  int q0[kMaxScenes], q1[kMaxScenes], r0[kMaxScenes], r1[kMaxScenes];
};

// qq - 2 q.r + rr, unclamped, in the rounding of pointops._dist2 (whose
// torch.addcmul is a fused multiply-add on the card too)
__device__ __forceinline__ float expansion(const float4 q, const float4 r) {
  float c = __fmul_rn(q.x, r.x);
  c = __fmaf_rn(q.y, r.y, c);
  c = __fmaf_rn(q.z, r.z, c);
  return __fadd_rn(__fmaf_rn(-2.0f, c, q.w), r.w);
}

// Whether (v, i) precedes (d, j): ascending distance, then index.
__device__ __forceinline__ bool precedes(float v, int i, float d, int j) {
  return v < d || (v == d && i < j);
}

// Offer the candidate (d, j) to the sorted list (v, ix): it enters if it
// precedes the last entry, after every entry that precedes it.
template <int K>
__device__ __forceinline__ void offer(float (&v)[K], int (&ix)[K], float d, int j) {
  d = d < 0.0f ? 0.0f : d;  // the clamp at 0, before any comparison
  if (!precedes(d, j, v[K - 1], ix[K - 1])) return;
  bool keep = false;  // whether entry s stays where it is (never the last)
#pragma unroll
  for (int s = K - 1; s > 0; --s) {
    const bool keep_prev = precedes(v[s - 1], ix[s - 1], d, j);
    const float nv = keep_prev ? (keep ? v[s] : d) : v[s - 1];
    const int ni = keep_prev ? (keep ? ix[s] : j) : ix[s - 1];
    v[s] = nv;
    ix[s] = ni;
    keep = keep_prev;
  }
  if (!keep) {
    v[0] = d;
    ix[0] = j;
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads) knn_fused_kernel(
    const float4* __restrict__ queries, const float4* __restrict__ refs,
    const int64_t* __restrict__ query_rows, const int64_t* __restrict__ ref_ids,
    int32_t* __restrict__ idx_out, float* __restrict__ dist_out, int k, int guard,
    const KnnScenes scenes) {
  __shared__ __align__(16) float4 tile[2][kTile];

  int s = 0;
  while (s + 1 < scenes.count && static_cast<int>(blockIdx.x) >= scenes.first_block[s + 1]) ++s;
  const int q0 = scenes.q0[s], q1 = scenes.q1[s], r0 = scenes.r0[s];
  const int n_refs = scenes.r1[s] - r0;
  const int qb = q0 + (static_cast<int>(blockIdx.x) - scenes.first_block[s]) * kThreads;
  const int qe = min(qb + kThreads, q1);
  const int p = qb + static_cast<int>(threadIdx.x);
  const bool active = p < qe;
  const float4 q = active ? queries[p] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  // the tile centred on this block's share of the scene comes first
  const int64_t mid = static_cast<int64_t>(qb - q0 + (qe - qb) / 2) * n_refs / (q1 - q0);
  const int start = max(0, min(static_cast<int>(mid) - kTile / 2, n_refs - kTile));
  const float4* scene_refs = refs + r0;
  const float4 pad = make_float4(0.0f, 0.0f, 0.0f, __int_as_float(0x7fc00000));  // NaN: never kept

  auto load = [&](int t, int buf) {
#pragma unroll
    for (int e = threadIdx.x; e < kTile; e += kThreads) {
      const int l = t * kTile + e;
      if (l < n_refs) {
        const int pos = start + l < n_refs ? start + l : start + l - n_refs;
        cp_async16(&tile[buf][e], scene_refs + pos, true);
      } else {
        tile[buf][e] = pad;
      }
    }
    cp_async_commit();
  };

  float v[K];
  int ix[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    v[i] = INFINITY;
    ix[i] = kEmpty;
  }

  const int tiles = (n_refs + kTile - 1) / kTile;
  load(0, 0);
  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) {
      load(t + 1, (t + 1) & 1);
    } else {
      cp_async_commit();  // an empty group, so that one wait fits every step
    }
    cp_async_wait_one();
    __syncthreads();
    if (active) {
      const float4* r = tile[t & 1];
      const int count = min(kTile, n_refs - t * kTile);
      const int base = start + t * kTile;  // scan position -> scene position, before the wrap
#pragma unroll 2
      for (int e = 0; e < count; e += kGroup) {
        const float d0 = expansion(q, r[e]);
        const float d1 = expansion(q, r[e + 1]);
        const float d2 = expansion(q, r[e + 2]);
        const float d3 = expansion(q, r[e + 3]);
        // a NaN (padding) loses every fminf against a number and every test
        if (fminf(fminf(d0, d1), fminf(d2, d3)) <= v[K - 1]) {
#pragma unroll 1
          for (int x = 0; x < kGroup; ++x) {
            const float d = x == 0 ? d0 : x == 1 ? d1 : x == 2 ? d2 : d3;
            if (d <= v[K - 1]) {
              const int pos = base + e + x;
              offer<K>(v, ix, d, pos < n_refs ? pos : pos - n_refs);
            }
          }
        }
      }
    }
    __syncthreads();  // the next step refills this buffer
  }

  if (!active) return;
  const int64_t row = query_rows[p] * k;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    if (i < k) {
      const bool empty = ix[i] == kEmpty;
      idx_out[row + i] = empty || !(v[i] < 0.5f * kBig)
                             ? guard : static_cast<int32_t>(ref_ids[r0 + ix[i]]);
      dist_out[row + i] = empty ? kBig : v[i];
    }
  }
}

template <int K>
int launch(const float4* queries, const float4* refs, const int64_t* query_rows,
           const int64_t* ref_ids, int32_t* idx, float* dist, int k, int guard,
           const KnnScenes& scenes, cudaStream_t stream) {
  const int blocks = scenes.first_block[scenes.count];
  if (blocks > 0) {
    knn_fused_kernel<K><<<blocks, kThreads, 0, stream>>>(queries, refs, query_rows, ref_ids,
                                                         idx, dist, k, guard, scenes);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The k nearest valid references of each valid query, within its scene.
// queries (Mq, 4) and refs (Mr, 4) f32: the valid points sorted by scene,
// ascending index within a scene, as (x, y, z, squared norm); query_rows
// (Mq) int64: each packed query's row of the outputs; ref_ids (Mr) int64:
// each packed reference's index. runs (count, 4) int32 on the host: each
// scene's packed queries [q0, q1) and references [r0, r1), q1 > q0, r1 > r0.
// idx (M, k) int32 and dist (M, k) f32 receive the rows of the packed
// queries, in ascending (distance, index) order: a slot without a
// reference, or whose distance is not below BIG / 2, gets index guard; a
// slot without a reference gets distance BIG. Other rows are not written.
// slots is the list length K: 1, 4, 8, 16, 32 or 64, not below k. A
// launch covers up to kMaxScenes scenes; *launched receives the number of
// launches made.
extern "C" int cdseg_knn_fused(const void* queries, const void* refs, const void* query_rows,
                               const void* ref_ids, void* idx, void* dist, const int* runs,
                               int count, int k, int slots, int guard, void* stream,
                               int* launched) {
  *launched = 0;
  if (count < 0 || k < 1 || k > slots || guard < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* qp = static_cast<const float4*>(queries);
  const auto* rp = static_cast<const float4*>(refs);
  const auto* rows = static_cast<const int64_t*>(query_rows);
  const auto* ids = static_cast<const int64_t*>(ref_ids);
  auto* ip = static_cast<int32_t*>(idx);
  auto* dp = static_cast<float*>(dist);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int first = 0; first < count; first += kMaxScenes) {
    KnnScenes sc;
    sc.count = std::min(kMaxScenes, count - first);
    sc.first_block[0] = 0;
    for (int s = 0; s < sc.count; ++s) {
      const int* r = runs + 4 * (first + s);
      if (r[1] <= r[0] || r[3] <= r[2]) return static_cast<int>(cudaErrorInvalidValue);
      sc.q0[s] = r[0];
      sc.q1[s] = r[1];
      sc.r0[s] = r[2];
      sc.r1[s] = r[3];
      sc.first_block[s + 1] = sc.first_block[s] + (r[1] - r[0] + kThreads - 1) / kThreads;
    }
    int err;
    switch (slots) {
      case 1: err = launch<1>(qp, rp, rows, ids, ip, dp, k, guard, sc, st); break;
      case 4: err = launch<4>(qp, rp, rows, ids, ip, dp, k, guard, sc, st); break;
      case 8: err = launch<8>(qp, rp, rows, ids, ip, dp, k, guard, sc, st); break;
      case 16: err = launch<16>(qp, rp, rows, ids, ip, dp, k, guard, sc, st); break;
      case 32: err = launch<32>(qp, rp, rows, ids, ip, dp, k, guard, sc, st); break;
      case 64: err = launch<64>(qp, rp, rows, ids, ip, dp, k, guard, sc, st); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
    if (err != 0) return err;
    if (sc.first_block[sc.count] > 0) ++*launched;
  }
  return 0;
}
