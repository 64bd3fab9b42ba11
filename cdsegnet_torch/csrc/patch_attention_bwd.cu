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
// What bounds it on this card: per allowed (query, key) pair the two kernels
// do 7*D FMAs and two exponentials (one each), so as in the forward the
// SFU's exponential rate and the CUDA cores' FMA rate, not the tensor cores
// or the bytes, set the practical ceiling at D = 16.
//
// What this design does about it: nothing yet; it is the simple version that
// is right, FlashAttention-2 style, with no atomics (so it is deterministic).
// The TPU kernel holds the whole 1024 x 1024 p tile in VMEM; an SM cannot, so
// p is recomputed from lse, twice:
//  - the dq kernel: one query row per thread (q, g, dq in registers), the
//    patch's keys and values streamed through shared memory in tiles of 64,
//    widened to f32. It computes delta_i in registers from g and the saved o
//    and writes it to an f32 (N, H) scratch for the second kernel;
//  - the dk/dv kernel, launched after it: one key row per thread (k, v, dk,
//    dv in registers), the patch's queries (q, g, lse, delta, scene id)
//    streamed through shared memory in tiles of 64.
// Both skip a tile that no row of the block can see (rows are sorted by
// scene), as the forward does. p is exp2(s * log2 e - lse * log2 e) with s
// computed in the forward's order of FMAs, so p <= 1 up to rounding. All
// arithmetic is f32, whatever the input type (as in both TPU kernels).
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

namespace {

constexpr int kRowTile = 128;  // rows per block, one per thread
constexpr int kTile = 64;      // streamed rows per shared-memory tile
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

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
template <typename T, int D>
__global__ void __launch_bounds__(kRowTile)
patch_attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const T* __restrict__ o,
                              const T* __restrict__ g,
                              const float* __restrict__ lse,
                              const int32_t* __restrict__ batch,
                              const uint8_t* __restrict__ valid,
                              T* __restrict__ dq, float* __restrict__ delta,
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
    qf[e] = load_f32(q + base + e) * scale_log2;
    gf[e] = load_f32(g + base + e);
    dl = fmaf(gf[e], load_f32(o + base + e), dl);
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
        kx = load_f32(k + off);
        vx = load_f32(v + off);
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
    for (int e = 0; e < D; ++e) store_f32(dq + base + e, acc[e] * scale);
  }
}

// dk and dv. One block per (patch, head, tile of 128 key rows).
template <typename T, int D>
__global__ void __launch_bounds__(kRowTile)
patch_attention_bwd_dkdv_kernel(const T* __restrict__ q,
                                const T* __restrict__ k,
                                const T* __restrict__ v,
                                const T* __restrict__ g,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta,
                                const int32_t* __restrict__ batch,
                                const uint8_t* __restrict__ valid,
                                T* __restrict__ dk, T* __restrict__ dv,
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
    kf[e] = load_f32(k + base + e);
    vf[e] = load_f32(v + base + e);
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
        qx = load_f32(q + off) * scale_log2;
        gx = load_f32(g + off);
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
      store_f32(dk + base + e, dk_acc[e] * (1.f / kLog2e));
      store_f32(dv + base + e, dv_acc[e]);
    }
  }
}

bool bad_shape(int n, int heads, int patch) {
  return n <= 0 || patch <= 0 || heads <= 0 || n % patch != 0 ||
         n / patch > 65535 || heads > 65535;
}

dim3 grid_for(int n, int heads, int patch) {
  return dim3((patch + kRowTile - 1) / kRowTile, heads, n / patch);
}

template <typename T, int D>
void launch_dq(const void* q, const void* k, const void* v, const void* o,
               const void* g, const void* lse, const void* batch,
               const void* valid, void* dq, void* delta, int n, int heads,
               int patch, float scale, cudaStream_t stream) {
  patch_attention_bwd_dq_kernel<T, D>
      <<<grid_for(n, heads, patch), kRowTile, 0, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(o),
          static_cast<const T*>(g), static_cast<const float*>(lse),
          static_cast<const int32_t*>(batch),
          static_cast<const uint8_t*>(valid), static_cast<T*>(dq),
          static_cast<float*>(delta), heads, patch, scale * kLog2e, scale);
}

template <typename T, int D>
void launch_dkdv(const void* q, const void* k, const void* v, const void* g,
                 const void* lse, const void* delta, const void* batch,
                 const void* valid, void* dk, void* dv, int n, int heads,
                 int patch, float scale, cudaStream_t stream) {
  patch_attention_bwd_dkdv_kernel<T, D>
      <<<grid_for(n, heads, patch), kRowTile, 0, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(g),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<const int32_t*>(batch),
          static_cast<const uint8_t*>(valid), static_cast<T*>(dk),
          static_cast<T*>(dv), heads, patch, scale * kLog2e);
}

}  // namespace

// q, k, v, o, g, dq: contiguous (n, heads, head_dim), float32 (is_bf16 = 0)
// or bfloat16 (is_bf16 = 1). lse (from the forward) and delta (written
// here): float32 (n, heads). batch: int32 (n,) scene ids; valid: bool (n,).
// n must be a positive multiple of patch; head_dim must be 16 or 32.
extern "C" int cdseg_patch_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* o, const void* g,
    const void* lse, const void* batch, const void* valid, void* dq,
    void* delta, int n, int heads, int head_dim, int patch, float scale,
    int is_bf16, void* stream) {
  if (bad_shape(n, heads, patch)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16 && head_dim == 16) {
    launch_dq<__nv_bfloat16, 16>(q, k, v, o, g, lse, batch, valid, dq, delta, n, heads, patch, scale, s);
  } else if (is_bf16 && head_dim == 32) {
    launch_dq<__nv_bfloat16, 32>(q, k, v, o, g, lse, batch, valid, dq, delta, n, heads, patch, scale, s);
  } else if (!is_bf16 && head_dim == 16) {
    launch_dq<float, 16>(q, k, v, o, g, lse, batch, valid, dq, delta, n, heads, patch, scale, s);
  } else if (!is_bf16 && head_dim == 32) {
    launch_dq<float, 32>(q, k, v, o, g, lse, batch, valid, dq, delta, n, heads, patch, scale, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// As above; delta is the dq kernel's output. dk, dv: like k and v.
extern "C" int cdseg_patch_attention_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* g,
    const void* lse, const void* delta, const void* batch, const void* valid,
    void* dk, void* dv, int n, int heads, int head_dim, int patch, float scale,
    int is_bf16, void* stream) {
  if (bad_shape(n, heads, patch)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16 && head_dim == 16) {
    launch_dkdv<__nv_bfloat16, 16>(q, k, v, g, lse, delta, batch, valid, dk, dv, n, heads, patch, scale, s);
  } else if (is_bf16 && head_dim == 32) {
    launch_dkdv<__nv_bfloat16, 32>(q, k, v, g, lse, delta, batch, valid, dk, dv, n, heads, patch, scale, s);
  } else if (!is_bf16 && head_dim == 16) {
    launch_dkdv<float, 16>(q, k, v, g, lse, delta, batch, valid, dk, dv, n, heads, patch, scale, s);
  } else if (!is_bf16 && head_dim == 32) {
    launch_dkdv<float, 32>(q, k, v, g, lse, delta, batch, valid, dk, dv, n, heads, patch, scale, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
