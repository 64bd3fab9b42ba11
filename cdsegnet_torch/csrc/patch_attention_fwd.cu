// Masked patch attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel cdsegnet_tpu/ops/pallas/flash_attention.py::_attn_kernel.
// Points are serialized and cut into patches of `patch` consecutive rows; a
// query row attends to the keys of its own patch that are valid and belong to
// the same scene. q, k, v are contiguous (N, H, D) arrays, N = P * patch.
//
// What bounds it on this card: at D = 16 every key costs one exponential per
// 64 FLOPs (2*D for q.k, 2*D for p.v), so the SFU's exponential rate, not the
// tensor cores, is the practical ceiling; the FLOPs follow, and the bytes
// (q, k, v read once, o written once) are far below either.
//
// What this design does about it: nothing yet. It is the simple version that
// is right: one block per (patch, head, tile of 128 query rows), one query
// row per thread with q and an f32 accumulator of D values in registers; the
// patch's keys and values stream through shared memory in tiles of 64 keys,
// widened to f32, with an online softmax (running max and sum in f32, exp2f
// with scale * log2(e) folded into q). Products are plain f32 FMAs, at least
// as exact as the TPU kernel's 3-pass bf16 split. A key tile that no query of
// the block can see (keys are sorted by scene) is skipped. mma.sync/wgmma,
// TMA and finer tile skipping come later.
//
// Masking is exact: a masked key contributes exp2(-inf) = 0. A row with no
// allowed key (only padding rows have none: a valid row always sees itself)
// is written as zeros, so every output row is finite.
//
// Training passes `lse`, an f32 (N, H) array, and gets the row's natural
// log-sum-exp of the scaled logits, (m + log2 l) * ln 2, from the running max
// and sum; -inf on rows with no allowed key. The backward kernels
// (patch_attention_bwd.cu) recompute p from it. Inference passes null.
//
// Plain C interface, loaded with ctypes; returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQueryTile = 128;  // query rows per block, one per thread
constexpr int kKeyTile = 64;     // keys per shared-memory tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int D>
__global__ void __launch_bounds__(kQueryTile)
patch_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const int32_t* __restrict__ batch,
                           const uint8_t* __restrict__ valid,
                           T* __restrict__ out, float* __restrict__ lse,
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
  const T* qp = q + (qrow * heads + head) * D;
#pragma unroll
  for (int e = 0; e < D; ++e) {
    qf[e] = load_f32(qp + e) * scale_log2;
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
        kx = load_f32(k + off);
        vx = load_f32(v + off);
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
    T* op = out + (qrow * heads + head) * D;
#pragma unroll
    for (int e = 0; e < D; ++e) store_f32(op + e, acc[e] * inv);
    if (lse != nullptr) {
      lse[qrow * heads + head] = l > 0.f ? (m + log2f(l)) * kLn2 : -INFINITY;
    }
  }
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, const void* batch,
            const void* valid, void* out, float* lse, int n, int heads,
            int patch, float scale, cudaStream_t stream) {
  const dim3 grid((patch + kQueryTile - 1) / kQueryTile, heads, n / patch);
  patch_attention_fwd_kernel<T, D><<<grid, kQueryTile, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(batch),
      static_cast<const uint8_t*>(valid), static_cast<T*>(out), lse, heads,
      patch, scale * kLog2e);
}

}  // namespace

// q, k, v, out: contiguous (n, heads, head_dim), float32 (is_bf16 = 0) or
// bfloat16 (is_bf16 = 1). batch: int32 (n,) scene ids; valid: bool (n,).
// lse: null, or float32 (n, heads). n must be a positive multiple of patch;
// head_dim must be 16 or 32.
extern "C" int cdseg_patch_attention_fwd(const void* q, const void* k,
                                         const void* v, const void* batch,
                                         const void* valid, void* out,
                                         void* lse, int n, int heads,
                                         int head_dim, int patch, float scale,
                                         int is_bf16, void* stream) {
  if (n <= 0 || patch <= 0 || heads <= 0 || n % patch != 0 ||
      n / patch > 65535 || heads > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (is_bf16) {
    if (head_dim == 16) {
      launch<__nv_bfloat16, 16>(q, k, v, batch, valid, out, l, n, heads, patch, scale, s);
    } else if (head_dim == 32) {
      launch<__nv_bfloat16, 32>(q, k, v, batch, valid, out, l, n, heads, patch, scale, s);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    if (head_dim == 16) {
      launch<float, 16>(q, k, v, batch, valid, out, l, n, heads, patch, scale, s);
    } else if (head_dim == 32) {
      launch<float, 32>(q, k, v, batch, valid, out, l, n, heads, patch, scale, s);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
