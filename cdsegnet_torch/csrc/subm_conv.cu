// Submanifold sparse convolution as an implicit GEMM, for Hopper (sm_90a).
//
// Replaces no TPU kernel: cdsegnet_tpu/ops/subm_conv.py is an XLA gather of
// the (N, K C_in) neighbour rows and one dot. On this card the same form
// wrote those rows to device memory, kept them for the weight gradient and
// scattered the input gradient back with index_add_. These kernels read each
// neighbour row straight from the features into shared memory inside the
// product, so the gathered matrix never exists and nothing is scattered.
//
// The table: nbr (N, K) int32, row i's neighbour at tap k, or N where the
// voxel is empty (that row reads zeros). Weights are (K, C_in, C_out).
//
// What bounds it: the products of the (row, tap) pairs a block cannot skip.
// A block owns 64 rows in table order. A tap that no row of the block reads
// is skipped whole, so a tile of padding rows runs no tap at all; what is
// left is about twice the needed products at the finest level (most 64-row
// tiles read 20-24 of the 27 taps while a row has 9-10 neighbours). f32 runs
// on the CUDA cores (67 TFLOP/s of FFMA), so it is bound by those products;
// bf16 runs on the tensor cores (mma.sync), where the gathered rows from L2
// and device memory bound it instead.
//
// subm_conv_gemm_fwd_f32 / subm_conv_gemm_fwd_mma (y = conv(x) + bias):
//  - prologue: the block's BM x K slice of the table into shared memory, the
//    taps that some row reads (per 64-row tile; written to tile_taps when
//    the caller asks, for the weight gradient), compacted to a list;
//  - a kStages-deep cp.async pipeline over (tap, BK channels): BM gathered
//    rows (16-byte pieces, zero-filled where the neighbour is missing or
//    past C_in) and the BK x BN slice of W[tap];
//  - f32: register tiles of TM x TN outputs a thread, float4 reads of both
//    tiles; bf16: four warps of m16n8k16 mma.sync with ldmatrix (A rows
//    padded against bank conflicts, W through ldmatrix.trans), f32 sums;
//  - the epilogue adds the bias in f32 and stores each output once; at the
//    coarse levels (few rows, wide channels, long chains of stages) the
//    blocks of a tile share out its taps (grid z) and each writes an f32
//    partial that the caller sums.
// The input gradient is the same kernel: the tables are symmetric (row i
// reads j at tap k exactly when j reads i at tap K-1-k), so
// dx = conv(dy) with W'[k] = W[K-1-k]^T. (The port's f32 forward keeps the
// gather + matmul, ops/subm_conv.py::_forward; in f32 this kernel runs the
// input gradient.)
//
// subm_conv_gemm_wgrad_f32 / subm_conv_gemm_wgrad_mma (dW[k] = sum_i
// x[nbr[i, k]]^T dy[i]): one block per (tap, C_in tile, C_out tile, split).
// A split walks every splits-th 64-row tile, skips those whose tile_taps
// entry says the tap is empty, and streams 16 (f32) or 32 (bf16) rows a
// stage through the same kind of pipeline; the table entries of the next
// stage are loaded a stage ahead, into registers. Each split writes its own
// f32 partial; the caller sums the splits in a fixed order, so runs are
// reproducible.
//
// Channels that are not a multiple of the 16-byte piece (C_in = 6 at the
// stems) take instantiations that copy element by element, padded with
// zeros to the tile. Plain C interface, loaded with ctypes; each entry point
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "attention_tiles.cuh"

namespace {

constexpr int kTile = 64;    // rows of a tile of tile_taps; forward blocks own one
constexpr int kStages = 3;   // cp.async pipeline depth
constexpr int kMaxTaps = 128;

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 4 bytes from global to shared memory, asynchronously; zeros when !pred
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0));
}

// ---------------------------------------------------------------------------
// forward prologue

struct FwdSmem {
  int32_t* slab;  // kTile x k table entries, rows past n read as missing
  int* taps;      // the taps some row reads, then their count at [k]
  uint8_t* on;    // k flags
};

__device__ __forceinline__ FwdSmem fwd_smem(unsigned char* base, int k) {
  FwdSmem s;
  s.slab = reinterpret_cast<int32_t*>(base);
  s.taps = s.slab + kTile * k;
  s.on = reinterpret_cast<uint8_t*>(s.taps + k + 1);
  return s;
}

__host__ __device__ constexpr size_t fwd_prologue_bytes(int k) {
  return (static_cast<size_t>(kTile) * k + k + 1) * 4 + ((k + 15) / 16) * 16;
}

// Load the block's slice of the table, find the taps it reads and return
// how many there are. Writes tile_taps[tile, :] when asked (the first
// block of the tile only).
template <int NT>
__device__ __forceinline__ int block_taps(const int32_t* __restrict__ nbr, int n, int k,
                                          int64_t m0, const FwdSmem& s,
                                          uint8_t* __restrict__ tile_taps) {
  const int tid = threadIdx.x;
  const int rows = n - m0 < kTile ? static_cast<int>(n - m0) : kTile;
  const int32_t* src = nbr + m0 * k;
  for (int e = tid; e < k; e += NT) s.on[e] = 0;
  for (int e = tid; e < kTile * k; e += NT) s.slab[e] = e < rows * k ? src[e] : n;
  __syncthreads();
  for (int e = tid; e < kTile * k; e += NT) {
    if (s.slab[e] != n) s.on[e % k] = 1;  // every writer stores the same 1
  }
  __syncthreads();
  if (tile_taps != nullptr && blockIdx.y == 0 && blockIdx.z == 0) {
    for (int e = tid; e < k; e += NT) tile_taps[blockIdx.x * static_cast<int64_t>(k) + e] = s.on[e];
  }
  if (tid < 32) {
    int count = 0;
    for (int t0 = 0; t0 < k; t0 += 32) {
      const int t = t0 + tid;
      const bool on = t < k && s.on[t];
      const unsigned ballot = __ballot_sync(kAll, on);
      if (on) s.taps[count + __popc(ballot & ((1u << tid) - 1))] = t;
      count += __popc(ballot);
    }
    if (tid == 0) s.taps[k] = count;
  }
  __syncthreads();
  return s.taps[k];
}

// ---------------------------------------------------------------------------
// f32 forward: CUDA cores

template <int BN, int TN, bool VEC>
__global__ void __launch_bounds__(8 * (BN / TN))
subm_conv_gemm_fwd_f32(const float* __restrict__ x, const int32_t* __restrict__ nbr,
                       const float* __restrict__ w, const float* __restrict__ bias,
                       float* __restrict__ y, float* __restrict__ partial,
                       uint8_t* __restrict__ tile_taps, int n, int k, int c_in, int c_out) {
  constexpr int BM = kTile, TM = 8, TY = BM / TM, TX = BN / TN, NT = TX * TY;
  constexpr int BK = VEC ? 16 : 8;
  static_assert(TN % 4 == 0 && BN % (4 * TX) == 0, "columns are read as float4");
  extern __shared__ __align__(16) unsigned char smem[];
  auto As = reinterpret_cast<float(*)[BM][BK]>(smem);
  auto Bs = reinterpret_cast<float(*)[BK][BN]>(smem + kStages * BM * BK * 4);
  const FwdSmem s = fwd_smem(smem + kStages * (BM * BK + BK * BN) * 4, k);

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const int n_taps = block_taps<NT>(nbr, n, k, m0, s, tile_taps);
  // split z of gridDim.z takes its share of the block's taps
  const int t0 = blockIdx.z * n_taps / gridDim.z;
  const int chunks = (c_in + BK - 1) / BK;
  const int steps = ((blockIdx.z + 1) * n_taps / gridDim.z - t0) * chunks;

  auto load = [&](int stage, int step) {
    const int tap = s.taps[t0 + step / chunks], k0 = (step % chunks) * BK;
    const float* wk = w + static_cast<int64_t>(tap) * c_in * c_out;
    if constexpr (VEC) {
      for (int c = tid; c < BM * BK / 4; c += NT) {
        const int r = c / (BK / 4), q = (c % (BK / 4)) * 4;
        const int32_t row = s.slab[r * k + tap];
        const bool in = row != n && k0 + q < c_in;
        cp_async16(&As[stage][r][q], in ? x + static_cast<int64_t>(row) * c_in + k0 + q : x, in);
      }
      for (int c = tid; c < BK * BN / 4; c += NT) {
        const int r = c / (BN / 4), q = (c % (BN / 4)) * 4;
        const bool in = k0 + r < c_in && n0 + q < c_out;
        cp_async16(&Bs[stage][r][q], in ? wk + static_cast<int64_t>(k0 + r) * c_out + n0 + q : w,
                   in);
      }
    } else {
      for (int c = tid; c < BM * BK; c += NT) {
        const int r = c / BK, q = c % BK;
        const int32_t row = s.slab[r * k + tap];
        const bool in = row != n && k0 + q < c_in;
        cp_async4(&As[stage][r][q], in ? x + static_cast<int64_t>(row) * c_in + k0 + q : x, in);
      }
      for (int c = tid; c < BK * BN; c += NT) {
        const int r = c / BN, q = c % BN;
        const bool in = k0 + r < c_in && n0 + q < c_out;
        cp_async4(&Bs[stage][r][q], in ? wk + static_cast<int64_t>(k0 + r) * c_out + n0 + q : w,
                  in);
      }
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < steps) load(st, st);
    cp_async_commit();
  }
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (t + kStages - 1 < steps) load((t + kStages - 1) % kStages, t + kStages - 1);
    cp_async_commit();
    const int st = t % kStages;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float4 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        a[i] = *reinterpret_cast<const float4*>(&As[st][ty + i * TY][kk]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float b[TN];
#pragma unroll
        for (int q = 0; q < TN / 4; ++q) {
          const float4 v = *reinterpret_cast<const float4*>(&Bs[st][kk + j][4 * (tx + q * TX)]);
          b[4 * q] = v.x;
          b[4 * q + 1] = v.y;
          b[4 * q + 2] = v.z;
          b[4 * q + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float av = j == 0 ? a[i].x : j == 1 ? a[i].y : j == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int jj = 0; jj < TN; ++jj) acc[i][jj] = fmaf(av, b[jj], acc[i][jj]);
        }
      }
    }
  }

  // with splits, each writes its f32 partial (the first adds the bias)
  float* out = partial != nullptr ? partial + blockIdx.z * static_cast<int64_t>(n) * c_out : y;
  const bool with_bias = bias != nullptr && blockIdx.z == 0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t row = m0 + ty + i * TY;
    if (row >= n) continue;
#pragma unroll
    for (int q = 0; q < TN / 4; ++q) {
      const int col = n0 + 4 * (tx + q * TX);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (col + e < c_out) {
          out[row * c_out + col + e] = acc[i][4 * q + e] + (with_bias ? bias[col + e] : 0.f);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 forward: tensor cores

template <int BN, bool VEC>
__global__ void __launch_bounds__(128)
subm_conv_gemm_fwd_mma(const bf16* __restrict__ x, const int32_t* __restrict__ nbr,
                       const bf16* __restrict__ w, const float* __restrict__ bias,
                       bf16* __restrict__ y, float* __restrict__ partial,
                       uint8_t* __restrict__ tile_taps, int n, int k, int c_in, int c_out) {
  constexpr int BM = kTile, BK = 32, NT = 128;
  constexpr int WM = BM / 2, WN = BN / 2, MI = WM / 16, NI = WN / 8;
  static_assert(NI % 2 == 0, "ldmatrix.x4.trans loads n8 tiles in pairs");
  extern __shared__ __align__(16) unsigned char smem[];
  auto As = reinterpret_cast<bf16(*)[BM][BK + 8]>(smem);
  auto Bs = reinterpret_cast<bf16(*)[BK][BN + 8]>(smem + kStages * BM * (BK + 8) * 2);
  const FwdSmem s = fwd_smem(smem + kStages * (BM * (BK + 8) + BK * (BN + 8)) * 2, k);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm0 = (warp >> 1) * WM, wn0 = (warp & 1) * WN;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const int n_taps = block_taps<NT>(nbr, n, k, m0, s, tile_taps);
  // split z of gridDim.z takes its share of the block's taps
  const int t0 = blockIdx.z * n_taps / gridDim.z;
  const int chunks = (c_in + BK - 1) / BK;
  const int steps = ((blockIdx.z + 1) * n_taps / gridDim.z - t0) * chunks;

  auto load = [&](int stage, int step) {
    const int tap = s.taps[t0 + step / chunks], k0 = (step % chunks) * BK;
    const bf16* wk = w + static_cast<int64_t>(tap) * c_in * c_out;
    if constexpr (VEC) {
      for (int c = tid; c < BM * BK / 8; c += NT) {
        const int r = c / (BK / 8), q = (c % (BK / 8)) * 8;
        const int32_t row = s.slab[r * k + tap];
        const bool in = row != n && k0 + q < c_in;
        cp_async16(&As[stage][r][q], in ? x + static_cast<int64_t>(row) * c_in + k0 + q : x, in);
      }
      for (int c = tid; c < BK * BN / 8; c += NT) {
        const int r = c / (BN / 8), q = (c % (BN / 8)) * 8;
        const bool in = k0 + r < c_in && n0 + q < c_out;
        cp_async16(&Bs[stage][r][q], in ? wk + static_cast<int64_t>(k0 + r) * c_out + n0 + q : w,
                   in);
      }
    } else {
      for (int c = tid; c < BM * BK; c += NT) {
        const int r = c / BK, q = c % BK;
        const int32_t row = s.slab[r * k + tap];
        As[stage][r][q] = row != n && k0 + q < c_in
                              ? x[static_cast<int64_t>(row) * c_in + k0 + q]
                              : __float2bfloat16(0.f);
      }
      for (int c = tid; c < BK * BN; c += NT) {
        const int r = c / BN, q = c % BN;
        Bs[stage][r][q] = k0 + r < c_in && n0 + q < c_out
                              ? wk[static_cast<int64_t>(k0 + r) * c_out + n0 + q]
                              : __float2bfloat16(0.f);
      }
    }
  };

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int j = 0; j < NI; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    }
  }
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < steps) load(st, st);
    cp_async_commit();
  }
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (t + kStages - 1 < steps) load((t + kStages - 1) % kStages, t + kStages - 1);
    cp_async_commit();
    const int st = t % kStages;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t a[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        ldmatrix_x4(a[i], &As[st][wm0 + 16 * i + (lane & 15)][16 * ks + 8 * (lane >> 4)]);
      }
#pragma unroll
      for (int np = 0; np < NI / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, &Bs[st][16 * ks + (lane & 15)][wn0 + 16 * np + 8 * (lane >> 4)]);
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          mma(acc[i][2 * np], a[i], b[0], b[1]);
          mma(acc[i][2 * np + 1], a[i], b[2], b[3]);
        }
      }
    }
  }

  // with splits, each writes its f32 partial (the first adds the bias)
  float* part = partial != nullptr ? partial + blockIdx.z * static_cast<int64_t>(n) * c_out
                                   : nullptr;
  const bool with_bias = bias != nullptr && blockIdx.z == 0;
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int64_t row = m0 + wm0 + 16 * i + g + 8 * half;
      if (row >= n) continue;
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int col = n0 + wn0 + 8 * j + 2 * tq;
        const float v0 = acc[i][j][2 * half] + (with_bias && col < c_out ? bias[col] : 0.f);
        const float v1 =
            acc[i][j][2 * half + 1] + (with_bias && col + 1 < c_out ? bias[col + 1] : 0.f);
        if (part != nullptr) {
          if (col < c_out) part[row * c_out + col] = v0;
          if (col + 1 < c_out) part[row * c_out + col + 1] = v1;
        } else if constexpr (VEC) {
          if (col < c_out) *reinterpret_cast<uint32_t*>(y + row * c_out + col) = pack(v0, v1);
        } else {
          if (col < c_out) y[row * c_out + col] = __float2bfloat16(v0);
          if (col + 1 < c_out) y[row * c_out + col + 1] = __float2bfloat16(v1);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// weight gradient: the tiles a split walks

// Compact the block's tiles (split, split + splits, ...) whose tap is not
// empty into `list`; returns how many there are.
template <int NT>
__device__ __forceinline__ int split_tiles(const uint8_t* __restrict__ tile_taps, int n_tiles,
                                           int k, int tap, int split, int splits, int* list,
                                           uint8_t* on) {
  const int tid = threadIdx.x;
  const int mine = split < n_tiles ? (n_tiles - split + splits - 1) / splits : 0;
  for (int j = tid; j < mine; j += NT) {
    on[j] = tile_taps[static_cast<int64_t>(split + j * splits) * k + tap];
  }
  __syncthreads();
  if (tid < 32) {
    int count = 0;
    for (int j0 = 0; j0 < mine; j0 += 32) {
      const int j = j0 + tid;
      const bool keep = j < mine && on[j];
      const unsigned ballot = __ballot_sync(kAll, keep);
      if (keep) list[count + __popc(ballot & ((1u << tid) - 1))] = split + j * splits;
      count += __popc(ballot);
    }
    if (tid == 0) list[mine] = count;
  }
  __syncthreads();
  return list[mine];
}

// ---------------------------------------------------------------------------
// f32 weight gradient: CUDA cores, 64 threads, TM x TN = BM / 8 x BN / 8.
// VA: x's rows copy in 16-byte pieces; without it (C_in = 6 at the stems)
// BM is 32, four threads copy a row's C_in elements in 4-byte pieces and
// the columns past C_in stay the zeros written first. VB: dy's likewise,
// else 4-byte pieces.

template <int BM, int BN, bool VA, bool VB>
__global__ void __launch_bounds__(64)
subm_conv_gemm_wgrad_f32(const float* __restrict__ x, const int32_t* __restrict__ nbr,
                         const float* __restrict__ dy, const uint8_t* __restrict__ tile_taps,
                         float* __restrict__ partial, int n, int k, int c_in, int c_out,
                         int splits) {
  constexpr int NT = 64, TM = BM / 8, TN = BN / 8, BR = 16, PER_TILE = kTile / BR;
  // A copies a thread makes a stage, each with its own table entry
  constexpr int A_CH = VA ? BR * BM / 4 / NT : 1;
  static_assert(TM % 4 == 0 && TN % 4 == 0, "rows are read as float4");
  static_assert(VA || (BM == 32 && 4 * BR == NT), "element copies: 4 threads a row");
  extern __shared__ __align__(16) unsigned char smem[];
  auto As = reinterpret_cast<float(*)[BR][BM]>(smem);
  auto Bs = reinterpret_cast<float(*)[BR][BN]>(smem + kStages * BR * BM * 4);
  int* list = reinterpret_cast<int*>(smem + kStages * BR * (BM + BN) * 4);

  const int tid = threadIdx.x, tx = tid % 8, ty = tid / 8;
  const int tap = blockIdx.x, split = blockIdx.z;
  const int n_co = (c_out + BN - 1) / BN;
  const int ci0 = (blockIdx.y / n_co) * BM, co0 = (blockIdx.y % n_co) * BN;
  const int n_tiles = (n + kTile - 1) / kTile;
  const int mine = split < n_tiles ? (n_tiles - split + splits - 1) / splits : 0;
  uint8_t* on = reinterpret_cast<uint8_t*>(list + mine + 1);
  if constexpr (!VA) {
    for (int e = tid; e < kStages * BR * BM; e += NT) (&As[0][0][0])[e] = 0.f;
  }
  const int steps = PER_TILE * split_tiles<NT>(tile_taps, n_tiles, k, tap, split, splits, list, on);

  auto first_row = [&](int step) -> int64_t {
    return static_cast<int64_t>(list[step / PER_TILE]) * kTile + (step % PER_TILE) * BR;
  };
  // the tile row of copy j of this thread
  auto a_row = [&](int j) { return VA ? (tid + j * NT) / (BM / 4) : tid / 4; };
  // table entries of the rows this thread copies at `step`
  auto fetch = [&](int step, int32_t (&idx)[A_CH]) {
    if (step >= steps) return;
    const int64_t r0 = first_row(step);
#pragma unroll
    for (int j = 0; j < A_CH; ++j) {
      const int64_t i = r0 + a_row(j);
      idx[j] = i < n ? __ldg(nbr + i * k + tap) : n;
    }
  };
  auto load = [&](int stage, int step, const int32_t (&idx)[A_CH]) {
    const int64_t r0 = first_row(step);
    if constexpr (VA) {
#pragma unroll
      for (int j = 0; j < A_CH; ++j) {
        const int r = a_row(j), q = ((tid + j * NT) % (BM / 4)) * 4;
        const bool in = idx[j] != n && ci0 + q < c_in;
        cp_async16(&As[stage][r][q], in ? x + static_cast<int64_t>(idx[j]) * c_in + ci0 + q : x,
                   in);
      }
    } else {
      const int r = a_row(0), width = min(BM, c_in - ci0);
      for (int q = tid % 4; q < width; q += 4) {
        const bool in = idx[0] != n;
        cp_async4(&As[stage][r][q], in ? x + static_cast<int64_t>(idx[0]) * c_in + ci0 + q : x,
                  in);
      }
    }
    constexpr int PIECE = VB ? 4 : 1;
    for (int c = tid; c < BR * BN / PIECE; c += NT) {
      const int r = c / (BN / PIECE), q = (c % (BN / PIECE)) * PIECE;
      const bool in = r0 + r < n && co0 + q < c_out;
      const float* src = in ? dy + (r0 + r) * c_out + co0 + q : dy;
      if constexpr (VB) {
        cp_async16(&Bs[stage][r][q], src, in);
      } else {
        cp_async4(&Bs[stage][r][q], src, in);
      }
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }
  int32_t idx[A_CH];
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < steps) {
      fetch(st, idx);
      load(st, st, idx);
    }
    cp_async_commit();
  }
  fetch(kStages - 1, idx);
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (t + kStages - 1 < steps) load((t + kStages - 1) % kStages, t + kStages - 1, idx);
    cp_async_commit();
    fetch(t + kStages, idx);  // consumed next iteration: the loads overlap this one's sums
    const int st = t % kStages;
#pragma unroll
    for (int r = 0; r < BR; ++r) {
      float a[TM], b[TN];
#pragma unroll
      for (int q = 0; q < TM / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(&As[st][r][4 * (ty + 8 * q)]);
        a[4 * q] = v.x;
        a[4 * q + 1] = v.y;
        a[4 * q + 2] = v.z;
        a[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int q = 0; q < TN / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(&Bs[st][r][4 * (tx + 8 * q)]);
        b[4 * q] = v.x;
        b[4 * q + 1] = v.y;
        b[4 * q + 2] = v.z;
        b[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
  }

  float* out = partial + (static_cast<int64_t>(split) * k + tap) * c_in * c_out;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int ci = ci0 + 4 * (ty + 8 * (i / 4)) + i % 4;
    if (ci >= c_in) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int co = co0 + 4 * (tx + 8 * (j / 4)) + j % 4;
      if (co < c_out) out[static_cast<int64_t>(ci) * c_out + co] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 weight gradient: tensor cores, four warps of (BM / 2) x (BN / 2)

template <int BM, int BN, bool VEC>
__global__ void __launch_bounds__(128)
subm_conv_gemm_wgrad_mma(const bf16* __restrict__ x, const int32_t* __restrict__ nbr,
                         const bf16* __restrict__ dy, const uint8_t* __restrict__ tile_taps,
                         float* __restrict__ partial, int n, int k, int c_in, int c_out,
                         int splits) {
  constexpr int NT = 128, BR = 32, PER_TILE = kTile / BR;
  constexpr int WM = BM / 2, WN = BN / 2, MI = WM / 16, NI = WN / 8;
  constexpr int PIECE = VEC ? 8 : 1;
  constexpr int A_CH = (BR * BM / PIECE + NT - 1) / NT;
  static_assert(NI % 2 == 0, "ldmatrix.x4.trans loads n8 tiles in pairs");
  extern __shared__ __align__(16) unsigned char smem[];
  auto As = reinterpret_cast<bf16(*)[BR][BM + 8]>(smem);
  auto Bs = reinterpret_cast<bf16(*)[BR][BN + 8]>(smem + kStages * BR * (BM + 8) * 2);
  int* list = reinterpret_cast<int*>(smem + kStages * BR * (BM + BN + 16) * 2);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm0 = (warp >> 1) * WM, wn0 = (warp & 1) * WN;
  const int tap = blockIdx.x, split = blockIdx.z;
  const int n_co = (c_out + BN - 1) / BN;
  const int ci0 = (blockIdx.y / n_co) * BM, co0 = (blockIdx.y % n_co) * BN;
  const int n_tiles = (n + kTile - 1) / kTile;
  const int mine = split < n_tiles ? (n_tiles - split + splits - 1) / splits : 0;
  uint8_t* on = reinterpret_cast<uint8_t*>(list + mine + 1);
  const int steps = PER_TILE * split_tiles<NT>(tile_taps, n_tiles, k, tap, split, splits, list, on);

  auto first_row = [&](int step) -> int64_t {
    return static_cast<int64_t>(list[step / PER_TILE]) * kTile + (step % PER_TILE) * BR;
  };
  auto fetch = [&](int step, int32_t (&idx)[A_CH]) {
    if (step >= steps) return;
    const int64_t r0 = first_row(step);
#pragma unroll
    for (int j = 0; j < A_CH; ++j) {
      const int c = tid + j * NT;
      const int64_t i = r0 + c / (BM / PIECE);
      idx[j] = c < BR * BM / PIECE && i < n ? __ldg(nbr + i * k + tap) : n;
    }
  };
  auto load = [&](int stage, int step, const int32_t (&idx)[A_CH]) {
    const int64_t r0 = first_row(step);
#pragma unroll
    for (int j = 0; j < A_CH; ++j) {
      const int c = tid + j * NT;
      if (c >= BR * BM / PIECE) break;
      const int r = c / (BM / PIECE), q = (c % (BM / PIECE)) * PIECE;
      const bool in = idx[j] != n && ci0 + q < c_in;
      const bf16* src = x + static_cast<int64_t>(idx[j]) * c_in + ci0 + q;
      if constexpr (VEC) {
        cp_async16(&As[stage][r][q], in ? src : x, in);
      } else {
        As[stage][r][q] = in ? *src : __float2bfloat16(0.f);
      }
    }
    for (int c = tid; c < BR * BN / PIECE; c += NT) {
      const int r = c / (BN / PIECE), q = (c % (BN / PIECE)) * PIECE;
      const bool in = r0 + r < n && co0 + q < c_out;
      const bf16* src = dy + (r0 + r) * c_out + co0 + q;
      if constexpr (VEC) {
        cp_async16(&Bs[stage][r][q], in ? src : dy, in);
      } else {
        Bs[stage][r][q] = in ? *src : __float2bfloat16(0.f);
      }
    }
  };

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int j = 0; j < NI; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    }
  }
  int32_t idx[A_CH];
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < steps) {
      fetch(st, idx);
      load(st, st, idx);
    }
    cp_async_commit();
  }
  fetch(kStages - 1, idx);
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (t + kStages - 1 < steps) load((t + kStages - 1) % kStages, t + kStages - 1, idx);
    cp_async_commit();
    fetch(t + kStages, idx);
    const int st = t % kStages;
#pragma unroll
    for (int ks = 0; ks < BR / 16; ++ks) {
      // A = x^T (rows of the tile are its k index): ldmatrix.trans
      uint32_t a[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        ldmatrix_x4_trans(a[i], &As[st][16 * ks + (lane & 7) + ((lane >> 4) << 3)]
                                   [wm0 + 16 * i + 8 * ((lane >> 3) & 1)]);
      }
#pragma unroll
      for (int np = 0; np < NI / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, &Bs[st][16 * ks + (lane & 15)][wn0 + 16 * np + 8 * (lane >> 4)]);
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          mma(acc[i][2 * np], a[i], b[0], b[1]);
          mma(acc[i][2 * np + 1], a[i], b[2], b[3]);
        }
      }
    }
  }

  float* out = partial + (static_cast<int64_t>(split) * k + tap) * c_in * c_out;
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ci = ci0 + wm0 + 16 * i + g + 8 * half;
      if (ci >= c_in) continue;
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int co = co0 + wn0 + 8 * j + 2 * tq;
        if (co < c_out) out[static_cast<int64_t>(ci) * c_out + co] = acc[i][j][2 * half];
        if (co + 1 < c_out) out[static_cast<int64_t>(ci) * c_out + co + 1] = acc[i][j][2 * half + 1];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side

// Raise a kernel's dynamic shared memory limit to `bytes` where it is below;
// `allowed` is the launcher's own record of the limit it set.
template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes, size_t* allowed) {
  if (bytes > *allowed) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    *allowed = bytes;
  }
  return 0;
}

// Output columns a forward block owns: f32 32, 64 or 96; bf16 32, 64 or
// 128. Narrower where the widest would leave fewer than two blocks for each
// of the card's sms streaming multiprocessors (the coarse levels: few
// rows, many channels).
int fwd_cols(int n, int c_out, bool is_bf16, int sms) {
  int cols;
  if (c_out <= 32) {
    cols = 32;
  } else if (c_out <= 64) {
    cols = 64;
  } else if (is_bf16) {
    cols = c_out % 128 == 0 ? 128 : 64;
  } else {
    cols = c_out <= 96 || c_out % 96 == 0 ? 96 : 64;
  }
  const int64_t rows = (n + kTile - 1) / kTile;
  while (cols > 32 && rows * ((c_out + cols - 1) / cols) < 2 * sms) {
    cols = cols == 96 ? 32 : cols / 2;
  }
  return cols;
}

// channels a weight-gradient block owns on one side: f32 32, 64 or 96;
// bf16 32 or 64
int wgrad_cols(int c, bool is_bf16) {
  if (c <= 32) return 32;
  if (is_bf16 || c <= 64 || c % 96 != 0) return 64;
  return 96;
}

bool aligned(std::initializer_list<const void*> ptrs, int elems_per_piece,
             std::initializer_list<int> widths) {
  for (int c : widths) {
    if (c % elems_per_piece != 0) return false;
  }
  return !misaligned(ptrs);
}

template <int BN, int TN, bool VEC>
int fwd_f32(const float* x, const int32_t* nbr, const float* w, const float* bias, float* y,
            float* partial, uint8_t* tile_taps, int n, int k, int c_in, int c_out, int splits,
            cudaStream_t stream) {
  constexpr int BK = VEC ? 16 : 8, NT = 8 * (BN / TN);
  const size_t bytes = kStages * (kTile * BK + BK * BN) * 4 + fwd_prologue_bytes(k);
  auto kernel = subm_conv_gemm_fwd_f32<BN, TN, VEC>;
  static size_t allowed = 48 * 1024;
  if (int err = set_smem(kernel, bytes, &allowed)) return err;
  dim3 grid((n + kTile - 1) / kTile, (c_out + BN - 1) / BN, splits);
  kernel<<<grid, NT, bytes, stream>>>(x, nbr, w, bias, y, partial, tile_taps, n, k, c_in,
                                      c_out);
  return 0;
}

template <int BN, bool VEC>
int fwd_mma(const bf16* x, const int32_t* nbr, const bf16* w, const float* bias, bf16* y,
            float* partial, uint8_t* tile_taps, int n, int k, int c_in, int c_out, int splits,
            cudaStream_t stream) {
  constexpr int BK = 32;
  const size_t bytes = kStages * (kTile * (BK + 8) + BK * (BN + 8)) * 2 + fwd_prologue_bytes(k);
  auto kernel = subm_conv_gemm_fwd_mma<BN, VEC>;
  static size_t allowed = 48 * 1024;
  if (int err = set_smem(kernel, bytes, &allowed)) return err;
  dim3 grid((n + kTile - 1) / kTile, (c_out + BN - 1) / BN, splits);
  kernel<<<grid, 128, bytes, stream>>>(x, nbr, w, bias, y, partial, tile_taps, n, k, c_in,
                                       c_out);
  return 0;
}

size_t list_bytes(int n, int splits) {
  const int mine = ((n + kTile - 1) / kTile + splits - 1) / splits;
  return (mine + 1) * 4 + ((mine + 15) / 16) * 16;
}

template <int BM, int BN, bool VA, bool VB>
int wgrad_f32(const float* x, const int32_t* nbr, const float* dy, const uint8_t* tile_taps,
              float* partial, int n, int k, int c_in, int c_out, int splits,
              cudaStream_t stream) {
  const size_t bytes = kStages * 16 * (BM + BN) * 4 + list_bytes(n, splits);
  auto kernel = subm_conv_gemm_wgrad_f32<BM, BN, VA, VB>;
  static size_t allowed = 48 * 1024;
  if (int err = set_smem(kernel, bytes, &allowed)) return err;
  dim3 grid(k, ((c_in + BM - 1) / BM) * ((c_out + BN - 1) / BN), splits);
  kernel<<<grid, 64, bytes, stream>>>(x, nbr, dy, tile_taps, partial, n, k, c_in, c_out,
                                      splits);
  return 0;
}

template <int BM, int BN, bool VEC>
int wgrad_mma(const bf16* x, const int32_t* nbr, const bf16* dy, const uint8_t* tile_taps,
              float* partial, int n, int k, int c_in, int c_out, int splits,
              cudaStream_t stream) {
  const size_t bytes = kStages * 32 * (BM + BN + 16) * 2 + list_bytes(n, splits);
  auto kernel = subm_conv_gemm_wgrad_mma<BM, BN, VEC>;
  static size_t allowed = 48 * 1024;
  if (int err = set_smem(kernel, bytes, &allowed)) return err;
  dim3 grid(k, ((c_in + BM - 1) / BM) * ((c_out + BN - 1) / BN), splits);
  kernel<<<grid, 128, bytes, stream>>>(x, nbr, dy, tile_taps, partial, n, k, c_in, c_out,
                                       splits);
  return 0;
}

int wgrad_f32_any(int bm, int bn, const float* x, const int32_t* nbr, const float* dy,
                  const uint8_t* tile_taps, float* partial, int n, int k, int c_in, int c_out,
                  int splits, cudaStream_t s) {
#define CDSEG_WGRAD(M, N)                                                                 \
  if (bm == M && bn == N)                                                                 \
    return wgrad_f32<M, N, true, true>(x, nbr, dy, tile_taps, partial, n, k, c_in, c_out, \
                                       splits, s);
  CDSEG_WGRAD(32, 32)
  CDSEG_WGRAD(32, 64)
  CDSEG_WGRAD(32, 96)
  CDSEG_WGRAD(64, 32)
  CDSEG_WGRAD(64, 64)
  CDSEG_WGRAD(64, 96)
  CDSEG_WGRAD(96, 32)
  CDSEG_WGRAD(96, 64)
  CDSEG_WGRAD(96, 96)
#undef CDSEG_WGRAD
  return static_cast<int>(cudaErrorInvalidValue);
}

bool bad_conv_shape(int n, int k, int c_in, int c_out) {
  return n <= 0 || k <= 0 || k > kMaxTaps || c_in <= 0 || c_out <= 0 ||
         (n + kTile - 1) / kTile > 0x7fffffff / kMaxTaps;
}

}  // namespace

// How many splits of its taps a forward block takes: one where the row
// and column tiles alone give some sixteen blocks a streaming
// multiprocessor; at the coarse levels (few rows, wide channels, long
// chains of (tap, channel chunk) stages) up to 8, keeping 32 stages a split.
extern "C" int cdseg_subm_conv_gemm_fwd_splits(int n, int k, int c_in, int c_out,
                                               int is_bf16, int sms) {
  const int cols = fwd_cols(n, c_out, is_bf16, sms);
  const int64_t blocks = static_cast<int64_t>((n + kTile - 1) / kTile) * ((c_out + cols - 1) / cols);
  const int chain = k * ((c_in + (is_bf16 ? 31 : 15)) / (is_bf16 ? 32 : 16));
  if (blocks >= 16 * sms) return 1;
  const int want = static_cast<int>((16 * sms + blocks - 1) / blocks);
  return std::max(1, std::min({want, chain / 32, 8}));
}

// y = conv(x) + bias, x (n, c_in), y (n, c_out), w (k, c_in, c_out) in x's
// type, bias f32 (c_out) or null; tile_taps, when not null, gets the
// (ceil(n / 64), k) flags of the taps each 64-row tile reads. With splits
// > 1 the blocks share out their taps and each split writes its f32 share
// of y (the first with the bias) to partial (splits, n, c_out); the caller
// sums them, and y is not written. sms is the card's count of streaming
// multiprocessors, as given to cdseg_subm_conv_gemm_fwd_splits.
extern "C" int cdseg_subm_conv_gemm_fwd(const void* x, const void* nbr, const void* w,
                                        const void* bias, void* y, void* partial,
                                        void* tile_taps, int n, int k, int c_in, int c_out,
                                        int splits, int is_bf16, int sms, void* stream) {
  if (bad_conv_shape(n, k, c_in, c_out) || c_out > 65535 * 32 || splits <= 0 || splits > 64 ||
      (splits > 1) != (partial != nullptr) || sms <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* t = static_cast<const int32_t*>(nbr);
  const auto* b = static_cast<const float*>(bias);
  auto* p = static_cast<float*>(partial);
  auto* taps = static_cast<uint8_t*>(tile_taps);
  int err;
  if (is_bf16) {
    const auto* xx = static_cast<const bf16*>(x);
    const auto* ww = static_cast<const bf16*>(w);
    auto* yy = static_cast<bf16*>(y);
    if (!aligned({x, w, y}, 8, {c_in, c_out})) {
      err = fwd_mma<32, false>(xx, t, ww, b, yy, p, taps, n, k, c_in, c_out, splits, s);
    } else {
      switch (fwd_cols(n, c_out, true, sms)) {
        case 32: err = fwd_mma<32, true>(xx, t, ww, b, yy, p, taps, n, k, c_in, c_out, splits, s); break;
        case 64: err = fwd_mma<64, true>(xx, t, ww, b, yy, p, taps, n, k, c_in, c_out, splits, s); break;
        default: err = fwd_mma<128, true>(xx, t, ww, b, yy, p, taps, n, k, c_in, c_out, splits, s);
      }
    }
  } else {
    const auto* xx = static_cast<const float*>(x);
    const auto* ww = static_cast<const float*>(w);
    auto* yy = static_cast<float*>(y);
    if (!aligned({x, w, y}, 4, {c_in, c_out})) {
      err = fwd_f32<32, 4, false>(xx, t, ww, b, yy, p, taps, n, k, c_in, c_out, splits, s);
    } else {
      switch (fwd_cols(n, c_out, false, sms)) {
        case 32: err = fwd_f32<32, 4, true>(xx, t, ww, b, yy, p, taps, n, k, c_in, c_out, splits, s); break;
        case 64: err = fwd_f32<64, 8, true>(xx, t, ww, b, yy, p, taps, n, k, c_in, c_out, splits, s); break;
        default: err = fwd_f32<96, 12, true>(xx, t, ww, b, yy, p, taps, n, k, c_in, c_out, splits, s);
      }
    }
  }
  return err ? err : static_cast<int>(cudaGetLastError());
}

// How many row splits the weight gradient takes: enough blocks for about
// sixteen a streaming multiprocessor, at most one split per 64-row tile.
// More splits make each block's chain of row stages shorter (at SpUNet's
// level 0, 2.42 ms against 3.50 with four a multiprocessor) and its f32
// sums shorter; the partials stay under 100 MB.
extern "C" int cdseg_subm_conv_gemm_splits(int n, int k, int c_in, int c_out, int is_bf16,
                                           int sms) {
  const int bm = wgrad_cols(c_in, is_bf16), bn = wgrad_cols(c_out, is_bf16);
  const int tiles = ((c_in + bm - 1) / bm) * ((c_out + bn - 1) / bn);
  const int n_tiles = (n + kTile - 1) / kTile;
  const int want = (16 * sms + k * tiles - 1) / (k * tiles);
  return std::max(1, std::min(std::min(want, n_tiles), 65535));
}

// partial[split] (splits, k, c_in, c_out) f32: each split's share of
// dW[k] = sum_i x[nbr[i, k]]^T dy[i], over the 64-row tiles that tile_taps
// marks for tap k. The caller sums the splits.
extern "C" int cdseg_subm_conv_gemm_wgrad(const void* x, const void* nbr, const void* dy,
                                          const void* tile_taps, void* partial, int n, int k,
                                          int c_in, int c_out, int splits, int is_bf16,
                                          void* stream) {
  if (bad_conv_shape(n, k, c_in, c_out) || splits <= 0 || splits > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* t = static_cast<const int32_t*>(nbr);
  const auto* taps = static_cast<const uint8_t*>(tile_taps);
  auto* p = static_cast<float*>(partial);
  const int bm = wgrad_cols(c_in, is_bf16), bn = wgrad_cols(c_out, is_bf16);
  int err;
  if (is_bf16) {
    const auto* xx = static_cast<const bf16*>(x);
    const auto* gg = static_cast<const bf16*>(dy);
    if (!aligned({x, dy}, 8, {c_in, c_out})) {
      err = wgrad_mma<32, 32, false>(xx, t, gg, taps, p, n, k, c_in, c_out, splits, s);
    } else if (bm == 32) {
      err = bn == 32 ? wgrad_mma<32, 32, true>(xx, t, gg, taps, p, n, k, c_in, c_out, splits, s)
                     : wgrad_mma<32, 64, true>(xx, t, gg, taps, p, n, k, c_in, c_out, splits, s);
    } else {
      err = bn == 32 ? wgrad_mma<64, 32, true>(xx, t, gg, taps, p, n, k, c_in, c_out, splits, s)
                     : wgrad_mma<64, 64, true>(xx, t, gg, taps, p, n, k, c_in, c_out, splits, s);
    }
  } else {
    const auto* xx = static_cast<const float*>(x);
    const auto* gg = static_cast<const float*>(dy);
    const bool va = aligned({x}, 4, {c_in}), vb = aligned({dy}, 4, {c_out});
    if (va && vb) {
      err = wgrad_f32_any(bm, bn, xx, t, gg, taps, p, n, k, c_in, c_out, splits, s);
    } else if (vb) {  // the stems: C_in = 6
      err = wgrad_f32<32, 32, false, true>(xx, t, gg, taps, p, n, k, c_in, c_out, splits, s);
    } else {
      err = wgrad_f32<32, 32, false, false>(xx, t, gg, taps, p, n, k, c_in, c_out, splits, s);
    }
  }
  return err ? err : static_cast<int>(cudaGetLastError());
}
