// Shared pieces of the two GEMM-shaped kernels (conv3x3.cu, deconv2x2.cu).
//
// Both run one 64x64 output tile per 256-thread block: each thread owns a
// 4x4 micro-tile of f32 accumulators, and the block walks the reduction
// dimension 16 deep at a time through shared memory.  Inputs are read as
// T (float or bf16) and widened to f32 when they are staged, so one code
// path serves both dtypes and always accumulates in f32.  This is CUDA-core
// (SIMT) arithmetic; tensor cores (wgmma) and TMA staging are later work.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sfh {

constexpr int kBM = 64;        // output rows (pixels) per block
constexpr int kBN = 64;        // output columns (channels) per block
constexpr int kBK = 16;        // reduction depth per shared-memory stage
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kPadA = 4;       // keeps float4 alignment, spreads banks

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

struct TileSmem {
  float a[kBK][kBM + kPadA];   // A tile, stored k-major: a[k][m]
  float b[kBK][kBN];           // B tile: b[k][n]
};

// B tile: rows [k0, k0+kBK) x cols [n0, n0+kBN) of a row-major (K, ncols)
// matrix.  Consecutive threads read consecutive columns (coalesced).
template <typename T>
__device__ __forceinline__ void load_b_tile(TileSmem& s, const T* __restrict__ mat,
                                            int k0, int n0, int K, int ncols) {
  const int n_local = threadIdx.x % kBN;
  const int n = n0 + n_local;
#pragma unroll
  for (int i = 0; i < kBK * kBN / kThreads; ++i) {
    const int k_local = threadIdx.x / kBN + i * (kThreads / kBN);
    const int k = k0 + k_local;
    float v = 0.f;
    if (k < K && n < ncols) v = to_f32(mat[(int64_t)k * ncols + n]);
    s.b[k_local][n_local] = v;
  }
}

// acc[i][j] += sum_k a[k][ty*4+i] * b[k][tx*4+j] over the staged tile.
__device__ __forceinline__ void mma_tile(const TileSmem& s, float acc[4][4],
                                         int tx, int ty) {
#pragma unroll
  for (int k = 0; k < kBK; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(&s.a[k][ty * 4]);
    const float4 b = *reinterpret_cast<const float4*>(&s.b[k][tx * 4]);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

}  // namespace sfh
