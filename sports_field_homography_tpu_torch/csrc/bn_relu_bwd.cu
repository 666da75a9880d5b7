// K7-bwd: backward of out = relu(bn_train(y)) over an (M, C) row-major
// view of an NHWC activation, in two passes:
//   1. per channel, s1 = sum(dy') and s2 = sum(dy' * xhat), where
//      xhat = (y - mean) * rstd and dy' = dy * [xhat * gamma + beta > 0];
//   2. dx = gamma * rstd * (dy' - s1 / M - xhat * s2 / M), in y's dtype.
//
// Replaces: sports_field_homography_tpu/ops/bn_pallas.py::_bwd_reduce_kernel
// (:129) and ::_dx_kernel (:150), run through _grid_call (pallas_call at
// :181).  Both run inside every fused train-mode DoubleConv backward
// (ops/double_conv.py::_bn_relu_bwd, :112-169).
//
// What bounds it on an H100: bytes.  Pass 1 reads y and dy once, pass 2
// reads them again and writes dx; a few FLOPs per element.  At UNet
// level 1 (batch 8, 360x640x64, bf16) that is 3 x 236 MB over 3.35 TB/s,
// about 0.2 ms at the memory's peak.
//
// Design: the ReLU mask is recomputed from y (no saved output), in f32,
// with every step rounded on its own (__fmul_rn / __fadd_rn / __fsub_rn,
// which nvcc never contracts into an FMA) in the plain version's order, so
// the kernel and its plain twin agree on every mask bit.  Pass 1: block =
// 32 channels x 8 row lanes over a chunk of rows; each lane sums its rows
// in order, lane 0 adds the 8 lanes in order and writes one row of a
// (chunks, 2*C) partial matrix [s1 | s2] that sum_rows.cu adds up.  The
// Pallas kernel carried the sums across a sequential grid in a revisited
// block; here no float atomics are used, so the sums are deterministic.
// Pass 2: one thread per element.
#include "tile_gemm.cuh"

namespace sfh {
namespace {

constexpr int kCols = 32;
constexpr int kLanes = 8;

__device__ __forceinline__ float xhat_of(float y, float mean, float rstd) {
  return __fmul_rn(__fsub_rn(y, mean), rstd);
}

__device__ __forceinline__ bool relu_on(float xh, float gamma, float beta) {
  return __fadd_rn(__fmul_rn(xh, gamma), beta) > 0.f;
}

template <typename T>
__global__ void __launch_bounds__(kCols * kLanes)
bn_relu_bwd_reduce_kernel(const T* __restrict__ y, const T* __restrict__ g,
                          const float* __restrict__ mean,
                          const float* __restrict__ rstd,
                          const float* __restrict__ gamma,
                          const float* __restrict__ beta,
                          float* __restrict__ part, int M, int C,
                          int rows_per_block) {
  __shared__ float p1[kLanes][kCols];
  __shared__ float p2[kLanes][kCols];
  const int cl = threadIdx.x % kCols;
  const int lane = threadIdx.x / kCols;
  const int c = blockIdx.x * kCols + cl;
  const int r0 = blockIdx.y * rows_per_block;
  const int r1 = min(r0 + rows_per_block, M);
  float s1 = 0.f, s2 = 0.f;
  if (c < C) {
    const float mu = mean[c], rs = rstd[c], ga = gamma[c], be = beta[c];
    for (int r = r0 + lane; r < r1; r += kLanes) {
      const int64_t idx = (int64_t)r * C + c;
      const float xh = xhat_of(to_f32(y[idx]), mu, rs);
      const float d = relu_on(xh, ga, be) ? to_f32(g[idx]) : 0.f;
      s1 += d;
      s2 += d * xh;
    }
  }
  p1[lane][cl] = s1;
  p2[lane][cl] = s2;
  __syncthreads();
  if (lane == 0 && c < C) {
    float t1 = 0.f, t2 = 0.f;
#pragma unroll
    for (int l = 0; l < kLanes; ++l) {
      t1 += p1[l][cl];
      t2 += p2[l][cl];
    }
    part[(int64_t)blockIdx.y * 2 * C + c] = t1;
    part[(int64_t)blockIdx.y * 2 * C + C + c] = t2;
  }
}

template <typename T>
__global__ void bn_relu_bwd_dx_kernel(const T* __restrict__ y,
                                      const T* __restrict__ g,
                                      const float* __restrict__ mean,
                                      const float* __restrict__ rstd,
                                      const float* __restrict__ gamma,
                                      const float* __restrict__ beta,
                                      const float* __restrict__ c1,
                                      const float* __restrict__ m1,
                                      const float* __restrict__ m2,
                                      T* __restrict__ dx, int64_t total, int C) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int c = (int)(idx % C);
  const float xh = xhat_of(to_f32(y[idx]), mean[c], rstd[c]);
  const float d = relu_on(xh, gamma[c], beta[c]) ? to_f32(g[idx]) : 0.f;
  dx[idx] = from_f32<T>(c1[c] * (d - m1[c] - xh * m2[c]));
}

template <typename T>
void launch_reduce(const void* y, const void* g, const float* mean,
                   const float* rstd, const float* gamma, const float* beta,
                   float* part, int m, int c, int rows_per_block,
                   cudaStream_t stream) {
  dim3 grid((unsigned)((c + kCols - 1) / kCols),
            (unsigned)((m + rows_per_block - 1) / rows_per_block));
  bn_relu_bwd_reduce_kernel<T><<<grid, kCols * kLanes, 0, stream>>>(
      static_cast<const T*>(y), static_cast<const T*>(g), mean, rstd, gamma,
      beta, part, m, c, rows_per_block);
}

template <typename T>
void launch_dx(const void* y, const void* g, const float* mean,
               const float* rstd, const float* gamma, const float* beta,
               const float* c1, const float* m1, const float* m2, void* dx,
               int m, int c, cudaStream_t stream) {
  const int64_t total = (int64_t)m * c;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  bn_relu_bwd_dx_kernel<T><<<blocks, threads, 0, stream>>>(
      static_cast<const T*>(y), static_cast<const T*>(g), mean, rstd, gamma,
      beta, c1, m1, m2, static_cast<T*>(dx), total, c);
}

}  // namespace
}  // namespace sfh

// Pass 1.  y, g (m, c) in one dtype (0 = float32, 1 = bfloat16); mean,
// rstd, gamma, beta (c) f32; part (ceil(m / rows_per_block), 2*c) f32,
// with ceil(m / rows_per_block) <= 65535.  Returns cudaGetLastError().
extern "C" int sfh_bn_relu_bwd_reduce(const void* y, const void* g,
                                      const float* mean, const float* rstd,
                                      const float* gamma, const float* beta,
                                      float* part, int m, int c,
                                      int rows_per_block, int dtype,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    sfh::launch_reduce<float>(y, g, mean, rstd, gamma, beta, part, m, c,
                              rows_per_block, st);
  } else if (dtype == 1) {
    sfh::launch_reduce<__nv_bfloat16>(y, g, mean, rstd, gamma, beta, part, m,
                                      c, rows_per_block, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Pass 2.  c1 = gamma * rstd, m1 = s1 / M, m2 = s2 / M (c) f32; dx (m, c)
// in y's dtype.  Returns cudaGetLastError().
extern "C" int sfh_bn_relu_bwd_dx(const void* y, const void* g,
                                  const float* mean, const float* rstd,
                                  const float* gamma, const float* beta,
                                  const float* c1, const float* m1,
                                  const float* m2, void* dx, int m, int c,
                                  int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    sfh::launch_dx<float>(y, g, mean, rstd, gamma, beta, c1, m1, m2, dx, m, c,
                          st);
  } else if (dtype == 1) {
    sfh::launch_dx<__nv_bfloat16>(y, g, mean, rstd, gamma, beta, c1, m1, m2,
                                  dx, m, c, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
