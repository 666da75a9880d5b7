// Deterministic column sums of a row-major (R, C) matrix: the second pass
// of every cross-block reduction in the training kernels.
//
// Replaces nothing by itself.  The TPU kernels (conv3x3_pallas.py:238-243
// and :331-340, bn_pallas.py:107-118, deconv_pallas.py:137-147) carry their
// sums across a sequential grid in one revisited output block.  On Hopper
// the blocks of a kernel run in parallel and in no fixed order, so each
// block of K2+stats, K5, K7-fwd's stats and K3-bwd writes its partial sums
// to its own row of a scratch matrix, and this kernel adds the rows up in a fixed
// order: no float atomics, so two runs on the same input are bitwise
// equal.
//
// What bounds it on an H100: bytes.  One read of the partials (or of the
// cotangent itself, for a bias gradient) and a write of a far smaller
// matrix; no arithmetic to speak of.
//
// Design: block = 32 columns x 8 row lanes.  Lane l adds rows l, l+8, ...
// of its block's row chunk; lane 0 then adds the 8 lane sums in order.
// Each block writes one row of an output matrix of ceil(R / rows_per_block)
// rows; the wrapper repeats the pass until one row is left.  Consecutive
// threads read consecutive columns, so each warp reads 32 adjacent values
// of a row.
#include "tile_gemm.cuh"

namespace sfh {
namespace {

constexpr int kSumCols = 32;
constexpr int kSumLanes = 8;

template <typename T>
__global__ void __launch_bounds__(kSumCols * kSumLanes)
sum_rows_kernel(const T* __restrict__ in, float* __restrict__ out, int rows,
                int cols, int rows_per_block) {
  __shared__ float part[kSumLanes][kSumCols];
  const int cl = threadIdx.x % kSumCols;
  const int lane = threadIdx.x / kSumCols;
  const int64_t col = (int64_t)blockIdx.x * kSumCols + cl;
  const int r0 = blockIdx.y * rows_per_block;
  const int r1 = min(r0 + rows_per_block, rows);
  float s = 0.f;
  if (col < cols) {
    for (int r = r0 + lane; r < r1; r += kSumLanes) {
      s += to_f32(in[(int64_t)r * cols + col]);
    }
  }
  part[lane][cl] = s;
  __syncthreads();
  if (lane == 0 && col < cols) {
    float t = 0.f;
#pragma unroll
    for (int l = 0; l < kSumLanes; ++l) t += part[l][cl];
    out[(int64_t)blockIdx.y * cols + col] = t;
  }
}

}  // namespace
}  // namespace sfh

// in (rows, cols) row-major, float32 (dtype 0) or bfloat16 (dtype 1);
// out (ceil(rows / rows_per_block), cols) float32.  The caller keeps
// ceil(rows / rows_per_block) <= 65535.  Returns cudaGetLastError().
extern "C" int sfh_sum_rows(const void* in, float* out, int rows, int cols,
                            int rows_per_block, int dtype, void* stream) {
  const int chunks = (rows + rows_per_block - 1) / rows_per_block;
  dim3 grid((unsigned)((cols + sfh::kSumCols - 1) / sfh::kSumCols),
            (unsigned)chunks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = sfh::kSumCols * sfh::kSumLanes;
  if (dtype == 0) {
    sfh::sum_rows_kernel<float><<<grid, threads, 0, st>>>(
        static_cast<const float*>(in), out, rows, cols, rows_per_block);
  } else if (dtype == 1) {
    sfh::sum_rows_kernel<__nv_bfloat16><<<grid, threads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(in), out, rows, cols, rows_per_block);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
