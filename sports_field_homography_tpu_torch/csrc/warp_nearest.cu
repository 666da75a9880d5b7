// K1: nearest homography warp of the court label template.
//
// Replaces: sports_field_homography_tpu/ops/warp_pallas.py::
// warp_nearest_interval_pallas (and its XLA twin
// ops/interval_warp.py::warp_nearest_interval), on the full output grid or
// on the sample_hw subgrid that the consistency score uses.
//
// What bounds it on an H100: bytes, the f32 output written once (7.4 MB for
// a batch of 8 at 360x640) plus the template read once; the arithmetic (a
// 3x3 transform, one reciprocal) is ~30 f32 operations a sample.  A
// 1280x720 uint8 template is 0.9 MB and stays in the 50 MB L2, so the
// scattered one-byte label reads hit cache.
//
// Design: a 3-D grid of (column tiles, output rows, images), so a block
// knows its row and image without dividing.  Each thread computes kCols
// adjacent columns of one row and stores them as one 16-byte float4 where
// Wo is a multiple of kCols and the output 16-byte aligned (every main-path
// grid), else one float at a time with the ragged tail masked.  theta and
// the 256-entry value table sit in shared memory, loaded once a block; the
// row's terms (the sampled row, its grid y and theta's three y products)
// are computed once a thread.  The TPU kernel encoded the template as
// per-row intervals and fetched rows with a one-hot matmul because TPU
// gathers are slow; here a thread reads the label through the read-only
// path.  The grid arithmetic must reproduce the plain version (and the JAX
// reference) bit for bit, or a sample on a pixel boundary rounds the other
// way and takes a different label.  So every step uses the round-to-nearest
// intrinsics, which nvcc never contracts into an FMA, in the reference's
// order: normalized grid -> transform_points with kornia's eps ->
// unnormalize (align_corners=False) -> round half to even (rintf).
// Hoisting a product keeps its rounding; the sums keep their order,
// (th0*gx + th1*gy) + th2.  The sample's value is then looked up in a
// per-label f32 table that the host fills with what JAX's interval table
// gives each label (its code round(f32(label / classes) / step) times
// step), so a template that skips a label gets the reference's value, not
// label * step.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 4;          // adjacent output columns a thread computes
constexpr int kMaxThreads = 256;
constexpr int kLabels = 256;      // uint8 labels

template <int N>
__device__ __forceinline__ void store_row(float* __restrict__ p, const float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int j = 0; j < N; j += 4)
      *reinterpret_cast<float4*>(p + j) = make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) p[j] = v[j];
  }
}

__global__ void __launch_bounds__(kMaxThreads)
warp_nearest_kernel(const uint8_t* __restrict__ tmpl, int ht, int wt,
                    const float* __restrict__ theta, int ho, int wo, int full_h,
                    int full_w, int sampled, float x_step, float y_step,
                    float x_ratio, float y_ratio, const float* __restrict__ values,
                    float* __restrict__ out, int vec) {
  __shared__ float th[9];
  __shared__ float table[kLabels];
  const int r = blockIdx.y;
  const int b = blockIdx.z;
  for (int i = threadIdx.x; i < kLabels; i += blockDim.x) table[i] = values[i];
  if (threadIdx.x < 9) th[threadIdx.x] = theta[b * 9 + threadIdx.x];
  __syncthreads();
  const int c0 = (blockIdx.x * blockDim.x + threadIdx.x) * kCols;
  if (c0 >= wo) return;

  // grid index on the full out_hw grid: nearest-resize source indices
  // floor(i * full / sub) when sampling a subgrid
  float fy = (float)r;
  if (sampled) fy = fminf(floorf(__fmul_rn(fy, y_ratio)), (float)(full_h - 1));
  const float gy = __fsub_rn(__fmul_rn(fy, y_step), 1.0f);
  const float xy = __fmul_rn(th[1], gy);
  const float yy = __fmul_rn(th[4], gy);
  const float zy = __fmul_rn(th[7], gy);
  const float eps = 1e-8f;
  float v[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    float fx = (float)(c0 + j);
    if (sampled) fx = fminf(floorf(__fmul_rn(fx, x_ratio)), (float)(full_w - 1));
    const float gx = __fsub_rn(__fmul_rn(fx, x_step), 1.0f);
    const float px = __fadd_rn(__fadd_rn(__fmul_rn(th[0], gx), xy), th[2]);
    const float py = __fadd_rn(__fadd_rn(__fmul_rn(th[3], gx), yy), th[5]);
    const float pz = __fadd_rn(__fadd_rn(__fmul_rn(th[6], gx), zy), th[8]);
    const float scale = fabsf(pz) > eps ? __frcp_rn(__fadd_rn(pz, eps)) : 1.0f;
    const float sx = __fmul_rn(px, scale);
    const float sy = __fmul_rn(py, scale);
    const float u = __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(sx, 1.0f), (float)wt), 1.0f), 0.5f);
    const float w = __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(sy, 1.0f), (float)ht), 1.0f), 0.5f);
    const float iu = rintf(u);
    const float iv = rintf(w);
    v[j] = 0.f;
    if (iu >= 0.f && iu < (float)wt && iv >= 0.f && iv < (float)ht) {
      v[j] = table[__ldg(tmpl + (int64_t)iv * wt + (int64_t)iu)];
    }
  }
  float* row = out + ((int64_t)b * ho + r) * wo + c0;
  if (vec) {
    store_row<kCols>(row, v);
  } else {
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      if (c0 + j < wo) row[j] = v[j];
  }
}

}  // namespace

// tmpl (ht, wt) uint8 labels; theta (batch, 3, 3) f32; out (batch, ho, wo)
// f32; values (256,) f32, the value of each label.  With sampled != 0,
// (ho, wo) is the sample grid and (full_h, full_w) the grid it samples;
// otherwise full_* equal ho, wo.  x_step/y_step are f32(2 / (full - 1)),
// x_ratio/y_ratio f32(full / sub).  vec != 0 takes the vector stores, and
// needs wo % 4 == 0 and out 16-byte aligned; ho and batch are at most
// 65535.  Returns cudaGetLastError(), or cudaErrorInvalidValue for
// arguments the kernel does not take.
extern "C" int sfh_warp_nearest(const uint8_t* tmpl, int ht, int wt,
                                const float* theta, int batch, int ho, int wo,
                                int full_h, int full_w, int sampled,
                                float x_step, float y_step, float x_ratio,
                                float y_ratio, const float* values, float* out,
                                int vec, void* stream) {
  const int align = (int)sizeof(float) * (kCols < 4 ? kCols : 4);
  if (ho > 65535 || batch > 65535 ||
      (vec && (wo % kCols != 0 || reinterpret_cast<uintptr_t>(out) % align != 0))) {
    return (int)cudaErrorInvalidValue;
  }
  // threads a row needs, spread evenly over as few blocks as hold them
  const int per_row = (wo + kCols - 1) / kCols;
  const int tiles = (per_row + kMaxThreads - 1) / kMaxThreads;
  const int threads = ((per_row + tiles - 1) / tiles + 31) / 32 * 32;
  const dim3 grid((unsigned)tiles, (unsigned)ho, (unsigned)batch);
  warp_nearest_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      tmpl, ht, wt, theta, ho, wo, full_h, full_w, sampled, x_step, y_step,
      x_ratio, y_ratio, values, out, vec);
  return (int)cudaGetLastError();
}
