// K3: k2s2 transposed convolution (ConvTranspose2d(cin, cout, 2, 2)),
// forward, over NHWC:
//     y[n, 2i+p, 2j+q, o] = sum_c x[n, i, j, c] * W[c, p, q, o] + b[o]
//
// Replaces: sports_field_homography_tpu/ops/deconv_pallas.py::deconv2x2_packed
// (forward, _fwd_call) with native output.  The backward (_bwd_call) is
// training work and is not ported yet.
//
// What bounds it on an H100: at the UNet's up-convs the reduction is
// Cin = 128..1024 deep and the output 4*Cout = 2*Cin wide, so each input
// pixel costs 2*Cin*4*Cout FLOPs against Cin + 4*Cout elements of traffic:
// arithmetic-bound, on the CUDA cores in this first version.
//
// Design: one GEMM with rows = input pixels (M = N*H*W), reduction = Cin,
// columns = (p, q, o) over the (Cin, 4*Cout) packed weight.  No halo and no
// padding: every input pixel is one GEMM row, so any H and W work (the UNet
// at 640x360 meets odd sizes such as 45x80 -> 22x40).  The epilogue
// scatters each column to its (2i+p, 2j+q) output pixel; for a fixed pixel
// the 64 columns of a tile are contiguous channels of one or two output
// pixels, so the stores stay coalesced.  f32 accumulation and bias, one
// rounding to the input dtype.
#include "tile_gemm.cuh"

namespace sfh {
namespace {

template <typename T>
__global__ void __launch_bounds__(kThreads)
deconv2x2_kernel(const T* __restrict__ x, const T* __restrict__ wpack,
                 const float* __restrict__ bias, T* __restrict__ y, int N,
                 int H, int W, int Cin, int Cout) {
  __shared__ __align__(16) TileSmem s;
  const int M = N * H * W;
  const int K = Cin;
  const int ncols = 4 * Cout;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int ak = threadIdx.x % kBK;
  const int am = threadIdx.x / kBK;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    const int k = k0 + ak;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + am + 16 * i;
      float v = 0.f;
      if (k < K && m < M) v = to_f32(x[(int64_t)m * Cin + k]);
      s.a[ak][am + 16 * i] = v;
    }
    load_b_tile(s, wpack, k0, n0, K, ncols);
    __syncthreads();
    mma_tile(s, acc, tx, ty);
    __syncthreads();
  }

  const int Ho = 2 * H, Wo = 2 * W;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
    const int jx = m % W;
    const int t = m / W;
    const int ix = t % H;
    const int nb = t / H;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx * 4 + j;
      if (c >= ncols) continue;
      const int pq = c / Cout;
      const int o = c - pq * Cout;
      const int oh = 2 * ix + (pq >> 1);
      const int ow = 2 * jx + (pq & 1);
      y[(((int64_t)nb * Ho + oh) * Wo + ow) * Cout + o] = from_f32<T>(acc[i][j] + bias[o]);
    }
  }
}

template <typename T>
void launch(const void* x, const void* wpack, const float* bias, void* y,
            int n, int h, int w, int cin, int cout, cudaStream_t stream) {
  const int64_t m = (int64_t)n * h * w;
  dim3 grid((unsigned)((m + kBM - 1) / kBM), (unsigned)((4 * cout + kBN - 1) / kBN));
  deconv2x2_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wpack), bias,
      static_cast<T*>(y), n, h, w, cin, cout);
}

}  // namespace
}  // namespace sfh

// x (n, h, w, cin); wpack (cin, 4*cout) with column (p*2 + q)*cout + o;
// bias (cout) f32; y (n, 2h, 2w, cout).  dtype: 0 = float32, 1 = bfloat16.
// Returns cudaGetLastError().
extern "C" int sfh_deconv2x2(const void* x, const void* wpack, const float* bias,
                             void* y, int n, int h, int w, int cin, int cout,
                             int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    sfh::launch<float>(x, wpack, bias, y, n, h, w, cin, cout, st);
  } else if (dtype == 1) {
    sfh::launch<__nv_bfloat16>(x, wpack, bias, y, n, h, w, cin, cout, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
