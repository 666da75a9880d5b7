// K3: k2s2 transposed convolution (ConvTranspose2d(cin, cout, 2, 2)),
// forward, over NHWC:
//     y[n, 2i+p, 2j+q, o] = sum_c x[n, i, j, c] * W[c, p, q, o] + b[o]
//
// Replaces: sports_field_homography_tpu/ops/deconv_pallas.py::deconv2x2_packed
// with native output: the forward (_fwd_call, pallas_call at :100) and, as
// K3-bwd, the backward (_bwd_call, :118, pallas_call at :157; VJP at
// :220-236) -- see the second half of this file.  The f32 and edge-shape
// route (f32, or channel counts not multiples of 64); bf16 with Cin and
// Cout multiples of 64 -- every up-conv of the deconv UNet -- runs on the
// tensor cores in deconv2x2_sm90.cu.
//
// What bounds it on an H100: at the UNet's up-convs the reduction is
// Cin = 128..1024 deep and the output 4*Cout = 2*Cin wide, so each input
// pixel costs 2*Cin*4*Cout FLOPs against Cin + 4*Cout elements of traffic:
// in f32 on the CUDA cores (67 TFLOP/s), arithmetic-bound.
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

// ---- K3-bwd ----------------------------------------------------------------
//
// dx[n, i, j, c] = sum_{p, q, o} dy[n, 2i+p, 2j+q, o] * W[c, p, q, o]
// dW[c, (p, q, o)] = sum_{n, i, j} x[n, i, j, c] * dy[n, 2i+p, 2j+q, o]
// (db = sum dy per channel is a column sum of dy, sum_rows.cu.)
//
// What bounds it: arithmetic, like the forward (the same 2*M*Cin*4*Cout
// FLOPs twice).  Design: both are the forward's tile GEMM with other
// operands.  dgrad: rows = input pixels, reduction = (p, q, o) = 4*Cout,
// columns = Cin; the A tile gathers dy at the four output pixels of each
// input pixel, against the transposed packed weights (4*Cout, Cin).
// wgrad: rows = Cin, columns = (p, q, o), reduction over input pixels
// split across gridDim.z into f32 partials that sum_rows.cu adds in a
// fixed order (the Pallas kernel accumulated a revisited (2Cin, 2Cout)
// block over its sequential grid; here that would need float atomics).
// Any H and W: dy is exactly (2H, 2W), the caller slices off the UNet's
// skip-alignment pad first.

template <typename T>
__global__ void __launch_bounds__(kThreads)
deconv2x2_dgrad_kernel(const T* __restrict__ dy, const T* __restrict__ wt,
                       T* __restrict__ dx, int N, int H, int W, int Cin,
                       int Cout) {
  __shared__ __align__(16) TileSmem s;
  const int M = N * H * W;
  const int K = 4 * Cout;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int ak = threadIdx.x % kBK;
  const int am = threadIdx.x / kBK;
  const int Ho = 2 * H, Wo = 2 * W;

  int rn[4], rh[4], rw[4];
  bool rv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + am + 16 * i;
    rv[i] = m < M;
    const int mm = rv[i] ? m : 0;
    rw[i] = mm % W;
    const int t = mm / W;
    rh[i] = t % H;
    rn[i] = t / H;
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    const int k = k0 + ak;
    const bool kv = k < K;
    const int pq = kv ? k / Cout : 0;
    const int o = kv ? k - pq * Cout : 0;
    const int p = pq >> 1;
    const int q = pq & 1;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v = 0.f;
      if (kv && rv[i]) {
        v = to_f32(dy[(((int64_t)rn[i] * Ho + 2 * rh[i] + p) * Wo + 2 * rw[i] + q)
                      * Cout + o]);
      }
      s.a[ak][am + 16 * i] = v;
    }
    load_b_tile(s, wt, k0, n0, K, Cin);
    __syncthreads();
    mma_tile(s, acc, tx, ty);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx * 4 + j;
      if (c < Cin) dx[(int64_t)m * Cin + c] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
deconv2x2_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                       float* __restrict__ dw_part, int N, int H, int W,
                       int Cin, int Cout, int m_chunk) {
  __shared__ __align__(16) TileSmem s;
  const int M = N * H * W;
  const int ncols = 4 * Cout;
  const int c0 = blockIdx.x * kBM;              // output rows: Cin
  const int r0 = blockIdx.y * kBN;              // output columns: (p, q, o)
  const int mb = blockIdx.z * m_chunk;
  const int me = min(mb + m_chunk, M);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int Ho = 2 * H, Wo = 2 * W;

  // A staging: channel c0 + cl of pixels rl + 4*i; B staging: column
  // r0 + cl of the same pixels, gathered from dy
  const int cl = threadIdx.x % kBM;
  const int rl = threadIdx.x / kBM;
  const int c = c0 + cl;
  const int rr = r0 + cl;
  const bool rrv = rr < ncols;
  const int pq = rrv ? rr / Cout : 0;
  const int o = rrv ? rr - pq * Cout : 0;
  const int p = pq >> 1;
  const int q = pq & 1;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int m0 = mb; m0 < me; m0 += kBK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rl + 4 * i;
      const int m = m0 + r;
      float va = 0.f, vb = 0.f;
      if (m < me) {
        if (c < Cin) va = to_f32(x[(int64_t)m * Cin + c]);
        if (rrv) {
          const int w = m % W;
          const int t = m / W;
          const int h = t % H;
          const int n = t / H;
          vb = to_f32(dy[(((int64_t)n * Ho + 2 * h + p) * Wo + 2 * w + q) * Cout + o]);
        }
      }
      s.a[r][cl] = va;
      s.b[r][cl] = vb;
    }
    __syncthreads();
    mma_tile(s, acc, tx, ty);
    __syncthreads();
  }

  float* out = dw_part + (int64_t)blockIdx.z * Cin * ncols;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int cr = c0 + ty * 4 + i;
    if (cr >= Cin) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = r0 + tx * 4 + j;
      if (col < ncols) out[(int64_t)cr * ncols + col] = acc[i][j];
    }
  }
}

template <typename T>
void launch_bwd(const void* x, const void* dy, const void* wt, void* dx,
                float* dw_part, int n, int h, int w, int cin, int cout,
                int m_chunk, int splits, cudaStream_t stream) {
  const int64_t m = (int64_t)n * h * w;
  dim3 gd((unsigned)((m + kBM - 1) / kBM), (unsigned)((cin + kBN - 1) / kBN));
  deconv2x2_dgrad_kernel<T><<<gd, kThreads, 0, stream>>>(
      static_cast<const T*>(dy), static_cast<const T*>(wt), static_cast<T*>(dx),
      n, h, w, cin, cout);
  dim3 gw((unsigned)((cin + kBM - 1) / kBM),
          (unsigned)((4 * cout + kBN - 1) / kBN), (unsigned)splits);
  deconv2x2_wgrad_kernel<T><<<gw, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), dw_part, n, h, w,
      cin, cout, m_chunk);
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

// K3-bwd.  x (n, h, w, cin) and dy (n, 2h, 2w, cout) in one dtype
// (0 = float32, 1 = bfloat16); wt (4*cout, cin) = the packed weights
// transposed, in that dtype; dx (n, h, w, cin) in that dtype; dw_part
// (splits, cin, 4*cout) f32, split z reducing input pixels
// [z*m_chunk, (z+1)*m_chunk) (m_chunk a multiple of 16, splits * m_chunk
// >= n*h*w).  Returns cudaGetLastError().
extern "C" int sfh_deconv2x2_bwd(const void* x, const void* dy, const void* wt,
                                 void* dx, float* dw_part, int n, int h, int w,
                                 int cin, int cout, int m_chunk, int splits,
                                 int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    sfh::launch_bwd<float>(x, dy, wt, dx, dw_part, n, h, w, cin, cout, m_chunk,
                           splits, st);
  } else if (dtype == 1) {
    sfh::launch_bwd<__nv_bfloat16>(x, dy, wt, dx, dw_part, n, h, w, cin, cout,
                                   m_chunk, splits, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
