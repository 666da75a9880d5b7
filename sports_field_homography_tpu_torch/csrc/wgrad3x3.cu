// K5: weight gradient of the 3x3, pad-1 convolution over NHWC,
//     dW[(ky, kx, ci), co] = sum_m patch(z)[m, (ky, kx, ci)] * dy[m, co],
// with an optional BN+ReLU prologue z = relu((x - mean) * inv + beta)
// recomputed from the saved pre-BN input (padding cells stay zero).
//
// Replaces: sports_field_homography_tpu/ops/conv3x3_pallas.py::wgrad3x3
// (pallas_call at :358).  The bias gradient db = sum_m dy[m, :] is a
// column sum of dy (sum_rows.cu).
//
// This is K5's f32 and edge-shape route, on the CUDA cores: float32 (the
// parity runs, TF32 off) and channel counts that are not multiples of 64.
// bf16 with Cin and Cout multiples of 64 runs on the tensor cores in
// wgrad3x3_sm90.cu; ops/wgrad3x3.py chooses by dtype and shape.
//
// What bounds it on an H100: arithmetic, and the depth of the reduction.
// The contraction runs over M = N*H*W pixels -- 1.84 M at UNet level 1
// with batch 8 -- while the output is only 9*Cin x Cout (576 x 64 there):
// a GEMM with few output tiles and a very deep K.  One block per output
// tile would leave most of the 132 SMs idle and walk 115 k reduction
// stages serially.
//
// Design: the same 64x64-tile, 16-deep SIMT GEMM as K2 (tile_gemm.cuh),
// with the roles of the operands swapped: output rows are patch columns
// (tap, ci), output columns are output channels, and the reduction walks
// pixels.  The pixel range is split over gridDim.z; each split writes its
// own (9*Cin, Cout) f32 partial, and sum_rows.cu adds the partials in a
// fixed order (the Pallas kernel accumulated into one revisited VMEM
// block across its sequential grid; on Hopper that would need float
// atomics and would not be deterministic).  The im2col patch is never
// materialised: each A element is gathered from x while it is staged,
// zero outside the image, with the prologue applied as in K2 and rounded
// to the input dtype (as the Pallas kernel casts back before its dot).
#include "tile_gemm.cuh"

namespace sfh {
namespace {

template <typename T, bool kPrologue>
__global__ void __launch_bounds__(kThreads)
wgrad3x3_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                const float* __restrict__ mean, const float* __restrict__ inv,
                const float* __restrict__ beta, float* __restrict__ dw_part,
                int N, int H, int W, int Cin, int Cout, int m_chunk) {
  __shared__ __align__(16) TileSmem s;
  const int M = N * H * W;
  const int K = 9 * Cin;
  const int k0 = blockIdx.x * kBM;              // output rows: patch columns
  const int n0 = blockIdx.y * kBN;              // output columns: channels
  const int mb = blockIdx.z * m_chunk;          // this split's pixel range
  const int me = min(mb + m_chunk, M);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  // A staging: this thread loads patch column kl for the four pixels
  // rl + 4*i of each 16-pixel stage; its (tap, ci) are fixed for the loop.
  const int kl = threadIdx.x % kBM;
  const int rl = threadIdx.x / kBM;
  const int k = k0 + kl;
  const bool kv = k < K;
  const int tap = kv ? k / Cin : 0;
  const int ci = kv ? k - tap * Cin : 0;
  const int ddy = tap / 3 - 1;
  const int ddx = tap % 3 - 1;
  float pm = 0.f, pi = 1.f, pb = 0.f;
  if (kPrologue && kv) {
    pm = mean[ci];
    pi = inv[ci];
    pb = beta[ci];
  }

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
      float v = 0.f;
      if (kv && m < me) {
        const int w = m % W;
        const int t = m / W;
        const int h = t % H;
        const int n = t / H;
        const int ih = h + ddy;
        const int iw = w + ddx;
        if (ih >= 0 && ih < H && iw >= 0 && iw < W) {
          v = to_f32(x[(((int64_t)n * H + ih) * W + iw) * Cin + ci]);
          if (kPrologue) v = to_f32(from_f32<T>(fmaxf((v - pm) * pi + pb, 0.f)));
        }
      }
      s.a[r][kl] = v;
    }
    load_b_tile(s, dy, m0, n0, me, Cout);       // dy rows [m0, m0 + 16)
    __syncthreads();
    mma_tile(s, acc, tx, ty);
    __syncthreads();
  }

  float* out = dw_part + (int64_t)blockIdx.z * K * Cout;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kr = k0 + ty * 4 + i;
    if (kr >= K) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = n0 + tx * 4 + j;
      if (co < Cout) out[(int64_t)kr * Cout + co] = acc[i][j];
    }
  }
}

template <typename T>
void launch(const void* x, const void* dy, const float* mean, const float* inv,
            const float* beta, float* dw_part, int n, int h, int w, int cin,
            int cout, int m_chunk, int splits, cudaStream_t stream) {
  dim3 grid((unsigned)((9 * cin + kBM - 1) / kBM),
            (unsigned)((cout + kBN - 1) / kBN), (unsigned)splits);
  if (mean != nullptr) {
    wgrad3x3_kernel<T, true><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy), mean, inv, beta,
        dw_part, n, h, w, cin, cout, m_chunk);
  } else {
    wgrad3x3_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy), nullptr, nullptr,
        nullptr, dw_part, n, h, w, cin, cout, m_chunk);
  }
}

}  // namespace
}  // namespace sfh

// x (n, h, w, cin) and dy (n, h, w, cout) in one dtype (0 = float32,
// 1 = bfloat16); mean / inv / beta (cin) f32 or all null.  dw_part is a
// (splits, 9*cin, cout) f32 matrix: split z reduces pixels
// [z*m_chunk, (z+1)*m_chunk); the caller keeps m_chunk a multiple of 16
// and splits * m_chunk >= n*h*w.  Returns cudaGetLastError().
extern "C" int sfh_wgrad3x3(const void* x, const void* dy, const float* mean,
                            const float* inv, const float* beta, float* dw_part,
                            int n, int h, int w, int cin, int cout, int m_chunk,
                            int splits, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    sfh::launch<float>(x, dy, mean, inv, beta, dw_part, n, h, w, cin, cout,
                       m_chunk, splits, st);
  } else if (dtype == 1) {
    sfh::launch<__nv_bfloat16>(x, dy, mean, inv, beta, dw_part, n, h, w, cin,
                               cout, m_chunk, splits, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
