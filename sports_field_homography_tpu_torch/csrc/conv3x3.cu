// K2: 3x3, pad-1, stride-1 convolution over NHWC as an implicit GEMM,
// with bias and an optional per-channel BN+ReLU prologue on the input.
//
// Replaces: sports_field_homography_tpu/ops/conv3x3_pallas.py::conv3x3
// (forward with bias, prologue and the training-only stats epilogue, as
// composed by ops/double_conv.py::double_conv_eval and double_conv_train;
// dgrad is this kernel over the cotangent with dgrad_weights), including
// its two-input form (x2/wmat2, conv3x3_pallas.py:157-158, :221-225): the
// concat-free decoder conv conv(cat(a, b)) = conv(a, Wa) + conv(b, Wb).
//
// Two-input form: after the K loop over x's 9*Cin rows the block runs a
// second K loop over x2's 9*Cin2 rows into the same f32 accumulator, with
// the same staging (x2's patch is gathered as it is staged, so the concat
// never exists in memory) and the same shared-memory tiles; the prologue
// applies to x only, the bias is added once and the stats are those of the
// sum.  The TPU's width-pair packing of that form is not carried over.
//
// What bounds it on an H100: arithmetic.  A UNet level-1 conv (64->64 at
// 360x640, batch 8) is 2*M*9*Cin*Cout = 136 GFLOP over ~0.5 GB of bf16
// activations, about 290 FLOP per byte: far above what the CUDA cores
// (67 TFLOP/s f32) can use per byte of HBM bandwidth, so the limit is how
// fast the FMAs issue.  This first version runs on the CUDA cores, not the
// tensor cores.
//
// Design: GEMM rows are output pixels (M = N*H*W), columns are output
// channels, the reduction runs over (ky, kx, cin) = 9*Cin -- the row order
// of the packed (9*Cin, Cout) weight matrix.  The im2col patch is never
// materialised: each A-tile element is gathered straight from x, zero
// outside the image, so the padding costs no memory.  The prologue
// relu((x - mean) * inv + beta) is applied as the element is staged, then
// rounded to the input dtype (as the Pallas kernel casts back before its
// dot); padding cells skip it and stay zero.  Accumulation is f32, bias
// is added in f32, and the output is rounded once to the input dtype.
//
// Stats epilogue (training): per output channel, sum(y) and sum(y*y) of
// the f32 accumulator after the bias and before the rounding, as the
// Pallas kernel takes them (conv3x3_pallas.py:235-243).  The Pallas grid
// carried the sums across its sequential steps in one revisited block;
// here each block reduces its 64 rows through shared memory in a fixed
// order and writes one row of a (gridDim.x, 2*Cout) partial matrix, which
// sum_rows.cu adds up: deterministic, no float atomics.
#include "tile_gemm.cuh"

namespace sfh {
namespace {

// The K loop of one input: acc += patch(x) . wmat over the 9*Cin rows of
// wmat, the prologue applied to x's elements as they are staged.
template <typename T, bool kPrologue>
__device__ __forceinline__ void accumulate_input(
    TileSmem& s, float (&acc)[4][4], const T* __restrict__ x,
    const T* __restrict__ wmat, const float* __restrict__ mean,
    const float* __restrict__ inv, const float* __restrict__ beta, int H,
    int W, int Cin, int Cout, int n0, const int (&rn)[4], const int (&rh)[4],
    const int (&rw)[4], const bool (&rv)[4], int tx, int ty) {
  const int K = 9 * Cin;
  const int ak = threadIdx.x % kBK;
  const int am = threadIdx.x / kBK;
  for (int k0 = 0; k0 < K; k0 += kBK) {
    const int k = k0 + ak;
    const bool kv = k < K;
    const int tap = kv ? k / Cin : 0;
    const int ci = kv ? k - tap * Cin : 0;
    const int dy = tap / 3 - 1;
    const int dx = tap % 3 - 1;
    float pm = 0.f, pi = 1.f, pb = 0.f;
    if (kPrologue && kv) {
      pm = mean[ci];
      pi = inv[ci];
      pb = beta[ci];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ih = rh[i] + dy;
      const int iw = rw[i] + dx;
      float v = 0.f;
      if (kv && rv[i] && ih >= 0 && ih < H && iw >= 0 && iw < W) {
        v = to_f32(x[(((int64_t)rn[i] * H + ih) * W + iw) * Cin + ci]);
        if (kPrologue) v = to_f32(from_f32<T>(fmaxf((v - pm) * pi + pb, 0.f)));
      }
      s.a[ak][am + 16 * i] = v;
    }
    load_b_tile(s, wmat, k0, n0, K, Cout);
    __syncthreads();
    mma_tile(s, acc, tx, ty);
    __syncthreads();
  }
}

template <typename T, bool kPrologue>
__global__ void __launch_bounds__(kThreads)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ wmat,
               const T* __restrict__ x2, const T* __restrict__ wmat2,
               const float* __restrict__ bias, const float* __restrict__ mean,
               const float* __restrict__ inv, const float* __restrict__ beta,
               T* __restrict__ y, float* __restrict__ partial, int N, int H,
               int W, int Cin, int Cin2, int Cout) {
  __shared__ __align__(16) TileSmem s;
  const int M = N * H * W;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  // A-tile staging: this thread loads one reduction column for the four
  // pixel rows am + 16*i.  Their (n, oh, ow) are fixed for both K loops.
  const int am = threadIdx.x / kBK;
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

  accumulate_input<T, kPrologue>(s, acc, x, wmat, mean, inv, beta, H, W, Cin,
                                 Cout, n0, rn, rh, rw, rv, tx, ty);
  if (x2 != nullptr) {   // uniform: the concat-free second input, no prologue
    accumulate_input<T, false>(s, acc, x2, wmat2, nullptr, nullptr, nullptr, H,
                               W, Cin2, Cout, n0, rn, rh, rw, rv, tx, ty);
  }

  float bv[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int co = n0 + tx * 4 + j;
    bv[j] = (bias != nullptr && co < Cout) ? bias[co] : 0.f;
  }
  float csum[4] = {0.f, 0.f, 0.f, 0.f};
  float csq[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = n0 + tx * 4 + j;
      if (co >= Cout) continue;
      const float v = acc[i][j] + bv[j];
      y[(int64_t)m * Cout + co] = from_f32<T>(v);
      csum[j] += v;
      csq[j] += v * v;
    }
  }
  if (partial == nullptr) return;   // uniform across the block

  // stats: 16 row groups (ty) x 64 columns through shared memory (free
  // after the main loop's last barrier), then 128 threads add the 16
  // groups of one column's sum or sum of squares in order
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    s.a[ty][tx * 4 + j] = csum[j];
    s.b[ty][tx * 4 + j] = csq[j];
  }
  __syncthreads();
  if (threadIdx.x < 2 * kBN) {
    const int c = threadIdx.x % kBN;
    const bool sq = threadIdx.x >= kBN;
    const int co = n0 + c;
    if (co < Cout) {
      float t = 0.f;
#pragma unroll
      for (int r = 0; r < kThreads / 16; ++r) t += sq ? s.b[r][c] : s.a[r][c];
      partial[(int64_t)blockIdx.x * 2 * Cout + (sq ? Cout : 0) + co] = t;
    }
  }
}

template <typename T>
void launch(const void* x, const void* wmat, const void* x2,
            const void* wmat2, const float* bias, const float* mean,
            const float* inv, const float* beta, void* y, float* partial,
            int n, int h, int w, int cin, int cin2, int cout,
            cudaStream_t stream) {
  const int64_t m = (int64_t)n * h * w;
  dim3 grid((unsigned)((m + kBM - 1) / kBM), (unsigned)((cout + kBN - 1) / kBN));
  if (mean != nullptr) {
    conv3x3_kernel<T, true><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(wmat),
        static_cast<const T*>(x2), static_cast<const T*>(wmat2), bias, mean,
        inv, beta, static_cast<T*>(y), partial, n, h, w, cin, cin2, cout);
  } else {
    conv3x3_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(wmat),
        static_cast<const T*>(x2), static_cast<const T*>(wmat2), bias, nullptr,
        nullptr, nullptr, static_cast<T*>(y), partial, n, h, w, cin, cin2, cout);
  }
}

}  // namespace
}  // namespace sfh

// dtype: 0 = float32, 1 = bfloat16.  x2 / wmat2 (the second input, with
// cin2 channels, and its (9*cin2, cout) weights) may be null together.
// bias / mean / inv / beta are f32 and may be null (mean, inv and beta
// together; the prologue applies to x only).  partial, when not null, is a
// (ceil(n*h*w / 64), 2*cout) f32 scratch matrix that receives each block's
// [sum(y) | sum(y*y)] rows.  Returns cudaGetLastError().
extern "C" int sfh_conv3x3(const void* x, const void* wmat, const void* x2,
                           const void* wmat2, const float* bias,
                           const float* mean, const float* inv,
                           const float* beta, void* y, float* partial, int n,
                           int h, int w, int cin, int cin2, int cout,
                           int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    sfh::launch<float>(x, wmat, x2, wmat2, bias, mean, inv, beta, y, partial,
                       n, h, w, cin, cin2, cout, st);
  } else if (dtype == 1) {
    sfh::launch<__nv_bfloat16>(x, wmat, x2, wmat2, bias, mean, inv, beta, y,
                               partial, n, h, w, cin, cin2, cout, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
