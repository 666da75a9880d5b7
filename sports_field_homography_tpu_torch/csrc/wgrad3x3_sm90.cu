// K5 on the tensor cores: weight gradient of the 3x3, pad-1 convolution
// over NHWC in bf16 on Hopper's wgmma,
//     dW[(ky, kx, ci), co] = sum_m z[m + tap, ci] * dy[m, co].
//
// Replaces: sports_field_homography_tpu/ops/conv3x3_pallas.py::wgrad3x3
// (pallas_call at :358).  The route for bf16 with Cin and Cout multiples
// of 64 (every UNet conv of the deconv and bilinear models); f32 and other
// channel counts take wgrad3x3.cu (SIMT).  db stays a column sum of dy
// (sum_rows.cu).
//
// What bounds it on an H100: at UNet level 1 (64->64 at 360x640, batch 8)
// the product is 136 GFLOP over 0.47 GB of z and dy, 0.14 ms at either
// peak; but the output is only 576 x 64 while the reduction runs over
// 1.84 M pixels, so all of the parallelism has to come from splitting the
// pixels.  The design pays on-chip traffic: each block reads its tap's z
// rows and its dy rows once per output tile (9 x Cin/64 row tiles, Cout/BN
// column tiles).
//
// The BN+ReLU prologue of the DoubleConv's second conv is not in this
// kernel: applied per staged tile it ran once per tap and output tile, and
// that ALU work cost more than the products (2.0 against 1.07 ms at level
// 1 on the card).  ops/wgrad3x3.py materialises z = relu((x - mean) * inv
// + beta) once with K7-fwd's norm (bn_relu_fwd.cu) and hands it here: one
// extra read of x and write of z, 2 x 236 MB = 0.14 ms of HBM at level 1.
//
// Design: one warpgroup per block computes a 64 x BN tile of dW -- one
// tap, one block of 64 input channels, BN = 64 or 128 output channels --
// over its split of the pixels, 64 pixels per K step.  Both operands are
// staged as pixel rows of 64 channels, exactly as they lie in memory (z
// gathered at the tap's shift by cp.async with zero fill at the padding;
// dy unshifted), so both enter wgmma MN-major (transposed), which bf16
// wgmma takes from shared memory.  A 4-stage ring keeps loads two steps
// ahead.  Each split writes its own (9*Cin, Cout) f32 partial, and
// sum_rows.cu adds the partials in a fixed order: no float atomics, so the
// result repeats bitwise (the Pallas kernel accumulated into one revisited
// VMEM block across its sequential grid).
#include "igemm_sm90.cuh"

namespace sfh {
namespace sm90 {
namespace {

constexpr int kThreads = 128;              // one warpgroup
constexpr int kStages = 4;
constexpr int kAhead = kStages - 2;
constexpr int kStepPixels = 64;            // pixels per K step

template <int BN>
struct Wgrad {
  static constexpr int kStageBytes = kSubBytes * (1 + BN / 64);
  static constexpr int kSmem = kStages * kStageBytes + kSwizzleBytes;
};

template <int BN>
__global__ void __launch_bounds__(kThreads)
wgrad3x3_sm90_kernel(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ dy, float* __restrict__ dw_part,
                     int N, int H, int W, int Cin, int Cout, int m_chunk) {
  using C = Wgrad<BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + kSwizzleBytes - 1) & ~(uint32_t)(kSwizzleBytes - 1);

  const int tid = threadIdx.x;
  const int M = N * H * W;
  const int t = blockIdx.x;                  // row tile: (tap, channel block)
  const int tap = t / (Cin / 64);
  const int ch = (t - tap * (Cin / 64)) * 64;
  const int ddy = tap / 3 - 1, ddx = tap % 3 - 1;
  const int n0 = blockIdx.y * BN;
  const int mb = blockIdx.z * m_chunk;
  const int me = min(mb + m_chunk, M);
  const int nk = (me - mb + kStepPixels - 1) / kStepPixels;

  // this thread stages chunk c of pixel rows tid/8 + 16*i of each step
  const int c = tid % kChunks;
  const int r0 = tid / kChunks;
  auto src_pixel = [&](int m) {              // -1 for padding / past the split
    if (m >= me) return -1;
    const int w = m % W, h = (m / W) % H;
    const int ih = h + ddy, iw = w + ddx;
    return (ih >= 0 && ih < H && iw >= 0 && iw < W) ? m + ddy * W + ddx : -1;
  };
  auto load = [&](int kk) {
    const uint32_t a_s = base + (kk % kStages) * C::kStageBytes;
    const int p0 = mb + kk * kStepPixels;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + 16 * i;
      const int m = p0 + r;
      const int p = src_pixel(m);
      const __nv_bfloat16* g = x + (p >= 0 ? (int64_t)p * Cin + ch + c * 8 : 0);
      cp_async16(a_s + swz(r, c), g, p >= 0);
      const bool mv = m < me;
#pragma unroll
      for (int s = 0; s < BN / 64; ++s) {
        const __nv_bfloat16* gd = dy + (mv ? (int64_t)m * Cout + n0 + s * 64 + c * 8 : 0);
        cp_async16(a_s + (1 + s) * kSubBytes + swz(r, c), gd, mv);
      }
    }
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

#pragma unroll
  for (int s = 0; s < kAhead; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  for (int kk = 0; kk < nk; ++kk) {
    cp_async_wait<kAhead - 1>();
    const uint32_t a_s = base + (kk % kStages) * C::kStageBytes;
    fence_async_smem();
    __syncthreads();
    wgmma_fence();
#pragma unroll
    for (int k16 = 0; k16 < kStepPixels / 16; ++k16) {
      const uint32_t off = k16 * 16 * kRowBytes;
      Wgmma<BN, 1, 1>::run(acc, desc_sw128(a_s + off, kSubBytes, kSwizzleBytes),
                           desc_sw128(a_s + kSubBytes + off, kSubBytes, kSwizzleBytes));
    }
    wgmma_commit();
    wgmma_wait<1>();
    if (kk + kAhead < nk) load(kk + kAhead);
    cp_async_commit();
  }
  wgmma_wait<0>();
  fence_acc(acc);
  cp_async_wait<0>();

  // acc[4q + e] is row warp*16 + lane/4 + 8*(e/2) (input channel ch + row
  // of this tap), column n0 + q*8 + (lane%4)*2 + e%2
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int K = 9 * Cin;
  float* out = dw_part + (int64_t)blockIdx.z * K * Cout;
  const int64_t row = (int64_t)t * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int q = 0; q < BN / 8; ++q) {
    const int col = n0 + q * 8 + (lane % 4) * 2;
    *reinterpret_cast<float2*>(out + row * Cout + col) = make_float2(acc[4 * q], acc[4 * q + 1]);
    *reinterpret_cast<float2*>(out + (row + 8) * Cout + col) =
        make_float2(acc[4 * q + 2], acc[4 * q + 3]);
  }
}

template <int BN>
cudaError_t launch(const void* x, const void* dy, float* dw_part, int n, int h, int w,
                   int cin, int cout, int m_chunk, int splits, cudaStream_t stream) {
  auto kernel = wgrad3x3_sm90_kernel<BN>;
  const cudaError_t e = allow_smem(kernel, Wgrad<BN>::kSmem);
  if (e != cudaSuccess) return e;
  dim3 grid((unsigned)(9 * cin / 64), (unsigned)(cout / BN), (unsigned)splits);
  kernel<<<grid, kThreads, Wgrad<BN>::kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(dy), dw_part,
      n, h, w, cin, cout, m_chunk);
  return cudaSuccess;
}

}  // namespace
}  // namespace sm90
}  // namespace sfh

// bf16 only.  x (n, h, w, cin), the conv's input z, and dy (n, h, w,
// cout); cin and cout multiples of 64, both 16-byte aligned.  dw_part is a
// (splits, 9*cin, cout) f32 matrix: split s reduces pixels [s*m_chunk,
// (s+1)*m_chunk); the caller keeps m_chunk a multiple of 64 and
// splits * m_chunk >= n*h*w.  Returns cudaGetLastError().
extern "C" int sfh_wgrad3x3_sm90(const void* x, const void* dy, float* dw_part, int n,
                                 int h, int w, int cin, int cout, int m_chunk, int splits,
                                 void* stream) {
  using namespace sfh::sm90;
  if (cin <= 0 || cin % 64 || cout <= 0 || cout % 64 || m_chunk <= 0 || m_chunk % kStepPixels)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      cout % 128 == 0 ? launch<128>(x, dy, dw_part, n, h, w, cin, cout, m_chunk, splits, st)
                      : launch<64>(x, dy, dw_part, n, h, w, cin, cout, m_chunk, splits, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
