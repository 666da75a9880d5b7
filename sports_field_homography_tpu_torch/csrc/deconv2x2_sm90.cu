// K3 and K3-bwd on the tensor cores: the k2s2 transposed convolution
// (ConvTranspose2d(cin, cout, 2, 2)) over NHWC in bf16 on Hopper's wgmma,
//     y[n, 2i+p, 2j+q, o] = sum_c x[n, i, j, c] * W[c, p, q, o] + b[o]
//     dx[n, i, j, c]      = sum_{p, q, o} dy[n, 2i+p, 2j+q, o] * W[c, p, q, o]
//     dW[c, p, q, o]      = sum_{n, i, j} x[n, i, j, c] * dy[n, 2i+p, 2j+q, o]
//
// Replaces: sports_field_homography_tpu/ops/deconv_pallas.py::_fwd_call
// (:77, pallas_call at :100) and ::_bwd_call (:118, pallas_call at :157;
// VJP at :220-236).  The route for bf16 with Cin and Cout multiples of 64,
// which every up-conv of the deconv UNet has; f32 and other channel counts
// take deconv2x2.cu (SIMT).  db stays a column sum of dy (sum_rows.cu).
//
// What bounds it on an H100: bytes.  Every input pixel meets every weight
// once, so an input pixel costs 2*Cin*4*Cout FLOPs against Cin + 4*Cout
// elements of traffic: at up4 (128->64, 180x320 -> 360x640, batch 8) the
// forward is 60 GFLOP (0.06 ms of tensor cores) against 118 MB read and
// 236 MB written (0.11 ms of HBM).  The output is twice the input's bytes,
// so the forward's time is its store.
//
// Design.  Forward and dgrad are one K-major GEMM kernel -- rows: input
// pixels, 128 per block, one warpgroup per 64; columns: BN = 64 or 128;
// reduction: 64 channels a step -- that differ only in where a row's A
// operand and its output live (FwdMap, DgradMap):
//   forward: A = x's pixel row, B = the packed weights transposed
//     (4*Cout, Cin); output column (p, q, o) of input pixel (i, j) goes to
//     output pixel (2i+p, 2j+q);
//   dgrad: A = dy's pixel row at (2i+p, 2j+q), the reduction walking the
//     4 taps (p, q) x Cout as K2's walks its 9 (no padding: dy is exactly
//     2H x 2W); B = the packed weights (Cin, 4*Cout); output dx.
// Rows are gathered 16 bytes a thread by cp.async into 128-byte-swizzled
// tiles (igemm_sm90.cuh) in a 3-stage ring: K is only 2..32 steps, and at
// 97 KB of shared memory two blocks share an SM, so one block's stores
// overlap the other's loads.  The epilogue adds the f32 bias, rounds once
// to bf16, stages the block's tile in shared memory and writes it 16 bytes
// a thread: a forward column block of 128 lies in one (p, q), or spans
// q = 0, 1 when Cout = 64, so each pixel's outputs are one 256-byte run.
// The grid walks a row block's column blocks in turn, so the re-reads of
// its A tile hit L2.
//
// wgrad: one warpgroup per 64 x BN tile of dW (64 input channels, BN
// output columns inside one (p, q)), both operands MN-major as in
// wgrad3x3_sm90.cu (x's pixel rows; dy's rows at the tap's output pixel),
// 64 pixels a step in a 4-stage ring.  The pixels are split into 64-aligned
// chunks whose f32 partials sum_rows.cu adds in a fixed order: bitwise
// repeatable, no float atomics (the Pallas kernel accumulated one revisited
// VMEM block over its sequential grid).
//
// Output pixel (2i, 2j) of input pixel m = (n*H + i)*W + j is 4m - 2j, so a
// gathered row costs one modulo, not a divide and a modulo per element.
#include "igemm_sm90.cuh"

namespace sfh {
namespace sm90 {
namespace {

constexpr int kBM = 128;                   // input pixels per GEMM block
constexpr int kThreads = 256;              // two warpgroups
constexpr int kStages = 3;
constexpr int kAhead = kStages - 2;        // K steps loaded ahead
constexpr int kABytes = kBM * kRowBytes;   // 16 KB

template <int BN>
struct Gemm {
  static constexpr int kStageBytes = kABytes + BN * kRowBytes;
  static constexpr int kRing = kStages * kStageBytes;
  static constexpr int kPitch = BN * 2 + 16;   // a staged output row, padded off the banks
  static constexpr int kSmem = (kRing > kBM * kPitch ? kRing : kBM * kPitch) + kSwizzleBytes;
};

// output pixel (2i, 2j) of input pixel m = (n*H + i)*W + j
__device__ __forceinline__ int out_pixel(int m, int W) { return 4 * m - 2 * (m % W); }

// the output pixel offset of tap (p, q) = (pq >> 1, pq & 1)
__device__ __forceinline__ int tap_offset(int pq, int W) { return (pq >> 1) * 2 * W + (pq & 1); }

// Element offsets of the forward's operand rows and outputs.
struct FwdMap {
  int W, Cin, Cout;
  __device__ int64_t a_row(int m) const { return (int64_t)m * Cin; }
  __device__ int64_t a_step(int kk) const { return (int64_t)kk * 64; }
  __device__ int64_t y_row(int m) const { return (int64_t)out_pixel(m, W) * Cout; }
  __device__ int64_t y_col(int j) const {   // column (pq, o) of the (Cin, 4*Cout) pack
    const int pq = j / Cout;
    return (int64_t)tap_offset(pq, W) * Cout + (j - pq * Cout);
  }
  __device__ int bias_col(int j) const { return j % Cout; }
};

// The same for the dgrad: K step kk is tap kk / (Cout/64), channel block
// kk % (Cout/64), as the pack's columns run.
struct DgradMap {
  int W, Cin, Cout;
  __device__ int64_t a_row(int m) const { return (int64_t)out_pixel(m, W) * Cout; }
  __device__ int64_t a_step(int kk) const {
    const int cpb = Cout / 64;
    const int pq = kk / cpb;
    return (int64_t)tap_offset(pq, W) * Cout + (kk - pq * cpb) * 64;
  }
  __device__ int64_t y_row(int m) const { return (int64_t)m * Cin; }
  __device__ int64_t y_col(int j) const { return j; }
  __device__ int bias_col(int j) const { return j; }
};

template <int BN, class Map>
__global__ void __launch_bounds__(kThreads, 2)
deconv2x2_sm90_gemm_kernel(const __nv_bfloat16* __restrict__ a,
                           const __nv_bfloat16* __restrict__ b,
                           const float* __restrict__ bias, __nv_bfloat16* __restrict__ y,
                           Map map, int M, int ncols, int nk) {
  using G = Gemm<BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + kSwizzleBytes - 1) & ~(uint32_t)(kSwizzleBytes - 1);
  uint8_t* const gbase = smem_raw + (base - raw);

  const int tid = threadIdx.x;
  const int ncb = ncols / BN;               // a row block's column blocks run in turn
  const int m0 = (int)(blockIdx.x / ncb) * kBM;
  const int n0 = (int)(blockIdx.x % ncb) * BN;
  const int ldb = nk * 64;

  // this thread stages chunk c of A rows tid/8 + 32*i and of B rows
  // tid/8 + 32*j; the rows' pixels are fixed for the whole K loop
  const int c = tid % kChunks;
  const int r0 = tid / kChunks;
  int64_t arow[4];
  bool av[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + r0 + 32 * i;
    av[i] = m < M;
    arow[i] = av[i] ? map.a_row(m) : 0;
  }
  auto load = [&](int kk) {
    const uint32_t a_s = base + (kk % kStages) * G::kStageBytes;
    const uint32_t b_s = a_s + kABytes;
    const int64_t ak = map.a_step(kk) + c * 8;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      cp_async16(a_s + swz(r0 + 32 * i, c), a + (av[i] ? arow[i] + ak : 0), av[i]);
    }
#pragma unroll
    for (int j = 0; j < BN / 32; ++j) {
      const int r = r0 + 32 * j;
      cp_async16(b_s + swz(r, c), b + (int64_t)(n0 + r) * ldb + kk * 64 + c * 8, true);
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
  const int wg = tid / 128;
  for (int kk = 0; kk < nk; ++kk) {
    cp_async_wait<kAhead - 1>();
    fence_async_smem();
    __syncthreads();
    wgmma_fence();
    const uint32_t a_s = base + (kk % kStages) * G::kStageBytes;
    const uint32_t a_wg = a_s + wg * kSubBytes;
    const uint32_t b_s = a_s + kABytes;
#pragma unroll
    for (int k16 = 0; k16 < 4; ++k16) {
      Wgmma<BN, 0, 0>::run(acc, desc_sw128(a_wg + 32 * k16, 16, kSwizzleBytes),
                           desc_sw128(b_s + 32 * k16, 16, kSwizzleBytes));
    }
    wgmma_commit();
    wgmma_wait<1>();          // step kk-1 is done: its stage may be refilled
    if (kk + kAhead < nk) load(kk + kAhead);
    cp_async_commit();
  }
  wgmma_wait<0>();
  fence_acc(acc);
  cp_async_wait<0>();
  __syncthreads();            // both warpgroups are past the ring: it holds the output tile now

  // acc[4q + e] is row wg*64 + warp*16 + lane/4 + 8*(e/2), column
  // q*8 + (lane%4)*2 + e%2 of the block's tile: + bias, one rounding, to
  // shared memory
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int rl = wg * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int q = 0; q < BN / 8; ++q) {
    const int col = q * 8 + (lane % 4) * 2;
    float b0 = 0.f, b1 = 0.f;
    if (bias != nullptr) {
      const int o = map.bias_col(n0 + col);
      b0 = bias[o];
      b1 = bias[o + 1];
    }
    *reinterpret_cast<__nv_bfloat162*>(gbase + rl * G::kPitch + col * 2) =
        __floats2bfloat162_rn(acc[4 * q] + b0, acc[4 * q + 1] + b1);
    *reinterpret_cast<__nv_bfloat162*>(gbase + (rl + 8) * G::kPitch + col * 2) =
        __floats2bfloat162_rn(acc[4 * q + 2] + b0, acc[4 * q + 3] + b1);
  }
  __syncthreads();
  // each row's BN outputs are contiguous in y: 16 bytes a thread
  constexpr int kRowChunks = BN / 8;
  const int ch = tid % kRowChunks;
  const int64_t ycol = map.y_col(n0 + ch * 8);
  for (int r = tid / kRowChunks; r < kBM; r += kThreads / kRowChunks) {
    const int m = m0 + r;
    if (m < M) {
      *reinterpret_cast<uint4*>(y + map.y_row(m) + ycol) =
          *reinterpret_cast<const uint4*>(gbase + r * G::kPitch + ch * 16);
    }
  }
}

template <int BN, class Map>
cudaError_t launch_gemm(const void* a, const void* b, const float* bias, void* y, Map map,
                        int m, int ncols, int nk, cudaStream_t stream) {
  auto kernel = deconv2x2_sm90_gemm_kernel<BN, Map>;
  const cudaError_t e = allow_smem(kernel, Gemm<BN>::kSmem);
  if (e != cudaSuccess) return e;
  const int64_t blocks = ((int64_t)m + kBM - 1) / kBM * (ncols / BN);
  kernel<<<(unsigned)blocks, kThreads, Gemm<BN>::kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b), bias,
      static_cast<__nv_bfloat16*>(y), map, m, ncols, nk);
  return cudaSuccess;
}

// ---- wgrad ------------------------------------------------------------------

constexpr int kWgThreads = 128;            // one warpgroup
constexpr int kWgStages = 4;
constexpr int kWgAhead = kWgStages - 2;
constexpr int kStepPixels = 64;            // pixels per K step

template <int BN>
struct Wgrad {
  static constexpr int kStageBytes = kSubBytes * (1 + BN / 64);
  static constexpr int kSmem = kWgStages * kStageBytes + kSwizzleBytes;
};

template <int BN>
__global__ void __launch_bounds__(kWgThreads)
deconv2x2_sm90_wgrad_kernel(const __nv_bfloat16* __restrict__ x,
                            const __nv_bfloat16* __restrict__ dy,
                            float* __restrict__ dw_part, int M, int W, int Cin, int Cout,
                            int m_chunk) {
  using C = Wgrad<BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + kSwizzleBytes - 1) & ~(uint32_t)(kSwizzleBytes - 1);

  const int tid = threadIdx.x;
  const int ch = blockIdx.x * 64;            // 64 input channels
  const int n0 = blockIdx.y * BN;            // BN columns (p, q, o) of dW, in one tap
  const int pq = n0 / Cout;
  const int o0 = n0 - pq * Cout;
  const int tap = tap_offset(pq, W);
  const int mb = blockIdx.z * m_chunk;
  const int me = min(mb + m_chunk, M);
  const int nk = (me - mb + kStepPixels - 1) / kStepPixels;

  // this thread stages chunk c of pixel rows tid/8 + 16*i of each step
  const int c = tid % kChunks;
  const int r0 = tid / kChunks;
  auto load = [&](int kk) {
    const uint32_t a_s = base + (kk % kWgStages) * C::kStageBytes;
    const int p0 = mb + kk * kStepPixels;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + 16 * i;
      const int m = p0 + r;
      const bool mv = m < me;
      cp_async16(a_s + swz(r, c), x + (mv ? (int64_t)m * Cin + ch + c * 8 : 0), mv);
      const __nv_bfloat16* gd =
          dy + (mv ? (int64_t)(out_pixel(m, W) + tap) * Cout + o0 + c * 8 : 0);
#pragma unroll
      for (int s = 0; s < BN / 64; ++s) {
        cp_async16(a_s + (1 + s) * kSubBytes + swz(r, c), gd + s * 64, mv);
      }
    }
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

#pragma unroll
  for (int s = 0; s < kWgAhead; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  for (int kk = 0; kk < nk; ++kk) {
    cp_async_wait<kWgAhead - 1>();
    const uint32_t a_s = base + (kk % kWgStages) * C::kStageBytes;
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
    if (kk + kWgAhead < nk) load(kk + kWgAhead);
    cp_async_commit();
  }
  wgmma_wait<0>();
  fence_acc(acc);
  cp_async_wait<0>();

  // acc[4q + e] is row warp*16 + lane/4 + 8*(e/2) (input channel ch + row),
  // column n0 + q*8 + (lane%4)*2 + e%2
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int ncols = 4 * Cout;
  float* out = dw_part + (int64_t)blockIdx.z * Cin * ncols;
  const int64_t row = ch + warp * 16 + lane / 4;
#pragma unroll
  for (int q = 0; q < BN / 8; ++q) {
    const int col = n0 + q * 8 + (lane % 4) * 2;
    *reinterpret_cast<float2*>(out + row * ncols + col) = make_float2(acc[4 * q], acc[4 * q + 1]);
    *reinterpret_cast<float2*>(out + (row + 8) * ncols + col) =
        make_float2(acc[4 * q + 2], acc[4 * q + 3]);
  }
}

template <int BN>
cudaError_t launch_wgrad(const void* x, const void* dy, float* dw_part, int m, int w, int cin,
                         int cout, int m_chunk, int splits, cudaStream_t stream) {
  auto kernel = deconv2x2_sm90_wgrad_kernel<BN>;
  const cudaError_t e = allow_smem(kernel, Wgrad<BN>::kSmem);
  if (e != cudaSuccess) return e;
  dim3 grid((unsigned)(cin / 64), (unsigned)(4 * cout / BN), (unsigned)splits);
  kernel<<<grid, kWgThreads, Wgrad<BN>::kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(dy), dw_part, m,
      w, cin, cout, m_chunk);
  return cudaSuccess;
}

bool shapes_ok(int n, int h, int w, int cin, int cout) {
  return n > 0 && h > 0 && w > 0 && cin > 0 && cin % 64 == 0 && cout > 0 && cout % 64 == 0;
}

}  // namespace
}  // namespace sm90
}  // namespace sfh

// K3, bf16 only.  x (n, h, w, cin); wt (4*cout, cin), the packed weights
// transposed: row (p*2 + q)*cout + o holds W[:, p, q, o]; bias (cout) f32;
// y (n, 2h, 2w, cout).  cin and cout multiples of 64, every pointer 16-byte
// aligned, n*2h*2w < 2^31.  Returns the launch's cudaGetLastError().
extern "C" int sfh_deconv2x2_sm90(const void* x, const void* wt, const float* bias, void* y,
                                  int n, int h, int w, int cin, int cout, void* stream) {
  using namespace sfh::sm90;
  if (!shapes_ok(n, h, w, cin, cout)) return (int)cudaErrorInvalidValue;
  const cudaError_t e = launch_gemm<128>(x, wt, bias, y, FwdMap{w, cin, cout}, n * h * w,
                                         4 * cout, cin / 64, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// K3-bwd, bf16 only: the dgrad and the wgrad, one launch each.  x (n, h, w,
// cin) and dy (n, 2h, 2w, cout); wpack (cin, 4*cout) with column
// (p*2 + q)*cout + o; dx (n, h, w, cin); dw_part (splits, cin, 4*cout) f32,
// split z reducing input pixels [z*m_chunk, (z+1)*m_chunk) (m_chunk a
// multiple of 64, splits * m_chunk >= n*h*w).  cin and cout multiples of
// 64, every pointer 16-byte aligned.  Returns cudaGetLastError().
extern "C" int sfh_deconv2x2_bwd_sm90(const void* x, const void* dy, const void* wpack, void* dx,
                                      float* dw_part, int n, int h, int w, int cin, int cout,
                                      int m_chunk, int splits, void* stream) {
  using namespace sfh::sm90;
  if (!shapes_ok(n, h, w, cin, cout) || m_chunk <= 0 || m_chunk % kStepPixels || splits <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int m = n * h * w;
  const DgradMap map{w, cin, cout};
  cudaError_t e = cin % 128 == 0
                      ? launch_gemm<128>(dy, wpack, nullptr, dx, map, m, cin, 4 * cout / 64, st)
                      : launch_gemm<64>(dy, wpack, nullptr, dx, map, m, cin, 4 * cout / 64, st);
  if (e != cudaSuccess) return (int)e;
  e = cout % 128 == 0 ? launch_wgrad<128>(x, dy, dw_part, m, w, cin, cout, m_chunk, splits, st)
                      : launch_wgrad<64>(x, dy, dw_part, m, w, cin, cout, m_chunk, splits, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
