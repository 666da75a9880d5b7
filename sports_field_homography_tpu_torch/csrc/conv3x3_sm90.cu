// K2 on the tensor cores: 3x3, pad-1, stride-1 convolution over NHWC in
// bf16 as an implicit GEMM on Hopper's wgmma, with bias, the optional
// BN+ReLU prologue on x, the optional second input (x2, the concat-free
// decoder conv) and the optional stats epilogue, in one launch.
//
// Replaces: sports_field_homography_tpu/ops/conv3x3_pallas.py::conv3x3
// (pallas_call at :276; the two-input form x2/wmat2 at :157-158,
// :221-225; the stats epilogue at :235-243; dgrad is this kernel over the
// cotangent with dgrad_weights).  The route for bf16 with Cin, Cin2 and
// Cout multiples of 64, which every UNet conv of the deconv and bilinear
// models has; f32 and other channel counts take conv3x3.cu (SIMT).
//
// What bounds it on an H100: at UNet level 1 (64->64 at 360x640, batch 8)
// the conv is 136 GFLOP of bf16 products over 0.47 GB of activations and
// weights: 0.14 ms of tensor-core time at 989 TFLOP/s against 0.14 ms of
// HBM time, so the two bounds meet.  What this design pays instead is
// on-chip traffic: each block reads its 128 patch rows once per tap (9x
// the activation bytes, mostly from L2) and its weight tile once.
//
// Design: GEMM rows are output pixels (M = N*H*W, 128 per block, one
// warpgroup per 64), columns are output channels (BN = 64 or 128 per
// block), the reduction walks (channel block of 64, tap) -- for the second
// input after the first, into the same accumulators.  Each K step stages
// one tap's 128 x 64 patch tile (gathered by cp.async, zero-filled at the
// padding and past M) and the matching BN x 64 slice of the packed K-major
// weights (Cout, 9*Cin) into a 4-stage ring of 128-byte-swizzled tiles;
// loads run two steps ahead of the wgmma, which runs one step behind the
// issue (wgmma.wait_group 1).  The prologue is applied in shared memory
// by the thread that loaded the chunk, after its copy landed and only on
// in-image cells, and rounded to bf16 before the product.  The epilogue
// adds the f32 bias, rounds once to bf16 and, with stats, reduces sum(y)
// and sum(y*y) of the f32 values over the block's rows in a fixed order
// (shuffles, then the 8 warps through shared memory) into one row of a
// (gridDim.x, 2*Cout) partial matrix that sum_rows.cu adds up.
#include "igemm_sm90.cuh"

namespace sfh {
namespace sm90 {
namespace {

constexpr int kBM = 128;                   // pixels per block
constexpr int kThreads = 256;              // two warpgroups
constexpr int kStages = 4;
constexpr int kABytes = kBM * kRowBytes;   // 16 KB
constexpr int kAhead = kStages - 2;        // K steps loaded ahead

template <int BN>
struct Conv {
  static constexpr int kBBytes = BN * kRowBytes;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kSmem = kStages * kStageBytes + kSwizzleBytes;
};

// The BN+ReLU prologue's per-channel constants for the 8 channels of one
// 16-byte chunk, held in registers while a loop stays on one channel block.
struct ChunkPrologue {
  float m[8], s[8], b[8];

  __device__ __forceinline__ void load(const float* __restrict__ mean,
                                       const float* __restrict__ inv,
                                       const float* __restrict__ beta, int ch) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      m[i] = __ldg(mean + ch + i);
      s[i] = __ldg(inv + ch + i);
      b[i] = __ldg(beta + ch + i);
    }
  }

  // relu((v - mean) * inv + beta) on the 8 bf16 values at p, rounded back
  // to bf16 in place (as the Pallas kernel casts back before its dot)
  __device__ __forceinline__ void apply(uint8_t* p) const {
    uint4 v = *reinterpret_cast<const uint4*>(p);
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      h[i] = __floats2bfloat162_rn(fmaxf((f.x - m[2 * i]) * s[2 * i] + b[2 * i], 0.f),
                                   fmaxf((f.y - m[2 * i + 1]) * s[2 * i + 1] + b[2 * i + 1], 0.f));
    }
    *reinterpret_cast<uint4*>(p) = v;
  }
};

struct Input {
  const __nv_bfloat16* x;   // (N, H, W, cin)
  const __nv_bfloat16* w;   // (Cout, 9 * cin), K-major
  int cin;
};

template <int BN, bool kPro>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_sm90_kernel(Input in0, Input in1, const float* __restrict__ bias,
                    const float* __restrict__ mean, const float* __restrict__ inv,
                    const float* __restrict__ beta, __nv_bfloat16* __restrict__ y,
                    float* __restrict__ partial, int N, int H, int W, int Cout) {
  using C = Conv<BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + kSwizzleBytes - 1) & ~(uint32_t)(kSwizzleBytes - 1);
  uint8_t* const gbase = smem_raw + (base - raw);

  const int tid = threadIdx.x;
  const int M = N * H * W;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;
  const int nk0 = 9 * (in0.cin / 64);
  const int nk = nk0 + 9 * (in1.cin / 64);

  // this thread stages chunk c of patch rows tid/8 + 32*i and of weight
  // rows tid/8 + 32*j; the rows' pixels are fixed for the whole K loop
  const int c = tid % kChunks;
  const int r0 = tid / kChunks;
  int pix[4], ph[4], pw[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + r0 + 32 * i;
    pix[i] = m < M ? m : -1;
    const int mm = m < M ? m : 0;
    pw[i] = mm % W;
    ph[i] = (mm / W) % H;
  }

  // K step kk: input, channel block and tap
  auto step = [&](int kk, Input& in, int& cb, int& tap) {
    const bool second = kk >= nk0;
    in = second ? in1 : in0;
    const int k = second ? kk - nk0 : kk;
    cb = k / 9;
    tap = k - 9 * cb;
  };
  auto src_pixel = [&](int i, int tap) {   // -1 for padding / past M
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    const int ih = ph[i] + dy, iw = pw[i] + dx;
    return (pix[i] >= 0 && ih >= 0 && ih < H && iw >= 0 && iw < W)
               ? pix[i] + dy * W + dx : -1;
  };
  auto load = [&](int kk) {
    Input in;
    int cb, tap;
    step(kk, in, cb, tap);
    const uint32_t a_s = base + (kk % kStages) * C::kStageBytes;
    const uint32_t b_s = a_s + kABytes;
    const int ch = cb * 64 + c * 8;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = src_pixel(i, tap);
      const __nv_bfloat16* g = in.x + (p >= 0 ? (int64_t)p * in.cin + ch : 0);
      cp_async16(a_s + swz(r0 + 32 * i, c), g, p >= 0);
    }
#pragma unroll
    for (int j = 0; j < BN / 32; ++j) {
      const int r = r0 + 32 * j;
      const __nv_bfloat16* g = in.w + (int64_t)(n0 + r) * 9 * in.cin + tap * in.cin + ch;
      cp_async16(b_s + swz(r, c), g, true);
    }
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  ChunkPrologue pro;
  int pro_cb = -1;

#pragma unroll
  for (int s = 0; s < kAhead; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  const int wg = tid / 128;
  for (int kk = 0; kk < nk; ++kk) {
    cp_async_wait<kAhead - 1>();
    const uint32_t a_s = base + (kk % kStages) * C::kStageBytes;
    if (kPro && kk < nk0) {   // BN+ReLU on this thread's landed x chunks
      Input in;
      int cb, tap;
      step(kk, in, cb, tap);
      if (cb != pro_cb) {
        pro.load(mean, inv, beta, cb * 64 + c * 8);
        pro_cb = cb;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (src_pixel(i, tap) >= 0) pro.apply(gbase + (a_s - base) + swz(r0 + 32 * i, c));
      }
    }
    fence_async_smem();
    __syncthreads();
    wgmma_fence();
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

  // epilogue: acc[4q + e] is row wg*64 + warp*16 + lane/4 + 8*(e/2), column
  // q*8 + (lane%4)*2 + e%2 of the block's tile
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int row = m0 + wg * 64 + warp * 16 + lane / 4;
  const bool v0 = row < M, v1 = row + 8 < M;
#pragma unroll
  for (int q = 0; q < BN / 8; ++q) {   // acc += bias, then one rounding
    const int col = n0 + q * 8 + (lane % 4) * 2;
    const float b0 = bias != nullptr ? bias[col] : 0.f;
    const float b1 = bias != nullptr ? bias[col + 1] : 0.f;
    acc[4 * q] += b0;
    acc[4 * q + 1] += b1;
    acc[4 * q + 2] += b0;
    acc[4 * q + 3] += b1;
    if (v0) {
      *reinterpret_cast<__nv_bfloat162*>(y + (int64_t)row * Cout + col) =
          __floats2bfloat162_rn(acc[4 * q], acc[4 * q + 1]);
    }
    if (v1) {
      *reinterpret_cast<__nv_bfloat162*>(y + (int64_t)(row + 8) * Cout + col) =
          __floats2bfloat162_rn(acc[4 * q + 2], acc[4 * q + 3]);
    }
  }
  if (partial == nullptr) return;   // uniform across the block

  // stats of the f32 values: the 8 lanes that share lane%4 hold the same
  // columns; add them in a fixed butterfly, then the 8 warps' sums in order
  float csum[BN / 4], csq[BN / 4];
#pragma unroll
  for (int i = 0; i < BN / 4; ++i) {
    const float a = v0 ? acc[4 * (i / 2) + i % 2] : 0.f;
    const float b = v1 ? acc[4 * (i / 2) + 2 + i % 2] : 0.f;
    csum[i] = a + b;
    csq[i] = a * a + b * b;
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      csum[i] += __shfl_xor_sync(0xffffffffu, csum[i], off);
      csq[i] += __shfl_xor_sync(0xffffffffu, csq[i], off);
    }
  }
  __syncthreads();                  // every warp is past its last wgmma read
  float* red = reinterpret_cast<float*>(gbase);   // [8 warps][2][BN]
  const int gw = tid / 32;
  if (lane < 4) {
#pragma unroll
    for (int q = 0; q < BN / 8; ++q) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = q * 8 + lane * 2 + e;
        red[(gw * 2) * BN + col] = csum[2 * q + e];
        red[(gw * 2 + 1) * BN + col] = csq[2 * q + e];
      }
    }
  }
  __syncthreads();
  if (tid < 2 * BN) {
    const int col = tid % BN;
    const int sq = tid / BN;
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) t += red[(w * 2 + sq) * BN + col];
    partial[(int64_t)blockIdx.x * 2 * Cout + sq * Cout + n0 + col] = t;
  }
}

template <int BN, bool kPro>
cudaError_t launch(Input in0, Input in1, const float* bias, const float* mean,
                   const float* inv, const float* beta, void* y, float* partial,
                   int n, int h, int w, int cout, cudaStream_t stream) {
  auto kernel = conv3x3_sm90_kernel<BN, kPro>;
  const cudaError_t e = allow_smem(kernel, Conv<BN>::kSmem);
  if (e != cudaSuccess) return e;
  const int64_t m = (int64_t)n * h * w;
  dim3 grid((unsigned)((m + kBM - 1) / kBM), (unsigned)(cout / BN));
  kernel<<<grid, kThreads, Conv<BN>::kSmem, stream>>>(
      in0, in1, bias, mean, inv, beta, static_cast<__nv_bfloat16*>(y), partial, n, h, w,
      cout);
  return cudaSuccess;
}

}  // namespace
}  // namespace sm90
}  // namespace sfh

// bf16 only.  x (n, h, w, cin) and its K-major weights wt (cout, 9*cin),
// whose column (ky*3 + kx)*cin + ci holds W[ky, kx, ci, co]; x2 / wt2 the
// same for the second input (cin2 channels), null together with cin2 = 0.
// cin, cin2 and cout must be multiples of 64, every pointer 16-byte
// aligned.  bias / mean / inv / beta are f32 and may be null (the prologue
// applies to x only).  partial, when not null, is a (ceil(n*h*w / 128),
// 2*cout) f32 matrix that receives each block's [sum(y) | sum(y*y)] row.
// Returns the launch's cudaGetLastError().
extern "C" int sfh_conv3x3_sm90(const void* x, const void* wt, const void* x2,
                                const void* wt2, const float* bias, const float* mean,
                                const float* inv, const float* beta, void* y,
                                float* partial, int n, int h, int w, int cin, int cin2,
                                int cout, void* stream) {
  using namespace sfh::sm90;
  if (cin <= 0 || cin % 64 || cin2 % 64 || cout <= 0 || cout % 64 || (cin2 > 0) != (x2 != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Input in0{static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wt), cin};
  const Input in1{static_cast<const __nv_bfloat16*>(x2), static_cast<const __nv_bfloat16*>(wt2),
                  cin2};
  const bool pro = mean != nullptr;
  cudaError_t e;
  if (cout % 128 == 0) {
    e = pro ? launch<128, true>(in0, in1, bias, mean, inv, beta, y, partial, n, h, w, cout, st)
            : launch<128, false>(in0, in1, bias, mean, inv, beta, y, partial, n, h, w, cout, st);
  } else {
    e = pro ? launch<64, true>(in0, in1, bias, mean, inv, beta, y, partial, n, h, w, cout, st)
            : launch<64, false>(in0, in1, bias, mean, inv, beta, y, partial, n, h, w, cout, st);
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
