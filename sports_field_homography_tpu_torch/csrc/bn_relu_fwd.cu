// K7-fwd: the forward half of train-mode BatchNorm + ReLU over an (M, C)
// row-major view of an NHWC activation, in two kernels:
//   stats: per channel, [sum(x) | sum(x*x)] in f32 over the M rows;
//   norm:  y = relu((x - mean) * inv + beta), rounded once to x's dtype.
//
// Replaces: sports_field_homography_tpu/ops/bn_pallas.py::_stats_kernel
// (:109) and ::_norm_relu_kernel (:123), run through _grid_call
// (pallas_call at :181) from _fwd_impl (:213) under bn_relu_train (:192).
// In the port the norm is the BN2+ReLU pass of every DoubleConv (eval and
// train) and the stats are the stem conv's batch statistics.
//
// What bounds it on an H100: bytes.  A few FLOPs per element; at UNet
// level 1 (batch 8, 360x640x64) the norm reads and writes 236 MB each in
// bf16 and the stats read the stem's 472 MB f32 output, about 0.14 ms each
// at the memory's 3.35 TB/s.
//
// Design: each element is read once and written at most once, and no f32
// copy of the activation is made in device memory (the plain chain of
// torch ops writes an f32 tensor per op).  Both kernels move 16 bytes a
// thread (8 bf16 or 4 f32 channels) when C and the pointers allow it, with
// neighbouring threads on neighbouring addresses.  Stats: a block owns up
// to 256 channel groups times a run of rows (ops/reduce.rows_per_block);
// each row lane sums its rows in order, lane 0 adds the lanes in order and
// writes one row of a (chunks, 2*C) partial matrix that sum_rows.cu adds
// up -- no float atomics, so the sums repeat bitwise.  The Pallas kernel
// carried the sums across its sequential grid in one revisited block.
// Norm: the per-channel vectors sit in shared memory; the affine is
// __fsub_rn / __fmul_rn / __fadd_rn in the plain version's order (nvcc
// would contract a*b+c into an FMA), so in f32 the kernel and the plain
// version agree bit for bit.
#include "tile_gemm.cuh"

namespace sfh {
namespace {

constexpr int kBnThreads = 256;

template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float (&out)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = to_f32(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = to_f32(p[i]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* __restrict__ p, const float (&v)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) e[i] = from_f32<T>(v[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = from_f32<T>(v[i]);
  }
}

// Block: gpb channel groups (VEC channels each) x (256 / gpb) row lanes,
// over rows [blockIdx.y * rows_per_block, +rows_per_block).
template <typename T, int VEC>
__global__ void __launch_bounds__(kBnThreads)
bn_relu_stats_kernel(const T* __restrict__ x, float* __restrict__ part, int M,
                     int C, int gpb, int rows_per_block) {
  __shared__ float s1[kBnThreads][VEC];
  __shared__ float s2[kBnThreads][VEC];
  const int groups = C / VEC;
  const int lanes = kBnThreads / gpb;
  const int gl = threadIdx.x % gpb;
  const int lane = threadIdx.x / gpb;
  const int g = blockIdx.x * gpb + gl;
  const int r0 = blockIdx.y * rows_per_block;
  const int r1 = min(r0 + rows_per_block, M);
  float a[VEC], q[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) a[i] = q[i] = 0.f;
  if (lane < lanes && g < groups) {
    for (int r = r0 + lane; r < r1; r += lanes) {
      float v[VEC];
      load_vec<T, VEC>(x + (int64_t)r * C + (int64_t)g * VEC, v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        a[i] += v[i];
        q[i] += v[i] * v[i];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    s1[threadIdx.x][i] = a[i];
    s2[threadIdx.x][i] = q[i];
  }
  __syncthreads();
  if (lane == 0 && g < groups) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      float t1 = 0.f, t2 = 0.f;
      for (int l = 0; l < lanes; ++l) {
        t1 += s1[l * gpb + gl][i];
        t2 += s2[l * gpb + gl][i];
      }
      const int64_t row = (int64_t)blockIdx.y * 2 * C;
      part[row + g * VEC + i] = t1;
      part[row + C + g * VEC + i] = t2;
    }
  }
}

// Grid-stride over the M*C / VEC vectors; VEC divides C, so a vector never
// straddles two rows.  Shared memory: mean | inv | beta, 3*C floats.
template <typename T, int VEC>
__global__ void __launch_bounds__(kBnThreads)
bn_relu_norm_kernel(const T* __restrict__ x, const float* __restrict__ mean,
                    const float* __restrict__ inv, const float* __restrict__ beta,
                    T* __restrict__ y, int64_t nvec, int C) {
  extern __shared__ float vecs[];
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    vecs[c] = mean[c];
    vecs[C + c] = inv[c];
    vecs[2 * C + c] = beta[c];
  }
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < nvec; i += stride) {
    const int64_t e0 = i * VEC;
    const int c0 = (int)(e0 % C);
    float v[VEC];
    load_vec<T, VEC>(x + e0, v);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const int c = c0 + k;
      const float z = __fadd_rn(__fmul_rn(__fsub_rn(v[k], vecs[c]), vecs[C + c]),
                                vecs[2 * C + c]);
      v[k] = z < 0.f ? 0.f : z;      // relu; NaN passes through as in torch
    }
    store_vec<T, VEC>(y + e0, v);
  }
}

template <typename T>
int vec_width(const void* a, const void* b, int c) {
  constexpr int kVec = (int)(16 / sizeof(T));
  const bool aligned = (reinterpret_cast<uintptr_t>(a) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(b) % 16 == 0);
  return (aligned && c % kVec == 0) ? kVec : 1;
}

template <typename T, int VEC>
void launch_stats(const void* x, float* part, int m, int c, int rows_per_block,
                  cudaStream_t stream) {
  const int groups = c / VEC;
  const int gpb = groups < kBnThreads ? groups : kBnThreads;
  dim3 grid((unsigned)((groups + gpb - 1) / gpb),
            (unsigned)((m + rows_per_block - 1) / rows_per_block));
  bn_relu_stats_kernel<T, VEC><<<grid, kBnThreads, 0, stream>>>(
      static_cast<const T*>(x), part, m, c, gpb, rows_per_block);
}

template <typename T, int VEC>
void launch_norm(const void* x, const float* mean, const float* inv,
                 const float* beta, void* y, int m, int c, cudaStream_t stream) {
  const int64_t nvec = (int64_t)m * c / VEC;
  int64_t blocks = (nvec + kBnThreads - 1) / kBnThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;       // 16 blocks per SM, grid-stride
  bn_relu_norm_kernel<T, VEC><<<(unsigned)blocks, kBnThreads, 3 * c * sizeof(float), stream>>>(
      static_cast<const T*>(x), mean, inv, beta, static_cast<T*>(y), nvec, c);
}

template <typename T>
void stats(const void* x, float* part, int m, int c, int rpb, cudaStream_t st) {
  if (vec_width<T>(x, x, c) > 1) {
    launch_stats<T, (int)(16 / sizeof(T))>(x, part, m, c, rpb, st);
  } else {
    launch_stats<T, 1>(x, part, m, c, rpb, st);
  }
}

template <typename T>
void norm(const void* x, const float* mean, const float* inv, const float* beta,
          void* y, int m, int c, cudaStream_t st) {
  if (vec_width<T>(x, y, c) > 1) {
    launch_norm<T, (int)(16 / sizeof(T))>(x, mean, inv, beta, y, m, c, st);
  } else {
    launch_norm<T, 1>(x, mean, inv, beta, y, m, c, st);
  }
}

}  // namespace
}  // namespace sfh

// Stats.  x (m, c) float32 (dtype 0) or bfloat16 (dtype 1); part
// (ceil(m / rows_per_block), 2*c) f32 receives each row chunk's
// [sum | sum of squares], with ceil(m / rows_per_block) <= 65535.  Returns
// cudaGetLastError().
extern "C" int sfh_bn_relu_stats(const void* x, float* part, int m, int c,
                                 int rows_per_block, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    sfh::stats<float>(x, part, m, c, rows_per_block, st);
  } else if (dtype == 1) {
    sfh::stats<__nv_bfloat16>(x, part, m, c, rows_per_block, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Norm.  x, y (m, c) in one dtype; mean, inv, beta (c) f32, with
// 3 * c * 4 bytes <= 48 KB of shared memory.  Returns cudaGetLastError().
extern "C" int sfh_bn_relu_norm(const void* x, const float* mean,
                                const float* inv, const float* beta, void* y,
                                int m, int c, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    sfh::norm<float>(x, mean, inv, beta, y, m, c, st);
  } else if (dtype == 1) {
    sfh::norm<__nv_bfloat16>(x, mean, inv, beta, y, m, c, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
