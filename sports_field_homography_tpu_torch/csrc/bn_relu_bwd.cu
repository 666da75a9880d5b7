// K7-bwd: backward of out = relu(bn_train(y)) over an (M, C) row-major
// view of an NHWC activation, in two passes:
//   1. per channel, s1 = sum(dy') and s2 = sum(dy' * xhat), where
//      xhat = (y - mean) * rstd and dy' = dy * [xhat * gamma + beta > 0];
//   2. dx = gamma * rstd * (dy' - s1 / M - xhat * s2 / M), in y's dtype.
//
// Replaces: sports_field_homography_tpu/ops/bn_pallas.py::_bwd_reduce_kernel
// (:129) and ::_dx_kernel (:150), run through _grid_call (pallas_call at
// :181).  Both run inside every fused train-mode DoubleConv backward
// (ops/double_conv.py::_bn_relu_bwd, :112-169).
//
// What bounds it on an H100: bytes.  The sums must be complete before any
// dx, and y and dy do not fit on chip, so two passes are forced: pass 1
// reads y and dy, pass 2 reads them again and writes dx; a few FLOPs per
// element.  At UNet level 1 (batch 8, 360x640x64, bf16) that is 5 x 236 MB,
// 0.35 ms at the memory's 3.35 TB/s.
//
// Design: three launches from one call, with no per-element division.
// Both passes share one schedule: a block is gpb channel groups x (256 /
// gpb) row lanes over a contiguous chunk of rows (ops/bn_relu_bwd.
// row_schedule: a few blocks per SM, at most 4096 rows summed in sequence
// by a thread).  A thread owns one channel group -- 8 bf16 or 4 f32
// channels, one 16-byte load of y and of dy a row, where C and the
// pointers allow it (the vector route), else one channel (the scalar
// route) -- keeps that group's per-channel vectors in registers and walks
// its rows kUnroll at a time, so each thread has several loads in flight.
// Pass 1: each lane sums its rows in order, lane 0 adds the lanes in order
// and writes one row of a (blocks, 2*C) partial matrix [s1 | s2]; the
// finish kernel adds those rows in a fixed order (32 lanes a column, then
// the lanes in order).  No float atomics: two runs are bitwise equal.  The
// Pallas kernel carried the sums across a sequential grid in a revisited
// block.  Pass 2: each thread makes its group's gamma * rstd, s1 / M and
// s2 / M (IEEE division) once, then streams dx out 16 bytes a row; it takes
// the chunks last to first, so it starts on the rows pass 1 read last,
// which may still be in L2.  The ReLU mask is recomputed from y (no saved
// output), in f32, with every step rounded on its own (__fmul_rn /
// __fadd_rn / __fsub_rn, which nvcc never contracts into an FMA) in the
// plain version's order, so the kernel and its plain twin agree on every
// mask bit.
//
// Data parallel (sync BatchNorm across ranks): the same kernels behind two
// more entries, sfh_bn_relu_bwd_sums (pass 1 and the finish) and
// sfh_bn_relu_bwd_dx (pass 2, dividing by the rows of every rank), so the
// caller can all-reduce the 2*C sums between them.  The one-call entry
// stays the one-rank path.
#include "tile_gemm.cuh"

namespace sfh {
namespace {

constexpr int kThreads = 256;       // a block of either pass
constexpr int kUnroll = 8;          // rows a thread has in flight
constexpr int kFinishLanes = 32;    // row lanes a column of the final sum
constexpr bool kDxReverse = true;   // pass 2 takes the chunks last to first

__device__ __forceinline__ float xhat_of(float y, float mean, float rstd) {
  return __fmul_rn(__fsub_rn(y, mean), rstd);
}

__device__ __forceinline__ bool relu_on(float xh, float gamma, float beta) {
  return __fadd_rn(__fmul_rn(xh, gamma), beta) > 0.f;
}

// A thread's place in the schedule: channel group grp (channels grp*VEC..)
// of row lane `lane` of `lanes`, over rows [r0, r1) of the block's chunk;
// n is the number of rows the thread walks.
struct Place {
  int grp, lane, lanes, r0, n;
  bool active;
};

template <int VEC>
__device__ __forceinline__ Place place(int M, int C, int gpb, int chunk, int blk) {
  Place p;
  const int gl = threadIdx.x % gpb;
  p.lane = threadIdx.x / gpb;
  p.lanes = kThreads / gpb;
  p.grp = blockIdx.y * gpb + gl;
  p.r0 = blk * chunk;
  const int r1 = (M - p.r0 < chunk) ? M : p.r0 + chunk;
  const int rows = r1 - p.r0 - p.lane;       // rows from the lane's first on
  p.active = p.lane < p.lanes && p.grp < C / VEC;
  p.n = (p.active && rows > 0) ? (rows + p.lanes - 1) / p.lanes : 0;
  return p;
}

template <int VEC>
__device__ __forceinline__ void load_channels(const float* __restrict__ v, int c0,
                                              float (&out)[VEC]) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) out[i] = v[c0 + i];
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
bn_relu_bwd_sums_kernel(const T* __restrict__ y, const T* __restrict__ g,
                        const float* __restrict__ mean, const float* __restrict__ rstd,
                        const float* __restrict__ gamma, const float* __restrict__ beta,
                        float* __restrict__ part, int M, int C, int gpb, int chunk) {
  __shared__ float p1[kThreads][VEC];
  __shared__ float p2[kThreads][VEC];
  const Place p = place<VEC>(M, C, gpb, chunk, blockIdx.x);
  const int c0 = p.grp * VEC;
  float s1[VEC], s2[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) s1[i] = s2[i] = 0.f;
  if (p.n > 0) {
    float mu[VEC], rs[VEC], ga[VEC], be[VEC];
    load_channels<VEC>(mean, c0, mu);
    load_channels<VEC>(rstd, c0, rs);
    load_channels<VEC>(gamma, c0, ga);
    load_channels<VEC>(beta, c0, be);
    const int64_t step = (int64_t)p.lanes * C;
    const int64_t off = (int64_t)(p.r0 + p.lane) * C + c0;
    const T* py = y + off;
    const T* pg = g + off;
    auto add = [&](const float (&yv)[VEC], const float (&gv)[VEC]) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float xh = xhat_of(yv[i], mu[i], rs[i]);
        const float d = relu_on(xh, ga[i], be[i]) ? gv[i] : 0.f;
        s1[i] += d;
        s2[i] += d * xh;
      }
    };
    int k = 0;
    for (; k + kUnroll <= p.n; k += kUnroll) {
      float yv[kUnroll][VEC], gv[kUnroll][VEC];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        load_vec<T, VEC>(py + u * step, yv[u]);
        load_vec<T, VEC>(pg + u * step, gv[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) add(yv[u], gv[u]);
      py += kUnroll * step;
      pg += kUnroll * step;
    }
    for (; k < p.n; ++k) {
      float yv[VEC], gv[VEC];
      load_vec<T, VEC>(py, yv);
      load_vec<T, VEC>(pg, gv);
      add(yv, gv);
      py += step;
      pg += step;
    }
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    p1[threadIdx.x][i] = s1[i];
    p2[threadIdx.x][i] = s2[i];
  }
  __syncthreads();
  if (p.lane == 0 && p.active) {
    const int gl = threadIdx.x;
    const int64_t row = (int64_t)blockIdx.x * 2 * C;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      float t1 = 0.f, t2 = 0.f;
      for (int l = 0; l < p.lanes; ++l) {
        t1 += p1[l * gpb + gl][i];
        t2 += p2[l * gpb + gl][i];
      }
      part[row + c0 + i] = t1;
      part[row + C + c0 + i] = t2;
    }
  }
}

// sums[col] = the column sums of part (rows, cols): block = 32 columns x
// kFinishLanes row lanes; lane l adds rows l, l + kFinishLanes, ... in
// order, lane 0 then adds the lanes in order.
__global__ void __launch_bounds__(32 * kFinishLanes)
bn_relu_bwd_finish_kernel(const float* __restrict__ part, int rows, int cols,
                          float* __restrict__ sums) {
  __shared__ float lane_sums[kFinishLanes][33];
  const int col = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (col < cols) {
    for (int r = threadIdx.y; r < rows; r += kFinishLanes) s += part[(int64_t)r * cols + col];
  }
  lane_sums[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && col < cols) {
    float t = 0.f;
#pragma unroll
    for (int l = 0; l < kFinishLanes; ++l) t += lane_sums[l][threadIdx.x];
    sums[col] = t;
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
bn_relu_bwd_dx_kernel(const T* __restrict__ y, const T* __restrict__ g,
                      const float* __restrict__ mean, const float* __restrict__ rstd,
                      const float* __restrict__ gamma, const float* __restrict__ beta,
                      const float* __restrict__ sums, T* __restrict__ dx, int M, int C,
                      int gpb, int chunk, int m_total) {
  const int blk = kDxReverse ? (int)(gridDim.x - 1 - blockIdx.x) : (int)blockIdx.x;
  const Place p = place<VEC>(M, C, gpb, chunk, blk);
  if (p.n <= 0) return;
  const int c0 = p.grp * VEC;
  const float fm = (float)m_total;
  float mu[VEC], rs[VEC], ga[VEC], be[VEC], c1[VEC], m1[VEC], m2[VEC];
  load_channels<VEC>(mean, c0, mu);
  load_channels<VEC>(rstd, c0, rs);
  load_channels<VEC>(gamma, c0, ga);
  load_channels<VEC>(beta, c0, be);
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    c1[i] = __fmul_rn(ga[i], rs[i]);
    m1[i] = sums[c0 + i] / fm;
    m2[i] = sums[C + c0 + i] / fm;
  }
  const int64_t step = (int64_t)p.lanes * C;
  const int64_t off = (int64_t)(p.r0 + p.lane) * C + c0;
  const T* py = y + off;
  const T* pg = g + off;
  T* pd = dx + off;
  auto grad = [&](const float (&yv)[VEC], const float (&gv)[VEC], T* out) {
    float o[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float xh = xhat_of(yv[i], mu[i], rs[i]);
      const float d = relu_on(xh, ga[i], be[i]) ? gv[i] : 0.f;
      o[i] = c1[i] * (d - m1[i] - xh * m2[i]);
    }
    store_vec<T, VEC>(out, o);
  };
  int k = 0;
  for (; k + kUnroll <= p.n; k += kUnroll) {
    float yv[kUnroll][VEC], gv[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      load_vec<T, VEC>(py + u * step, yv[u]);
      load_vec<T, VEC>(pg + u * step, gv[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) grad(yv[u], gv[u], pd + u * step);
    py += kUnroll * step;
    pg += kUnroll * step;
    pd += kUnroll * step;
  }
  for (; k < p.n; ++k) {
    float yv[VEC], gv[VEC];
    load_vec<T, VEC>(py, yv);
    load_vec<T, VEC>(pg, gv);
    grad(yv, gv, pd);
    py += step;
    pg += step;
    pd += step;
  }
}

// Pass 1 and the finish: part (blocks, 2*C) partials, then sums (2*C).
template <typename T, int VEC>
int launch_sums(const void* y, const void* g, const float* mean, const float* rstd,
                const float* gamma, const float* beta, float* part, float* sums, int m, int c,
                int chunk, cudaStream_t st) {
  const int groups = c / VEC;
  const int gpb = groups < kThreads ? groups : kThreads;
  const int blocks = (m - 1) / chunk + 1;
  const dim3 grid((unsigned)blocks, (unsigned)((groups + gpb - 1) / gpb));
  bn_relu_bwd_sums_kernel<T, VEC><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(y), static_cast<const T*>(g), mean, rstd, gamma, beta, part,
      m, c, gpb, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bn_relu_bwd_finish_kernel<<<(2 * c + 31) / 32, dim3(32, kFinishLanes), 0, st>>>(
      part, blocks, 2 * c, sums);
  return (int)cudaGetLastError();
}

// Pass 2: dx over this call's m rows from the sums over m_total rows (m, or
// the rows of every rank where the sums were all-reduced in between).
template <typename T, int VEC>
int launch_dx(const void* y, const void* g, const float* mean, const float* rstd,
              const float* gamma, const float* beta, const float* sums, void* dx, int m,
              int c, int chunk, int m_total, cudaStream_t st) {
  const int groups = c / VEC;
  const int gpb = groups < kThreads ? groups : kThreads;
  const int blocks = (m - 1) / chunk + 1;
  const dim3 grid((unsigned)blocks, (unsigned)((groups + gpb - 1) / gpb));
  bn_relu_bwd_dx_kernel<T, VEC><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(y), static_cast<const T*>(g), mean, rstd, gamma, beta, sums,
      static_cast<T*>(dx), m, c, gpb, chunk, m_total);
  return (int)cudaGetLastError();
}

// The vector width of a call: 1 on the scalar route, 16 bytes' worth of
// values where the 16-byte route is asked for and allowed (C a multiple of
// it, every pointer 16-byte aligned), -1 where it is asked for and not.
template <typename T>
int vec_width(bool vec, int c, const void* y, const void* g, const void* dx) {
  constexpr int kVec = (int)(16 / sizeof(T));
  if (!vec) return 1;
  const bool aligned = reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(dx) % 16 == 0;
  return (c % kVec == 0 && aligned) ? kVec : -1;
}

template <typename T>
int run_sums(bool vec, const void* y, const void* g, const float* mean, const float* rstd,
             const float* gamma, const float* beta, float* part, float* sums, int m, int c,
             int chunk, cudaStream_t st) {
  constexpr int kVec = (int)(16 / sizeof(T));
  const int w = vec_width<T>(vec, c, y, g, y);
  if (w < 0) return (int)cudaErrorInvalidValue;
  if (w == 1) {
    return launch_sums<T, 1>(y, g, mean, rstd, gamma, beta, part, sums, m, c, chunk, st);
  }
  return launch_sums<T, kVec>(y, g, mean, rstd, gamma, beta, part, sums, m, c, chunk, st);
}

template <typename T>
int run_dx(bool vec, const void* y, const void* g, const float* mean, const float* rstd,
           const float* gamma, const float* beta, const float* sums, void* dx, int m, int c,
           int chunk, int m_total, cudaStream_t st) {
  constexpr int kVec = (int)(16 / sizeof(T));
  const int w = vec_width<T>(vec, c, y, g, dx);
  if (w < 0) return (int)cudaErrorInvalidValue;
  if (w == 1) {
    return launch_dx<T, 1>(y, g, mean, rstd, gamma, beta, sums, dx, m, c, chunk, m_total, st);
  }
  return launch_dx<T, kVec>(y, g, mean, rstd, gamma, beta, sums, dx, m, c, chunk, m_total,
                            st);
}

template <typename T>
int run(bool vec, const void* y, const void* g, const float* mean, const float* rstd,
        const float* gamma, const float* beta, float* part, float* sums, void* dx, int m,
        int c, int chunk, cudaStream_t st) {
  if (vec_width<T>(vec, c, y, g, dx) < 0) return (int)cudaErrorInvalidValue;
  const int err = run_sums<T>(vec, y, g, mean, rstd, gamma, beta, part, sums, m, c, chunk, st);
  if (err != 0) return err;
  return run_dx<T>(vec, y, g, mean, rstd, gamma, beta, sums, dx, m, c, chunk, m, st);
}

}  // namespace
}  // namespace sfh

// Both passes and the sum between them.  y, g, dx (m, c) in one dtype (0 =
// float32, 1 = bfloat16); mean, rstd, gamma, beta (c) f32; chunk > 0 rows a
// block; part (ceil(m / chunk), 2*c) f32 scratch; sums (2*c) f32 receives
// [dbeta | dgamma].  vec != 0 takes the 16-byte route, which needs c a
// multiple of 16 bytes' worth of values (8 bf16, 4 f32) and y, g and dx
// 16-byte aligned.  Three launches on `stream`.  Returns the first launch
// error, or cudaErrorInvalidValue for arguments the kernels do not take.
extern "C" int sfh_bn_relu_bwd(const void* y, const void* g, const float* mean,
                               const float* rstd, const float* gamma, const float* beta,
                               float* part, float* sums, void* dx, int m, int c, int chunk,
                               int vec, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m <= 0 || c <= 0 || chunk <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    return sfh::run<float>(vec != 0, y, g, mean, rstd, gamma, beta, part, sums, dx, m, c,
                           chunk, st);
  }
  if (dtype == 1) {
    return sfh::run<__nv_bfloat16>(vec != 0, y, g, mean, rstd, gamma, beta, part, sums, dx,
                                   m, c, chunk, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The data-parallel form, split around the all-reduce of the sums.  First
// half: pass 1 and the finish (two launches), sums (2*c) = [dbeta | dgamma]
// of this rank's m rows; arguments as above (vec checks y and g only).
extern "C" int sfh_bn_relu_bwd_sums(const void* y, const void* g, const float* mean,
                                    const float* rstd, const float* gamma, const float* beta,
                                    float* part, float* sums, int m, int c, int chunk, int vec,
                                    int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m <= 0 || c <= 0 || chunk <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    return sfh::run_sums<float>(vec != 0, y, g, mean, rstd, gamma, beta, part, sums, m, c,
                                chunk, st);
  }
  if (dtype == 1) {
    return sfh::run_sums<__nv_bfloat16>(vec != 0, y, g, mean, rstd, gamma, beta, part, sums,
                                        m, c, chunk, st);
  }
  return (int)cudaErrorInvalidValue;
}

// Second half: pass 2 (one launch), dx of this rank's m rows from the sums
// over m_total rows of all ranks (the all-reduced sums; m_total >= m).
extern "C" int sfh_bn_relu_bwd_dx(const void* y, const void* g, const float* mean,
                                  const float* rstd, const float* gamma, const float* beta,
                                  const float* sums, void* dx, int m, int c, int chunk,
                                  int vec, int dtype, int m_total, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m <= 0 || c <= 0 || chunk <= 0 || m_total < m) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    return sfh::run_dx<float>(vec != 0, y, g, mean, rstd, gamma, beta, sums, dx, m, c, chunk,
                              m_total, st);
  }
  if (dtype == 1) {
    return sfh::run_dx<__nv_bfloat16>(vec != 0, y, g, mean, rstd, gamma, beta, sums, dx, m,
                                      c, chunk, m_total, st);
  }
  return (int)cudaErrorInvalidValue;
}
