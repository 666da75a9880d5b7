// K1: nearest homography warp of the court label template.
//
// Replaces: sports_field_homography_tpu/ops/warp_pallas.py::
// warp_nearest_interval_pallas (and its XLA twin
// ops/interval_warp.py::warp_nearest_interval), on the full output grid or
// on the sample_hw subgrid that the consistency score uses.
//
// What bounds it on an H100: memory latency of one scattered byte read per
// output sample, plus the 4-byte store.  The arithmetic (a 3x3 transform,
// one reciprocal) is tiny.  A 1280x720 uint8 template is 0.9 MB and stays
// in the 50 MB L2, so the gathers hit cache; the stores are coalesced.
//
// Design: one thread per output sample.  The TPU kernel encoded the
// template as per-row intervals and fetched rows with a one-hot matmul
// because TPU gathers are slow; on the GPU the thread reads the label
// directly.  The grid arithmetic must reproduce the plain version (and the
// JAX reference) bit for bit, or a sample on a pixel boundary rounds the
// other way and takes a different label.  So every step uses the
// round-to-nearest intrinsics, which nvcc never contracts into an FMA, in
// the reference's order: normalized grid -> transform_points with kornia's
// eps -> unnormalize (align_corners=False) -> round half to even (rintf).
// The sample's value is then looked up in a per-label f32 table that the
// host fills with what JAX's interval table gives each label (its code
// round(f32(label / classes) / step) times step), so a template that skips
// a label gets the reference's value, not label * step.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void warp_nearest_kernel(const uint8_t* __restrict__ tmpl, int ht,
                                    int wt, const float* __restrict__ theta,
                                    int batch, int ho, int wo, int full_h,
                                    int full_w, int sampled, float x_step,
                                    float y_step, float x_ratio, float y_ratio,
                                    const float* __restrict__ values,
                                    float* __restrict__ out) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t total = (int64_t)batch * ho * wo;
  if (idx >= total) return;
  const int c = (int)(idx % wo);
  const int64_t t = idx / wo;
  const int r = (int)(t % ho);
  const int b = (int)(t / ho);

  // grid index on the full out_hw grid: nearest-resize source indices
  // floor(i * full / sub) when sampling a subgrid
  float fx = (float)c, fy = (float)r;
  if (sampled) {
    fx = fminf(floorf(__fmul_rn(fx, x_ratio)), (float)(full_w - 1));
    fy = fminf(floorf(__fmul_rn(fy, y_ratio)), (float)(full_h - 1));
  }
  const float gx = __fsub_rn(__fmul_rn(fx, x_step), 1.0f);
  const float gy = __fsub_rn(__fmul_rn(fy, y_step), 1.0f);

  const float* th = theta + (int64_t)b * 9;
  const float px = __fadd_rn(__fadd_rn(__fmul_rn(th[0], gx), __fmul_rn(th[1], gy)), th[2]);
  const float py = __fadd_rn(__fadd_rn(__fmul_rn(th[3], gx), __fmul_rn(th[4], gy)), th[5]);
  const float pz = __fadd_rn(__fadd_rn(__fmul_rn(th[6], gx), __fmul_rn(th[7], gy)), th[8]);
  const float eps = 1e-8f;
  const float scale = fabsf(pz) > eps ? __frcp_rn(__fadd_rn(pz, eps)) : 1.0f;
  const float sx = __fmul_rn(px, scale);
  const float sy = __fmul_rn(py, scale);

  const float u = __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(sx, 1.0f), (float)wt), 1.0f), 0.5f);
  const float v = __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(sy, 1.0f), (float)ht), 1.0f), 0.5f);
  const float iu = rintf(u);
  const float iv = rintf(v);
  float value = 0.f;
  if (iu >= 0.f && iu < (float)wt && iv >= 0.f && iv < (float)ht) {
    value = values[tmpl[(int64_t)iv * wt + (int64_t)iu]];
  }
  out[idx] = value;
}

}  // namespace

// tmpl (ht, wt) uint8 labels; theta (batch, 3, 3) f32; out (batch, ho, wo)
// f32; values (256,) f32, the value of each label.  With sampled != 0,
// (ho, wo) is the sample grid and (full_h, full_w) the grid it samples;
// otherwise full_* equal ho, wo.  x_step/y_step are f32(2 / (full - 1)),
// x_ratio/y_ratio f32(full / sub).
// Returns cudaGetLastError().
extern "C" int sfh_warp_nearest(const uint8_t* tmpl, int ht, int wt,
                                const float* theta, int batch, int ho, int wo,
                                int full_h, int full_w, int sampled,
                                float x_step, float y_step, float x_ratio,
                                float y_ratio, const float* values, float* out,
                                void* stream) {
  const int64_t total = (int64_t)batch * ho * wo;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  warp_nearest_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      tmpl, ht, wt, theta, batch, ho, wo, full_h, full_w, sampled, x_step,
      y_step, x_ratio, y_ratio, values, out);
  return (int)cudaGetLastError();
}
