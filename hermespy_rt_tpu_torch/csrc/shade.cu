// Bounce shading, reflection half, for NVIDIA Hopper (sm_90a).
//
// Replaces hermespy_rt_tpu/ops/shade.py::_shade_a_kernel (shade="pallas"):
// per ray after its nearest hit, the differentiable hit distance from the
// fetched triangle, the incidence trig, ITU Fresnel reflection with the
// per-segment free-space loss, the complex amplitude update, the specular
// ray update with the 1e-4 self-hit offset and the mesh-velocity Doppler.
// Plain torch version: hermespy_rt_tpu_torch/ops/shade.py::shade_a_plain
// (ops/shade.py::shade_a on these operands), which is also the op path's
// shading; the backward is autograd of it at the saved inputs
// (ops/shade_cuda.py::ShadeAFn), as the JAX package's _shade_a_bwd.
//
// The body is pre_forward of bounce.cuh, the fused pre stage's reflection
// half (bounce_fused.cu, bounce_bwd.cu), so the three kernels and the plain
// chain share one operation order; built with -fmad=false and without fast
// math, every product, sum, square root and division is rounded on its own
// as the plain version rounds them.  One thread per ray; the operands are
// the op path's: o, d [R, 3], the state as [6, R] rows, live, and the hit's
// payload row [R, 27] as the row-gather kernel fetched it (the TPU kernel
// reads the same row as [27, R] planes).  What bounds it is device memory:
// 12 + 12 + 24 + 108 + 1 bytes in and 12 + 12 + 24 + 20 out a ray (225
// bytes) against ~180 f32 operations.

#include "bounce.cuh"

namespace {

__global__ void __launch_bounds__(kThreads) shade_a_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ st, const unsigned char* __restrict__ live,
    const float* __restrict__ row, const float* __restrict__ sc, int R,
    float* __restrict__ o2, float* __restrict__ d2, float* __restrict__ st2,
    float* __restrict__ ex) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= R) return;
  const size_t n = R;
  const Payload p = load_payload(row + static_cast<size_t>(r) * kCols);
  const float fslm = __ldg(sc), k_dop = __ldg(sc + 1);
  float o_r[3], d_r[3], s[6];
  for (int c = 0; c < 3; ++c) {
    o_r[c] = o[3 * r + c];
    d_r[c] = d[3 * r + c];
  }
  for (int j = 0; j < 6; ++j) s[j] = st[j * n + r];
  const PreFwd f = pre_forward(o_r, d_r, s, p, fslm, k_dop, live[r] != 0);

  for (int c = 0; c < 3; ++c) {
    o2[3 * r + c] = f.o2[c];
    d2[3 * r + c] = f.d2[c];
  }
  for (int j = 0; j < 6; ++j) st2[j * n + r] = f.st2[j];
  ex[r] = f.theta;
  ex[n + r] = f.cos_t1;
  ex[2 * n + r] = f.ndot;
  ex[3 * n + r] = f.sin_t1;
  ex[4 * n + r] = f.fscale;
}

}  // namespace

// Plain C entry point for ctypes: o, d, o2, d2 [R, 3]; st, st2 [6, R]; row
// [R, 27]; sc [2] = (fslm, k_dop) on the device; ex [5, R].  Launches on
// `stream` and returns cudaGetLastError() of the launch.
extern "C" int hrt_shade_a(const float* o, const float* d, const float* st,
                           const unsigned char* live, const float* row,
                           const float* sc, int R, float* o2, float* d2,
                           float* st2, float* ex, void* stream) {
  if (R <= 0) return 0;
  shade_a_kernel<<<(R + kThreads - 1) / kThreads, kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      o, d, st, live, row, sc, R, o2, d2, st2, ex);
  return static_cast<int>(cudaGetLastError());
}
