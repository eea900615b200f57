// The slab test of a ray against an axis-aligned box, shared by the walk
// (walk.cu: the prepass and the walk's per-tile test) and the culled nearest
// hit (intersect.cu), so that both decide as their plain versions
// (hermespy_rt_tpu_torch/ops/walk.py::_slab, ::_reach) and as the TPU
// kernels: inv = 1 / (d == 0 ? 1e-30 : d), (plane - o) inv per axis,
// NaN-propagating min/max, reach = t_far >= 0 & t_near <= t_far &
// t_near <= limit & limit >= 0.
#pragma once

namespace {

constexpr float kInvZero = 1e-30f;

// min / max that return NaN when either operand is NaN, as torch.minimum and
// jnp.minimum do (fminf would return the other operand).
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float inverse(float x) {
  return 1.0f / (x == 0.0f ? kInvZero : x);
}

// (t_near, t_far) of the ray (o, inv) against the box (lo xyz, hi xyz).
__device__ __forceinline__ void slab(float ox, float oy, float oz, float ix,
                                     float iy, float iz,
                                     const float* __restrict__ box,
                                     float& t_near, float& t_far) {
  float p = (box[0] - ox) * ix, q = (box[3] - ox) * ix;
  t_near = min_nan(p, q);
  t_far = max_nan(p, q);
  p = (box[1] - oy) * iy;
  q = (box[4] - oy) * iy;
  t_near = max_nan(t_near, min_nan(p, q));
  t_far = min_nan(t_far, max_nan(p, q));
  p = (box[2] - oz) * iz;
  q = (box[5] - oz) * iz;
  t_near = max_nan(t_near, min_nan(p, q));
  t_far = min_nan(t_far, max_nan(p, q));
}

__device__ __forceinline__ bool reaches(float t_near, float t_far,
                                        float limit) {
  return t_far >= 0.0f && t_near <= t_far && t_near <= limit &&
         limit >= 0.0f;
}

}  // namespace
