// The Möller–Trumbore step shared by the brute nearest-hit kernel
// (intersect.cu) and the visit-list walk (walk.cu), so that the two make
// the same decision for every (ray, triangle) pair.
//
// f32, in the operation order of the JAX golden
// (hermespy_rt_tpu/ops/intersect.py::_mt_block) and of the plain torch
// version (hermespy_rt_tpu_torch/ops/intersect.py::mt_hit):
//   pvec = d x e2, det = e1 . pvec, inv_det = 1 / det,
//   u = (s . pvec) inv_det, qvec = s x e1, v = (d . qvec) inv_det,
//   t = (e2 . qvec) inv_det                                   (s = o - v0)
// Built with -fmad=false and without fast math, every product, sum and the
// division are rounded on their own, as the plain version rounds them.
#pragma once

namespace hrt {

constexpr float kEps = 1.1920928955078125e-07f;  // FLT_EPSILON
constexpr float kTMax = 1e9f;                    // the reference's 'dist'

// t of the ray (o, d) against the triangle (v0, e1, e2); `valid` holds
// |det| >= eps, -eps <= u <= 1+eps, v >= -eps, u+v <= 1+eps and
// eps < t < T_MAX.  Exclusion and limits are the caller's.
__device__ __forceinline__ float mt_hit(
    float ox, float oy, float oz, float dx, float dy, float dz,
    float v0x, float v0y, float v0z, float e1x, float e1y, float e1z,
    float e2x, float e2y, float e2z, bool& valid) {
  const float px = dy * e2z - dz * e2y;
  const float py = dz * e2x - dx * e2z;
  const float pz = dx * e2y - dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const float sx = ox - v0x, sy = oy - v0y, sz = oz - v0z;
  const float inv_det = 1.0f / (det == 0.0f ? 1.0f : det);
  const float u = (sx * px + sy * py + sz * pz) * inv_det;
  const float qx = sy * e1z - sz * e1y;
  const float qy = sz * e1x - sx * e1z;
  const float qz = sx * e1y - sy * e1x;
  const float v = (dx * qx + dy * qy + dz * qz) * inv_det;
  const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  valid = fabsf(det) >= kEps && u >= -kEps && u <= 1.0f + kEps &&
          v >= -kEps && u + v <= 1.0f + kEps && t > kEps && t < kTMax;
  return t;
}

}  // namespace hrt
