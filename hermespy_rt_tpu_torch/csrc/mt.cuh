// The Möller–Trumbore step shared by every nearest-hit kernel: the brute
// and culled scans (intersect.cu) and the visit-list walk (walk.cu), so
// that all of them make the same decision for every (ray, triangle) pair.
//
// f32, in the operation order of the JAX golden
// (hermespy_rt_tpu/ops/intersect.py::_mt_block) and of the plain torch
// version (hermespy_rt_tpu_torch/ops/intersect.py::mt_hit):
//   pvec = d x e2, det = e1 . pvec, inv_det = 1 / det,
//   u = (s . pvec) inv_det, qvec = s x e1, v = (d . qvec) inv_det,
//   t = (e2 . qvec) inv_det                                   (s = o - v0)
// Built with -fmad=false and without fast math, every product, sum and the
// division are rounded on their own, as the plain version rounds them.
//
// valid is the AND of |det| >= eps, -eps <= u <= 1+eps, v >= -eps,
// u+v <= 1+eps and eps < t < T_MAX, so the step is cut at its tests: once
// one fails, what is left cannot make the pair valid and is not computed; a
// warp skips it when all its lanes have failed, which coherent rays mostly
// do together.  What is computed is computed in the plain version's order,
// so the roundings, the decisions and t are its own.  Three cuts:
// 1. |det| < eps (or NaN): invalid.  Past it det != 0, so 1 / det is the
//    plain version's 1 / (det == 0 ? 1 : det).
// 2. Before the division, u = un / det (un = s . pvec) is tested without
//    it: with su = un signed as det and margins of 1e-3, su < -1.001 eps
//    |det| or su > 1.001 (1+eps) |det| put the computed u (two roundings of
//    2^-24 from un / det, the thresholds one more) below -eps or above
//    1+eps, so the plain test on u fails too.  Infinite or NaN values fail
//    neither comparison and go on to the exact test.
// 3. The exact tests on u, then on v.
#pragma once

namespace hrt {

constexpr float kEps = 1.1920928955078125e-07f;  // FLT_EPSILON
constexpr float kTMax = 1e9f;                    // the reference's 'dist'

// Whether the ray (o, d) hits the triangle (v0, e1, e2); sets t where it
// does.  Exclusion and limits are the caller's.
__device__ __forceinline__ bool mt_valid(
    float ox, float oy, float oz, float dx, float dy, float dz, float v0x,
    float v0y, float v0z, float e1x, float e1y, float e1z, float e2x,
    float e2y, float e2z, float& t) {
  const float px = dy * e2z - dz * e2y;
  const float py = dz * e2x - dx * e2z;
  const float pz = dx * e2y - dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const float adet = fabsf(det);
  if (!(adet >= kEps)) return false;                          // cut 1
  const float sx = ox - v0x, sy = oy - v0y, sz = oz - v0z;
  const float un = sx * px + sy * py + sz * pz;
  const float su = det < 0.0f ? -un : un;
  if (su < -(kEps * 1.001f) * adet || su > (1.0f + kEps) * 1.001f * adet)
    return false;                                             // cut 2
  const float inv_det = 1.0f / det;
  const float u = un * inv_det;
  if (!(u >= -kEps && u <= 1.0f + kEps)) return false;        // cut 3
  const float qx = sy * e1z - sz * e1y;
  const float qy = sz * e1x - sx * e1z;
  const float qz = sx * e1y - sy * e1x;
  const float v = (dx * qx + dy * qy + dz * qz) * inv_det;
  if (!(v >= -kEps && u + v <= 1.0f + kEps)) return false;
  t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  return t > kEps && t < kTMax;
}

}  // namespace hrt
