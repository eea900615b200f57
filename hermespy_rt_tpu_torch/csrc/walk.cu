// The visit-list walk for large scenes on NVIDIA Hopper (sm_90a): a
// slab-test prepass and the walk itself.
//
// walk_prepass_kernel replaces hermespy_rt_tpu/ops/intersect_pallas.py::
// _prepass_kernel (reached through _prepass_reach_key_pallas and
// _walk_prepass).  Per (ray tile of 256 rays, coarse box) it writes
// reach = any ray of the tile reaches the box and key = the least
// max(t_near, 0) over those rays (+inf if none), with the TPU kernel's
// arithmetic per (ray, box): inv = 1 / (d == 0 ? 1e-30 : d), (plane - o) inv,
// NaN-propagating min/max per axis, reach = t_far >= 0 & t_near <= t_far &
// t_near <= lim & lim >= 0.  The count and the stable sort of the keys into
// visit rows stay torch ops after it (ops/walk.py::visit_rows), as the JAX
// package does them in XLA outside its kernel.
// What bounds it: f32 work, about 20 operations per (live ray, box) pair,
// ~1e10 for 2^20 rays and 512 boxes (0.16 ms at 67 TFLOP/s); its bytes (the
// rays once, reach and key out) are a few MB.  Design: grid (ray tile, chunk
// of 256 boxes); the block stages its tile's o, inv and lim in shared memory
// (3 KB); each thread owns one box and loops over the tile's rays (a
// shared-memory broadcast), keeping any(reach) and min(key) in registers, so
// no reduction across threads is needed.  A dead ray (lim < 0) is skipped by
// the whole block at once.
//
// walk_kernel replaces ::_kernel_walk_res (triangles resident in VMEM) and
// ::_kernel_walk (triangle tiles streamed from HBM by DMA), which differ only
// in where the TPU keeps the triangles; here they come from device memory
// through L2, so one kernel covers both.  One block per ray tile, one thread
// per ray.  The block walks its visit row: for each listed coarse box, each
// member fine tile of `group`; every ray slab-tests the tile's exact AABB
// within limit = min(best t, lim) (in any-hit mode -1 once it has a hit);
// when any ray of the block reaches the tile (__syncthreads_or, as the TPU
// kernel's pl.when(any(reach))) the block stages the tile's (v0, e1, e2) in
// shared memory (block_tris <= 256; 4.6 KB at 128) and every ray evaluates
// every triangle with the Möller–Trumbore step of mt.cuh, t <= lim inside
// the test, and the (t, idx) lexicographic minimum as the update, so ties go
// to the lower index whatever the visit order.  In any-hit mode the block
// stops when none of its rays is still searching.  Output idx = -1 where t
// is +inf.
// What bounds it: f32 work, 47 operations per (live ray, triangle) pair in
// the tiles the walk must evaluate, plus the slab tests; the triangles are
// read from L2 once per evaluating block.  A simple kernel: no cp.async/TMA
// double buffering of tiles and no per-ray BVH (later speed work).

#include <cuda_runtime.h>
#include <math_constants.h>

#include "mt.cuh"
#include "slab.cuh"

namespace {

constexpr int kRays = 256;      // rays per tile: threads of either kernel
constexpr int kBoxes = 256;     // coarse boxes per prepass block
constexpr int kMaxTile = 256;   // largest fine tile the walk stages
constexpr int kNoHit = 0x7fffffff;

static_assert(kRays == kBoxes, "the prepass stages one ray per thread");

__global__ void __launch_bounds__(kBoxes) walk_prepass_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ lim, int R, const float* __restrict__ boxes,
    int C, unsigned char* __restrict__ reach, float* __restrict__ key) {
  __shared__ float s_o[3][kRays], s_inv[3][kRays], s_lim[kRays];
  const int tile = blockIdx.x;
  {
    const int r = tile * kRays + threadIdx.x;
    const bool in = r < R;   // padding rays: o = d = 0, lim = -1 (wrapper)
    s_o[0][threadIdx.x] = in ? o[3 * r] : 0.0f;
    s_o[1][threadIdx.x] = in ? o[3 * r + 1] : 0.0f;
    s_o[2][threadIdx.x] = in ? o[3 * r + 2] : 0.0f;
    s_inv[0][threadIdx.x] = inverse(in ? d[3 * r] : 0.0f);
    s_inv[1][threadIdx.x] = inverse(in ? d[3 * r + 1] : 0.0f);
    s_inv[2][threadIdx.x] = inverse(in ? d[3 * r + 2] : 0.0f);
    s_lim[threadIdx.x] = lim[r];
  }
  __syncthreads();
  const int c = blockIdx.y * kBoxes + threadIdx.x;
  if (c >= C) return;
  float box[6];
#pragma unroll
  for (int a = 0; a < 6; ++a) box[a] = boxes[6 * c + a];
  bool any = false;
  float k_min = CUDART_INF_F;
  for (int i = 0; i < kRays; ++i) {
    const float l = s_lim[i];
    if (!(l >= 0.0f)) continue;   // never reaches: the same i in every thread
    float t_near, t_far;
    slab(s_o[0][i], s_o[1][i], s_o[2][i], s_inv[0][i], s_inv[1][i],
         s_inv[2][i], box, t_near, t_far);
    if (reaches(t_near, t_far, l)) {
      any = true;
      k_min = fminf(k_min, t_near > 0.0f ? t_near : 0.0f);
    }
  }
  const size_t out = static_cast<size_t>(tile) * C + c;
  reach[out] = any ? 1 : 0;
  key[out] = k_min;
}

__global__ void __launch_bounds__(kRays) walk_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ lim, const int* __restrict__ exclude, int R,
    const float* __restrict__ v0, const float* __restrict__ e1,
    const float* __restrict__ e2, const float* __restrict__ aabbs,
    const int* __restrict__ visits, int stride, int group, int block_tris,
    int any_hit, float* __restrict__ t_out, int* __restrict__ idx_out) {
  // component-major tile: rows 0-2 v0, 3-5 e1, 6-8 e2
  __shared__ float tri[9][kMaxTile];

  const int r = blockIdx.x * kRays + threadIdx.x;
  const bool in_range = r < R;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  int ex = -1;
  if (in_range) {
    ox = o[3 * r]; oy = o[3 * r + 1]; oz = o[3 * r + 2];
    dx = d[3 * r]; dy = d[3 * r + 1]; dz = d[3 * r + 2];
    if (exclude != nullptr) ex = exclude[r];
  }
  const float ix = inverse(dx), iy = inverse(dy), iz = inverse(dz);
  const float l = lim[r];          // padded: -1 for out-of-range rays
  float best_t = CUDART_INF_F;
  int best_i = kNoHit;

  const int* row = visits + static_cast<size_t>(blockIdx.x) * stride;
  const int n = row[0];
  for (int e = 0; e < n; ++e) {
    const int box = row[1 + e];
    for (int m = 0; m < group; ++m) {
      const int j = box * group + m;
      float limit = fminf(best_t, l);
      if (any_hit && best_t < CUDART_INF_F) limit = -1.0f;
      float t_near, t_far;
      slab(ox, oy, oz, ix, iy, iz, aabbs + 6 * j, t_near, t_far);
      // also the barrier after the previous tile's evaluation
      if (!__syncthreads_or(reaches(t_near, t_far, limit))) continue;
      const int base = j * block_tris;
      for (int k = threadIdx.x; k < block_tris; k += kRays) {
        const size_t g = 3 * static_cast<size_t>(base + k);
        tri[0][k] = v0[g]; tri[1][k] = v0[g + 1]; tri[2][k] = v0[g + 2];
        tri[3][k] = e1[g]; tri[4][k] = e1[g + 1]; tri[5][k] = e1[g + 2];
        tri[6][k] = e2[g]; tri[7][k] = e2[g + 1]; tri[8][k] = e2[g + 2];
      }
      __syncthreads();
      for (int k = 0; k < block_tris; ++k) {
        bool valid;
        const float t = hrt::mt_hit(ox, oy, oz, dx, dy, dz, tri[0][k],
                                    tri[1][k], tri[2][k], tri[3][k],
                                    tri[4][k], tri[5][k], tri[6][k],
                                    tri[7][k], tri[8][k], valid);
        const int g = base + k;
        if (valid && g != ex && t <= l &&
            (t < best_t || (t == best_t && g < best_i))) {
          best_t = t;
          best_i = g;
        }
      }
    }
    if (any_hit &&
        !__syncthreads_or(l >= 0.0f && !(best_t < CUDART_INF_F)))
      break;   // no ray of the block still searching
  }
  if (in_range) {
    t_out[r] = best_t;
    idx_out[r] = best_t < CUDART_INF_F ? best_i : -1;
  }
}

}  // namespace

// Plain C entry points for ctypes.  Pointers are device pointers; `lim` has
// n_tiles * 256 entries (-1 past R), exclude may be null.  Each launches on
// `stream` and returns cudaGetLastError() of the launch.
extern "C" int hrt_walk_prepass(const float* o, const float* d,
                                const float* lim, int R, int n_tiles,
                                const float* boxes, int C,
                                unsigned char* reach, float* key,
                                void* stream) {
  if (n_tiles <= 0 || C <= 0) return 0;
  const dim3 grid(n_tiles, (C + kBoxes - 1) / kBoxes);
  walk_prepass_kernel<<<grid, kBoxes, 0, static_cast<cudaStream_t>(stream)>>>(
      o, d, lim, R, boxes, C, reach, key);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hrt_walk(const float* o, const float* d, const float* lim,
                        const int* exclude, int R, int n_tiles,
                        const float* v0, const float* e1, const float* e2,
                        const float* aabbs, const int* visits, int stride,
                        int group, int block_tris, int any_hit, float* t_out,
                        int* idx_out, void* stream) {
  if (n_tiles <= 0) return 0;
  if (block_tris <= 0 || block_tris > kMaxTile) return cudaErrorInvalidValue;
  walk_kernel<<<n_tiles, kRays, 0, static_cast<cudaStream_t>(stream)>>>(
      o, d, lim, exclude, R, v0, e1, e2, aabbs, visits, stride, group,
      block_tris, any_hit, t_out, idx_out);
  return static_cast<int>(cudaGetLastError());
}
