// Brute-force Möller–Trumbore nearest hit for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels hermespy_rt_tpu/ops/intersect_pallas.py::_kernel
// (all rays) and ::_kernel_flags (rays with a liveness mask).  Those rewrite
// Möller–Trumbore as triple-product matmuls over a centred scene to use the
// TPU's matrix unit; this kernel computes the classic form instead, in f32,
// by the step of mt.cuh (shared with the walk, walk.cu), which rounds every
// product, sum and the division on its own, exactly as the plain torch twin
// (hermespy_rt_tpu_torch/ops/intersect.py::intersect_torch) rounds them, so
// the two make the same hit decisions.
//
// Contract per ray r < R: the triangle k < T with the smallest valid t,
// where valid means |det| >= FLT_EPS, -eps <= u <= 1+eps, v >= -eps,
// u+v <= 1+eps, eps < t < 1e9 and k != exclude[r].  Ties go to the lower k
// (ascending loop, strict <).  Output t[r] (+inf on a miss) and idx[r] (-1 on
// a miss); hits with t > t_max become misses, and a dead ray (live[r] == 0)
// reports a miss.
//
// What bounds it: FP32 ALU work, about 40 flops and one IEEE division per
// (ray, triangle) pair: about 1e10 flops for 2^20 rays against 256 triangles.
// The triangles are a few KB, so device memory is not the bound.  Design:
// one thread per ray, 256 threads per block; the block stages triangles
// through shared memory in tiles of 256 x (v0, e1, e2) = 9 KB, all threads of
// a warp read the same triangle at once (a shared-memory broadcast), and each
// thread keeps its running best (t, idx) in registers.  A block whose rays
// are all dead writes misses and returns before touching a triangle, the
// counterpart of _kernel_flags skipping dead ray tiles.
//
// nearest_hit_culled_kernel replaces ::_kernel_culled: the same contract,
// with each ray's limit lim[r] (t_max, or 1e9; -1 for a dead ray) tested
// inside the search (t <= lim), and per block of 256 rays a skip of every
// triangle tile whose box no ray of the block reaches.  The tiles are
// kCullTile = 64 triangles (the 256-triangle canyon stand-in has 4), each with
// its exact AABB (ops/walk.py::tile_aabbs).  Before staging a tile, every ray
// slab-tests the tile's box (slab.cuh, the walk's test) within
// limit = min(best t, lim[r]); when no ray of the block reaches it
// (__syncthreads_or, the TPU kernel's pl.when(any(reach))) the block skips
// the tile.  Tiles go in ascending order and the update is the strict <, so
// the decisions are the brute kernel's: a skipped tile holds no hit nearer
// than the ray's best, but for a hit accepted a hair outside its triangle
// (u, v >= -eps) beyond its tile's exact box, as for the walk
// (ops/walk.py).  The skipped (block, tile) pairs are counted (one
// atomic add per block) so that a check can hold them to the plain
// version's (ops/walk.py::culled_reach_plain).  What bounds it: as the brute
// kernel, 47 operations per (live ray, triangle) pair, here only in the
// tiles a block reaches, plus one slab test per (ray, tile).

#include <cuda_runtime.h>
#include <math_constants.h>

#include "mt.cuh"
#include "slab.cuh"

namespace {

constexpr int kThreads = 256;   // rays per block
constexpr int kTile = 256;      // triangles staged per shared-memory tile
constexpr int kCullTile = 64;   // triangles per tile of the culled kernel

__global__ void __launch_bounds__(kThreads) nearest_hit_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ v0, const float* __restrict__ e1,
    const float* __restrict__ e2, int R, int T,
    const int* __restrict__ exclude, const float* __restrict__ t_max,
    float t_max_scalar, const unsigned char* __restrict__ live,
    float* __restrict__ t_out, int* __restrict__ idx_out) {
  // component-major tile: rows 0-2 v0, 3-5 e1, 6-8 e2
  __shared__ float tri[9][kTile];

  const int r = blockIdx.x * kThreads + threadIdx.x;
  const bool in_range = r < R;
  const bool alive = in_range && (live == nullptr || live[r] != 0);
  if (!__syncthreads_or(alive)) {
    if (in_range) {
      t_out[r] = CUDART_INF_F;
      idx_out[r] = -1;
    }
    return;
  }

  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  int ex = -1;
  if (alive) {
    ox = o[3 * r]; oy = o[3 * r + 1]; oz = o[3 * r + 2];
    dx = d[3 * r]; dy = d[3 * r + 1]; dz = d[3 * r + 2];
    if (exclude != nullptr) ex = exclude[r];
  }
  float best_t = CUDART_INF_F;
  int best_i = -1;

  for (int base = 0; base < T; base += kTile) {
    const int n = min(kTile, T - base);
    __syncthreads();  // the previous tile has been consumed
    for (int k = threadIdx.x; k < n; k += kThreads) {
      const int g = 3 * (base + k);
      tri[0][k] = v0[g]; tri[1][k] = v0[g + 1]; tri[2][k] = v0[g + 2];
      tri[3][k] = e1[g]; tri[4][k] = e1[g + 1]; tri[5][k] = e1[g + 2];
      tri[6][k] = e2[g]; tri[7][k] = e2[g + 1]; tri[8][k] = e2[g + 2];
    }
    __syncthreads();
    if (!alive) continue;
    for (int k = 0; k < n; ++k) {
      bool valid;
      const float t = hrt::mt_hit(ox, oy, oz, dx, dy, dz, tri[0][k],
                                  tri[1][k], tri[2][k], tri[3][k], tri[4][k],
                                  tri[5][k], tri[6][k], tri[7][k], tri[8][k],
                                  valid);
      valid = valid && base + k != ex;
      if (valid && t < best_t) {
        best_t = t;
        best_i = base + k;
      }
    }
  }

  if (in_range) {
    const float tm = t_max != nullptr ? t_max[r] : t_max_scalar;
    const bool keep = alive && best_t <= tm;
    t_out[r] = keep ? best_t : CUDART_INF_F;
    idx_out[r] = keep ? best_i : -1;
  }
}

__global__ void __launch_bounds__(kThreads) nearest_hit_culled_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ v0, const float* __restrict__ e1,
    const float* __restrict__ e2, int R, int T,
    const float* __restrict__ aabbs, const int* __restrict__ exclude,
    const float* __restrict__ lim, float* __restrict__ t_out,
    int* __restrict__ idx_out, unsigned long long* __restrict__ skipped) {
  __shared__ float tri[9][kCullTile];

  const int n_tiles = (T + kCullTile - 1) / kCullTile;
  const int r = blockIdx.x * kThreads + threadIdx.x;
  const bool in_range = r < R;
  const float l = in_range ? lim[r] : -1.0f;
  if (!__syncthreads_or(l >= 0.0f)) {   // every query of the block is void
    if (in_range) {
      t_out[r] = CUDART_INF_F;
      idx_out[r] = -1;
    }
    if (threadIdx.x == 0 && skipped != nullptr)
      atomicAdd(skipped, static_cast<unsigned long long>(n_tiles));
    return;
  }

  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  int ex = -1;
  if (in_range) {
    ox = o[3 * r]; oy = o[3 * r + 1]; oz = o[3 * r + 2];
    dx = d[3 * r]; dy = d[3 * r + 1]; dz = d[3 * r + 2];
    if (exclude != nullptr) ex = exclude[r];
  }
  const float ix = inverse(dx), iy = inverse(dy), iz = inverse(dz);
  float best_t = CUDART_INF_F;
  int best_i = -1;
  int n_skipped = 0;

  for (int j = 0; j < n_tiles; ++j) {
    float box[6];
#pragma unroll
    for (int a = 0; a < 6; ++a) box[a] = __ldg(aabbs + 6 * j + a);
    float t_near, t_far;
    slab(ox, oy, oz, ix, iy, iz, box, t_near, t_far);
    // also the barrier after the previous tile's evaluation
    if (!__syncthreads_or(reaches(t_near, t_far, fminf(best_t, l)))) {
      ++n_skipped;
      continue;
    }
    const int base = j * kCullTile;
    const int n = min(kCullTile, T - base);
    for (int k = threadIdx.x; k < n; k += kThreads) {
      const int g = 3 * (base + k);
      tri[0][k] = v0[g]; tri[1][k] = v0[g + 1]; tri[2][k] = v0[g + 2];
      tri[3][k] = e1[g]; tri[4][k] = e1[g + 1]; tri[5][k] = e1[g + 2];
      tri[6][k] = e2[g]; tri[7][k] = e2[g + 1]; tri[8][k] = e2[g + 2];
    }
    __syncthreads();
    if (!(l >= 0.0f)) continue;
    for (int k = 0; k < n; ++k) {
      bool valid;
      const float t = hrt::mt_hit(ox, oy, oz, dx, dy, dz, tri[0][k],
                                  tri[1][k], tri[2][k], tri[3][k], tri[4][k],
                                  tri[5][k], tri[6][k], tri[7][k], tri[8][k],
                                  valid);
      if (valid && base + k != ex && t <= l && t < best_t) {
        best_t = t;
        best_i = base + k;
      }
    }
  }

  if (in_range) {
    t_out[r] = best_t;
    idx_out[r] = best_i;
  }
  if (threadIdx.x == 0 && skipped != nullptr)
    atomicAdd(skipped, static_cast<unsigned long long>(n_skipped));
}

}  // namespace

// Plain C entry point for ctypes.  Pointers are device pointers; exclude,
// t_max and live may be null (none / use t_max_scalar / all live).  Launches
// on `stream` and returns cudaGetLastError() of the launch.
extern "C" int hrt_nearest_hit(const float* o, const float* d, const float* v0,
                               const float* e1, const float* e2, int R, int T,
                               const int* exclude, const float* t_max,
                               float t_max_scalar, const unsigned char* live,
                               float* t_out, int* idx_out, void* stream) {
  if (R <= 0) return 0;
  const dim3 grid((R + kThreads - 1) / kThreads);
  nearest_hit_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      o, d, v0, e1, e2, R, T, exclude, t_max, t_max_scalar, live, t_out,
      idx_out);
  return static_cast<int>(cudaGetLastError());
}

// The culled kernel: `aabbs` holds ceil(T / 64) boxes (lo xyz, hi xyz),
// `lim` R limits (-1: a void query), exclude and skipped may be null.
extern "C" int hrt_nearest_hit_culled(const float* o, const float* d,
                                      const float* v0, const float* e1,
                                      const float* e2, int R, int T,
                                      const float* aabbs, const int* exclude,
                                      const float* lim, float* t_out,
                                      int* idx_out,
                                      unsigned long long* skipped,
                                      void* stream) {
  if (R <= 0) return 0;
  const dim3 grid((R + kThreads - 1) / kThreads);
  nearest_hit_culled_kernel<<<grid, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      o, d, v0, e1, e2, R, T, aabbs, exclude, lim, t_out, idx_out, skipped);
  return static_cast<int>(cudaGetLastError());
}
