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
// through L2, so one kernel covers both.  One block of 256 threads per ray
// tile of 256 rays walks the tile's visit row: for each listed coarse box,
// each member fine tile of `group`; every live ray slab-tests the tile's
// exact AABB within limit = min(best t, lim) (in any-hit mode -1 once it has
// a hit); when any ray of the tile reaches it (__syncthreads_or, as the TPU
// kernel's pl.when(any(reach))) the block evaluates every triangle of the
// tile for every live ray with mt.cuh's Möller–Trumbore step (point 4),
// t <= lim inside the test, and the (t, idx) lexicographic minimum as the
// update, so ties go to the lower index whatever the visit order.  In
// any-hit mode the block stops after a box once no live ray is still without
// a hit.  Output idx = -1 where t is +inf.
//
// What bounds it: f32 work, 47 operations per (live ray, triangle) pair of
// the fine tiles its block reaches (the contract makes every live ray of
// the tile evaluate a tile that any of them reaches), plus one slab test
// per (live ray, listed tile); the triangles, 131,072 x 48 bytes for the
// config-5 city, stay in the 50 MB L2.  The design, and why each part
// gives the bits of the plain version (ops/walk.py::walk_plain):
//
// 1. Only live rays evaluate.  The block packs its live rays (lim >= 0; the
//    padding rays of the last tile have lim = -1) by ballot and prefix count
//    into shared memory, once: lim does not change during the walk, so the
//    live set of every reached tile is this one.  A dead ray can never
//    update: an accepted t needs t > eps > 0 > lim.  Its slab test is never
//    true either (limit <= lim < 0), so skipping it changes no decision.
// 2. A reached tile's pairs are dealt over the whole block.  Live rays go in
//    groups of Lw (32, or the next power of two >= L below 32) to the lanes
//    of a warp, 32 / Lw lanes per ray taking every (32 / Lw)-th triangle;
//    the tile's triangles are cut into n = 8 / gcd(G, 8) slices for the G
//    groups, so the G x n (group, slice) tasks are a multiple of the 8 warps
//    and every warp takes as many.  With 256 live rays that is one ray a
//    thread over the whole tile, as in the brute kernel; one ray (the LoS
//    query) spreads its tile over 128 threads.  Each lane keeps the least
//    (t, idx) of its triangles (ascending index, strict <), and a lane with
//    a hit folds it into its ray's best with a 64-bit atomicMin on
//    (float bits of t) << 32 | idx in shared memory.  An accepted t is
//    positive and finite, so its bits order as unsigned integers, and the
//    index in the low word breaks ties to the lower index: the packed
//    minimum is the lexicographic one.  A minimum does not depend on the
//    order of its terms, so the bits are the same in every run and equal
//    the plain version's, which takes the same minimum tile by tile.
// 3. The tiles are staged ahead.  prepare_walk keeps each triangle as one
//    48-byte record (v0, 0 | e1, 0 | e2, 0; ops/walk.py::triangle_records),
//    so a fine tile is one contiguous run of block_tris x 48 bytes, read by
//    three 16-byte shared-memory loads a pair.  A ring of kStages buffers in
//    dynamic shared memory holds the next listed tiles: one thread copies
//    each with one bulk copy (cp.async.bulk), completed on an mbarrier of
//    its buffer, kStages - 1 listed tiles ahead of the walk, whether or not
//    they will be reached.  The reach test of a tile still runs after the
//    previous tile's evaluation, on the updated best; a tile not reached is
//    never read, and its buffer is refilled once its copy has landed.  The
//    block drains its copies before it exits.
// 4. A pair stops at its first failed test: mt.cuh::mt_valid, the
//    Möller–Trumbore step with the plain version's operations in its order
//    (so its roundings under -fmad=false), cut after det, after a
//    division-free bound on u (with a margin that keeps every pair the
//    exact test accepts), after u and after v: valid is the AND of the
//    tests, so what is skipped cannot make the pair valid.  The slab test
//    is slab.cuh's, as in the prepass.
//    Points 1-4 (the packing, the deal, the records and their ring, the
//    pair test) are shared with the brute and culled scans of intersect.cu
//    through tile_scan.cuh and mt.cuh.
// 5. Long rows start first.  Block b walks ray tile order[b], the ray tiles
//    by visit-row length, longest first (ops/walk_cuda.py sorts them on the
//    card), so that no long row is left running alone at the end.  Each
//    ray tile is still walked whole by one block: the order of the blocks
//    changes no bit.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "slab.cuh"
#include "tile_scan.cuh"

namespace {

constexpr int kBoxes = 256;     // coarse boxes per prepass block
constexpr int kMaxTile = 256;   // largest fine tile the walk stages

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

constexpr int kStages = 4;       // fine tiles in flight: the ring of buffers

__global__ void __launch_bounds__(kRays) walk_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ lim, const int* __restrict__ exclude, int R,
    const float4* __restrict__ records, const float* __restrict__ aabbs,
    const int* __restrict__ visits, int stride, int group, int block_tris,
    int any_hit, const long long* __restrict__ order,
    float* __restrict__ t_out, int* __restrict__ idx_out) {
  extern __shared__ __align__(128) float4 s_tiles[];  // kStages tiles
  __shared__ LiveRays s_live;
  __shared__ unsigned long long s_bar[kStages];

  const int tid = threadIdx.x;
  const int ray_tile = static_cast<int>(order[blockIdx.x]);
  const int r = ray_tile * kRays + tid;
  const float l = lim[r];             // padded: -1 for out-of-range rays
  const bool live = r < R && l >= 0.0f;
  if (tid == 0) {
    for (int b = 0; b < kStages; ++b) barrier_init(&s_bar[b]);
    barrier_init_fence();
  }
  const unsigned ballot = pack_count(s_live, live);
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  if (live) {
    ox = o[3 * r]; oy = o[3 * r + 1]; oz = o[3 * r + 2];
    dx = d[3 * r]; dy = d[3 * r + 1]; dz = d[3 * r + 2];
  }
  const float ix = inverse(dx), iy = inverse(dy), iz = inverse(dz);
  __syncthreads();
  int L;
  const int pos = pack_slot(s_live, ballot, L);
  if (live)
    pack_ray(s_live, pos, ox, oy, oz, l, dx, dy, dz,
             exclude != nullptr ? exclude[r] : -1);

  const int* row = visits + static_cast<size_t>(ray_tile) * stride;
  const int n_tiles = L > 0 ? row[0] * group : 0;   // listed fine tiles
  const int tile_floats = block_tris * kRecord;     // float4s a tile
  const unsigned tile_bytes = static_cast<unsigned>(tile_floats) * 16u;
  // fine tile of the s-th listed step
  auto fine = [&](int s) { return row[1 + s / group] * group + s % group; };
  // the copies: buffer s % kStages holds listed tile s; bit b of `pending`
  // marks a copy into buffer b not yet waited for, bit b of `parity` the
  // parity of its phase (the same in every thread: every decision below is
  // the block's)
  unsigned pending = 0, parity = 0;
  for (int s = 0; s < n_tiles && s < kStages - 1; ++s) {
    if (tid == 0)
      tile_copy(s_tiles + s * tile_floats,
                records + static_cast<size_t>(fine(s)) * tile_floats,
                tile_bytes, &s_bar[s]);
    pending |= 1u << s;
  }
  __syncthreads();

  const Deal deal(L);   // of a reached tile's pairs (point 2)

  int j = n_tiles > 0 ? fine(0) : 0;
  for (int s = 0; s < n_tiles; ++s) {
    const int j_next = s + 1 < n_tiles ? fine(s + 1) : j;
    // refill: listed tile s + kStages - 1 into the buffer of tile s - 1,
    // which every thread has finished reading (the barriers of step s - 1)
    const int ahead = s + kStages - 1;
    if (ahead < n_tiles) {
      const unsigned b = ahead % kStages, bit = 1u << b;
      if (tid == 0) {
        if (pending & bit) barrier_wait(&s_bar[b], (parity & bit) != 0);
        tile_copy(s_tiles + b * tile_floats,
                  records + static_cast<size_t>(fine(ahead)) * tile_floats,
                  tile_bytes, &s_bar[b]);
      }
      if (pending & bit) parity ^= bit;
      pending |= bit;
    }
    bool reach = false;
    if (live) {
      const float best_t = hit_t(s_live.best[pos]);
      float limit = fminf(best_t, l);
      if (any_hit && best_t < CUDART_INF_F) limit = -1.0f;
      float t_near, t_far;
      slab(ox, oy, oz, ix, iy, iz, aabbs + 6 * j, t_near, t_far);
      reach = reaches(t_near, t_far, limit);
    }
    if (__syncthreads_or(reach)) {
      const unsigned b = s % kStages, bit = 1u << b;
      barrier_wait(&s_bar[b], (parity & bit) != 0);
      parity ^= bit;
      pending &= ~bit;
      eval_tile(s_live, deal, L, s_tiles + b * tile_floats, block_tris,
                j * block_tris);
      __syncthreads();
    }
    if (any_hit && s % group == group - 1 &&
        !__syncthreads_or(live && !(hit_t(s_live.best[pos]) < CUDART_INF_F)))
      break;   // no live ray of the block still searching
    j = j_next;
  }
  // no copy may land in shared memory after the block has left it
  if (tid == 0)
    for (int b = 0; b < kStages; ++b)
      if (pending >> b & 1u) barrier_wait(&s_bar[b], parity >> b & 1u);
  if (r < R) {
    float t = CUDART_INF_F;
    int idx = -1;
    if (live) {
      const unsigned long long key = s_live.best[pos];
      t = hit_t(key);
      if (t < CUDART_INF_F) idx = static_cast<int>(key & 0xffffffffu);
    }
    t_out[r] = t;
    idx_out[r] = idx;
  }
}

}  // namespace

// Plain C entry points for ctypes.  Pointers are device pointers; `lim` has
// n_tiles * 256 entries (-1 past R), exclude may be null; the walk's
// `records` are f32[n_fine_tiles * block_tris, 12], 16-byte aligned, and
// `order` a permutation of the n_tiles ray tiles.  Each launches on
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
                        const float* records, const float* aabbs,
                        const int* visits, int stride, int group,
                        int block_tris, int any_hit, const long long* order,
                        float* t_out, int* idx_out, void* stream) {
  if (n_tiles <= 0) return 0;
  if (block_tris <= 0 || block_tris > kMaxTile) return cudaErrorInvalidValue;
  if (reinterpret_cast<size_t>(records) % 16 != 0)
    return cudaErrorMisalignedAddress;
  const size_t smem =
      static_cast<size_t>(kStages) * block_tris * kRecord * sizeof(float4);
  // the largest ring (48 KB at block_tris 256) with the static arrays is
  // above the 48 KB a block gets without asking
  const cudaError_t err = cudaFuncSetAttribute(
      walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kStages * kMaxTile * kRecord * sizeof(float4)));
  if (err != cudaSuccess) return static_cast<int>(err);
  walk_kernel<<<n_tiles, kRays, smem, static_cast<cudaStream_t>(stream)>>>(
      o, d, lim, exclude, R, reinterpret_cast<const float4*>(records), aabbs,
      visits, stride, group, block_tris, any_hit, order, t_out, idx_out);
  return static_cast<int>(cudaGetLastError());
}
