// The brute and culled Möller–Trumbore nearest hit for NVIDIA Hopper
// (sm_90a).
//
// nearest_hit_kernel replaces hermespy_rt_tpu/ops/intersect_pallas.py::
// _kernel (all rays) and ::_kernel_flags (rays with a liveness mask, dead
// ray tiles skipped); nearest_hit_culled_kernel replaces ::_kernel_culled
// (the same scan, skipping per block of rays the triangle tiles whose box
// none of its rays reaches).  The TPU kernels rewrite Möller–Trumbore as
// triple-product matmuls over a centred scene to use the matrix unit; these
// compute the classic form in f32 by mt.cuh's step, which rounds every
// product, sum and the division on its own, exactly as the plain torch
// version (hermespy_rt_tpu_torch/ops/intersect.py::intersect_torch) rounds
// them, so the two make the same decisions and give the same bits.
//
// Contract per ray r < R: the triangle k < T with the smallest valid t,
// where valid means |det| >= FLT_EPS, -eps <= u <= 1+eps, v >= -eps,
// u+v <= 1+eps, eps < t < 1e9, k != exclude[r] and t <= lim[r]; ties go to
// the lower k.  lim[r] is t_max (per ray, or the scalar; 1e9 when none is
// given) for a live ray, -1 for a dead one.  Output t[r] (+inf on a miss)
// and idx[r] (-1 on a miss).  The plain version applies t_max after the
// search; testing t <= lim inside it gives the same decisions, since the
// nearest hit is within t_max exactly when some hit is, and a dead ray (or
// a limit below 0 or NaN) can keep no hit (an accepted t is > eps > 0).
// The culled kernel's skips change no decision but for a hit accepted a
// hair outside its triangle (u, v >= -eps) beyond its tile's exact box, as
// for the walk (ops/walk.py), and follow the plain version's
// (ops/walk.py::culled_reach_plain) bit for bit.
//
// What bounds them: f32 work, 47 operations (46 mul/add/sub, one division)
// per (live ray, triangle) pair, the culled kernel's only in the tiles its
// block reaches, plus one slab test (26) per (live ray, tile).  Built with
// -fmad=false, no product folds into an add, so at most half the 67 TFLOP/s
// f32 peak is reachable: the kernels are issue-bound.  The triangles
// (T x 48 bytes, 96 KB at 2,048) stay in the 50 MB L2.
//
// The design, on the walk's machinery (walk.cu points 1-4, here through
// tile_scan.cuh and mt.cuh), and why each part keeps the plain version's
// bits:
//
// 1. Dead rays cost nothing.  A block of 256 rays packs its live rays
//    (live[r] set, r < R and lim >= 0) once, by ballot and prefix count,
//    into shared memory with their o, d, exclude and lim.  A block with no
//    live ray writes misses and returns.  A dead ray keeps no hit (above),
//    so leaving it out changes no answer, and in the culled kernel its
//    slab test could never reach (limit <= lim < 0): leaving it out
//    changes no skip either.
// 2. A staged tile's (live ray, triangle) pairs are dealt over the block's
//    8 warps: with 256 live rays one ray a thread over the whole tile, as
//    before; with one (the LoS query) the tile spreads over the block.  Each
//    lane keeps the least (t, idx) of its triangles and folds it into its
//    ray's by a 64-bit atomicMin on (float bits of t) << 32 | idx in shared
//    memory: the lexicographic minimum, the same in every run whatever the
//    order of the folds, and the plain version's (the first index of the
//    least t).
// 3. Triangles are read as 48-byte records (v0, 0 | e1, 0 | e2, 0;
//    ops/walk.py::triangle_records, built once per scene by the caller),
//    three 16-byte shared-memory loads a pair for nine 4-byte ones before.
//    One thread stages each tile by one bulk copy (cp.async.bulk) into a
//    ring of buffers, each completed on its mbarrier: the brute kernel
//    tiles of 256 triangles in 2 buffers (the next tile lands while this one
//    is evaluated), the culled kernel tiles of 64 in 8 (7 listed tiles
//    ahead, whether or not they will be reached).  Static shared memory:
//    24 KB of ring and 10 KB of packed rays a block, so by shared memory 6
//    blocks fit on an SM; the registers decide (see the build's -Xptxas
//    -v: at 64 registers, 4 blocks, 32 warps an SM).  The whole scene is
//    not staged at once, though 4,095 triangles would fit in 192 KB: that
//    would leave one block, 8 warps, an SM to an issue-bound loop.
// 4. A pair stops at its first failed test (mt.cuh::mt_valid: the plain
//    version's operations in its order, cut after det, after a
//    division-free bound on u that rejects most pairs before the IEEE
//    division, after u and after v; what is skipped cannot make the pair
//    valid, see mt.cuh).
// 5. The culled kernel makes one block-wide decision a tile: every live ray
//    slab-tests the tile's exact box (slab.cuh; ops/walk.py::tile_aabbs,
//    tiles of 64 triangles) within limit = min(best t, lim), on the best
//    after the previous tile's evaluation, and the block evaluates the tile
//    when any of them reaches it (__syncthreads_or, the TPU kernel's
//    pl.when(any(reach))).  Tiles go in ascending order over blocks of 256
//    consecutive rays, as the plain version's, so the skips are its own.
//    Thread q tests packed ray q (which ray a thread tests changes no OR),
//    so only the warps of live rays run the slab test, and the box of the
//    next tile is loaded while this one is tested.  The skipped (block,
//    tile) pairs are counted (one atomic add a block) so that a check can
//    hold them to the plain version's.
// 6. Few rays spread over more blocks (brute kernel only).  A block takes
//    block_rays <= 256 rays (threads past them are dead rays), halved by
//    the wrapper from 256 while the grid would hold fewer than 4 blocks an
//    SM, down to 32: the 16,384-ray query on a 14,336-triangle city then
//    runs 512 blocks of 32 rays, not 64 blocks that leave half the SMs
//    idle and the rest at 8 warps each.  A ray's answer does not depend on
//    its block.  The culled kernel keeps blocks of 256 rays: its skips are
//    decided per block of 256, as the plain version's.
//
// A query is one launch: the wrapper adds no torch operation before it and
// reads nothing back.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "slab.cuh"
#include "tile_scan.cuh"

namespace {

constexpr int kScanTile = 256;   // triangles a tile of the brute kernel
constexpr int kScanStages = 2;
constexpr int kCullTile = 64;    // triangles a tile of the culled kernel
constexpr int kCullStages = 8;

// The scan of one block of rays over every tile of kTile triangles (see the
// note at the top); kCull adds the per-tile reach test.
template <int kTile, int kStages, bool kCull>
__device__ __forceinline__ void scan(
    const float* __restrict__ o, const float* __restrict__ d,
    const float4* __restrict__ records, int R, int T, int block_rays,
    const float* __restrict__ aabbs, const int* __restrict__ exclude,
    const float* __restrict__ t_max, float t_max_scalar,
    const unsigned char* __restrict__ live, float* __restrict__ t_out,
    int* __restrict__ idx_out, unsigned long long* __restrict__ skipped) {
  constexpr int kTileFloats = kTile * kRecord;    // float4s a tile
  __shared__ __align__(128) float4 s_tiles[kStages * kTileFloats];
  __shared__ LiveRays s_live;
  __shared__ unsigned long long s_bar[kStages];

  const int tid = threadIdx.x;
  const int r = blockIdx.x * block_rays + tid;
  const bool in_range = tid < block_rays && r < R;
  float l = -1.0f;
  if (in_range && (live == nullptr || live[r] != 0))
    l = t_max != nullptr ? t_max[r] : t_max_scalar;
  const bool alive = l >= 0.0f;      // false for a NaN limit too
  if (tid == 0) {
    for (int b = 0; b < kStages; ++b) barrier_init(&s_bar[b]);
    barrier_init_fence();
  }
  const unsigned ballot = pack_count(s_live, alive);
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  if (alive) {
    ox = o[3 * r]; oy = o[3 * r + 1]; oz = o[3 * r + 2];
    dx = d[3 * r]; dy = d[3 * r + 1]; dz = d[3 * r + 2];
  }
  __syncthreads();
  int L;
  const int pos = pack_slot(s_live, ballot, L);
  const int n_tiles = (T + kTile - 1) / kTile;
  if (L == 0) {                      // the block's decision: no live ray
    if (in_range) {
      t_out[r] = CUDART_INF_F;
      idx_out[r] = -1;
    }
    if (kCull && tid == 0 && skipped != nullptr)
      atomicAdd(skipped, static_cast<unsigned long long>(n_tiles));
    return;
  }
  if (alive)
    pack_ray(s_live, pos, ox, oy, oz, l, dx, dy, dz,
             exclude != nullptr ? exclude[r] : -1);

  // tile j of the scan in buffer j % kStages; bit b of `pending` marks a
  // copy into buffer b not yet waited for, bit b of `parity` the parity of
  // its phase (the same in every thread: every decision below is the
  // block's)
  auto copy = [&](int j) {
    const int n = min(kTile, T - j * kTile);
    tile_copy(s_tiles + (j % kStages) * kTileFloats,
              records + static_cast<size_t>(j) * kTileFloats,
              static_cast<unsigned>(n * kRecord) * 16u, &s_bar[j % kStages]);
  };
  unsigned pending = 0, parity = 0;
  for (int j = 0; j < n_tiles && j < kStages - 1; ++j) {
    if (tid == 0) copy(j);
    pending |= 1u << j;
  }
  __syncthreads();                   // the packed rays

  const Deal deal(L);
  // the culled kernel's reach test: thread q tests packed ray q < L, so
  // only the first ceil(L / 32) warps run it
  const bool tester = kCull && tid < L;
  float4 qo = make_float4(0.f, 0.f, 0.f, -1.f);
  float qix = 0.f, qiy = 0.f, qiz = 0.f, box[6];
  if constexpr (kCull) {
    if (tester) {
      qo = s_live.ray[tid][0];
      const float4 qd = s_live.ray[tid][1];
      qix = inverse(qd.x); qiy = inverse(qd.y); qiz = inverse(qd.z);
    }
#pragma unroll
    for (int a = 0; a < 6; ++a) box[a] = __ldg(aabbs + a);
  }
  int n_skipped = 0;
  for (int j = 0; j < n_tiles; ++j) {
    // refill: tile j + kStages - 1 into the buffer of tile j - 1, which
    // every thread has finished reading (the barriers of step j - 1)
    const int ahead = j + kStages - 1;
    if (ahead < n_tiles) {
      const unsigned b = ahead % kStages, bit = 1u << b;
      if (tid == 0) {
        if (pending & bit) barrier_wait(&s_bar[b], (parity & bit) != 0);
        copy(ahead);
      }
      if (pending & bit) parity ^= bit;
      pending |= bit;
    }
    if constexpr (kCull) {
      bool reach = false;
      if (tester) {
        float t_near, t_far;
        slab(qo.x, qo.y, qo.z, qix, qiy, qiz, box, t_near, t_far);
        reach = reaches(t_near, t_far, fminf(hit_t(s_live.best[tid]), qo.w));
      }
      if (j + 1 < n_tiles) {
#pragma unroll
        for (int a = 0; a < 6; ++a) box[a] = __ldg(aabbs + 6 * (j + 1) + a);
      }
      // the block's decision, on each ray's best after tile j - 1 (the
      // barrier after its evaluation)
      if (!__syncthreads_or(reach)) {
        ++n_skipped;
        continue;
      }
    }
    const unsigned b = j % kStages, bit = 1u << b;
    barrier_wait(&s_bar[b], (parity & bit) != 0);
    parity ^= bit;
    pending &= ~bit;
    eval_tile(s_live, deal, L, s_tiles + b * kTileFloats,
              min(kTile, T - j * kTile), j * kTile);
    __syncthreads();
  }
  // no copy may land in shared memory after the block has left it
  if (tid == 0)
    for (int b = 0; b < kStages; ++b)
      if (pending >> b & 1u) barrier_wait(&s_bar[b], parity >> b & 1u);
  if (in_range) {
    float t = CUDART_INF_F;
    int idx = -1;
    if (alive) {
      const unsigned long long key = s_live.best[pos];
      t = hit_t(key);
      if (t < CUDART_INF_F) idx = static_cast<int>(key & 0xffffffffu);
    }
    t_out[r] = t;
    idx_out[r] = idx;
  }
  if (kCull && tid == 0 && skipped != nullptr)
    atomicAdd(skipped, static_cast<unsigned long long>(n_skipped));
}

__global__ void __launch_bounds__(kRays) nearest_hit_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float4* __restrict__ records, int R, int T, int block_rays,
    const int* __restrict__ exclude, const float* __restrict__ t_max,
    float t_max_scalar, const unsigned char* __restrict__ live,
    float* __restrict__ t_out, int* __restrict__ idx_out) {
  scan<kScanTile, kScanStages, false>(o, d, records, R, T, block_rays,
                                      nullptr, exclude, t_max, t_max_scalar,
                                      live, t_out, idx_out, nullptr);
}

__global__ void __launch_bounds__(kRays) nearest_hit_culled_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float4* __restrict__ records, int R, int T,
    const float* __restrict__ aabbs, const int* __restrict__ exclude,
    const float* __restrict__ t_max, float t_max_scalar,
    const unsigned char* __restrict__ live, float* __restrict__ t_out,
    int* __restrict__ idx_out, unsigned long long* __restrict__ skipped) {
  scan<kCullTile, kCullStages, true>(o, d, records, R, T, kRays, aabbs,
                                     exclude, t_max, t_max_scalar, live,
                                     t_out, idx_out, skipped);
}

cudaError_t check_records(const float* records) {
  return reinterpret_cast<size_t>(records) % 16 != 0
             ? cudaErrorMisalignedAddress
             : cudaSuccess;
}

}  // namespace

// Plain C entry points for ctypes.  Pointers are device pointers: `records`
// f32[T, 12] (ops/walk.py::triangle_records), 16-byte aligned; exclude,
// t_max and live may be null (none / the scalar t_max_scalar for every ray,
// 1e9 for none / all live).  Each launches on `stream` and returns
// cudaGetLastError() of the launch.  The brute kernel takes `block_rays`
// (1-256) rays a block of 256 threads: a query of few rays spreads over
// more blocks (the wrapper picks it), which changes no ray's answer.
extern "C" int hrt_nearest_hit(const float* o, const float* d,
                               const float* records, int R, int T,
                               int block_rays, const int* exclude,
                               const float* t_max, float t_max_scalar,
                               const unsigned char* live, float* t_out,
                               int* idx_out, void* stream) {
  if (R <= 0) return 0;
  if (block_rays < 1 || block_rays > kRays) return cudaErrorInvalidValue;
  if (T > 0 && check_records(records) != cudaSuccess)
    return cudaErrorMisalignedAddress;
  const dim3 grid((R + block_rays - 1) / block_rays);
  nearest_hit_kernel<<<grid, kRays, 0, static_cast<cudaStream_t>(stream)>>>(
      o, d, reinterpret_cast<const float4*>(records), R, T, block_rays,
      exclude, t_max, t_max_scalar, live, t_out, idx_out);
  return static_cast<int>(cudaGetLastError());
}

// The culled kernel: `aabbs` holds ceil(T / 64) boxes (lo xyz, hi xyz);
// skipped may be null.
extern "C" int hrt_nearest_hit_culled(const float* o, const float* d,
                                      const float* records, int R, int T,
                                      const float* aabbs, const int* exclude,
                                      const float* t_max, float t_max_scalar,
                                      const unsigned char* live,
                                      float* t_out, int* idx_out,
                                      unsigned long long* skipped,
                                      void* stream) {
  if (R <= 0) return 0;
  if (T > 0 && check_records(records) != cudaSuccess)
    return cudaErrorMisalignedAddress;
  const dim3 grid((R + kRays - 1) / kRays);
  nearest_hit_culled_kernel<<<grid, kRays, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      o, d, reinterpret_cast<const float4*>(records), R, T, aabbs, exclude,
      t_max, t_max_scalar, live, t_out, idx_out, skipped);
  return static_cast<int>(cudaGetLastError());
}
