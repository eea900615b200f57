// The visit-list walk for large scenes on NVIDIA Hopper (sm_90a): a
// slab-test prepass and the walk itself.
//
// walk_prepass_kernel replaces hermespy_rt_tpu/ops/intersect_pallas.py::
// _prepass_kernel (reached through _prepass_reach_key_pallas and
// _walk_prepass), and the count and stable sort that _walk_prepass does
// after it in XLA.  Per ray tile of 256 rays it writes the tile's packed
// visit row, int32[1 + C]: the count of coarse boxes that any live ray of
// the tile reaches, then the reached boxes near to far by key, ties to the
// lower box, padded with the last reached box (box 0 when none): the rows
// of ops/walk.py::visit_rows(*prepass_plain(...)).  A box's key is the
// least max(t_near, 0) over the rays that reach it, with the TPU kernel's
// arithmetic per (ray, box): inv = 1 / (d == 0 ? 1e-30 : d),
// (plane - o) inv, NaN-propagating min/max per axis (slab.cuh), reach =
// t_far >= 0 & t_near <= t_far & t_near <= lim & lim >= 0.
// What bounds it: f32 work, 28 operations per (live ray, box) pair, none
// of them a fused multiply-add (subtractions, products, min/max, compares),
// ~1.5e10 for 2^20 live rays and 512 boxes: 0.224 ms at 67 TFLOP/s, 0.448
// at the half rate operations without FMA reach; most of them min/max and
// compares, which run on the half-width ALU pipe.  Its bytes (the rays
// once, the rows out) are a few MB.  The design:
//
// 1. One block a ray tile, and the block owns all C <= 512 boxes, so the
//    count and the sort need no second pass.
// 2. Only live rays are tested.  The block packs its live rays (lim >= 0)
//    once (tile_scan.cuh's pack_count / pack_slot) into shared memory as
//    two 16-byte records, (o, lim) and (inv, 0).  A tile with no live ray
//    writes its row (count 0, box 0) and returns.
// 3. Boxes that no ray of the tile can reach are pruned before any pair is
//    tested (box_pruned): from the tile's least and greatest o and inv over
//    its live rays, rounding being monotone, every ray's (plane - o) inv
//    lies between the least and greatest rounded corner product, which
//    bound every ray's t_near from below and t_far from above; a box whose
//    bounds rule out t_far >= 0, t_near <= t_far and t_near <= lim for
//    every ray is reached by none.  The prune only skips tests whose answer
//    is "not reached", so every reach and key keeps its bits.
// 4. The kept boxes, in box order, and their (live ray, box) pairs are
//    dealt over the block: each thread takes two kept boxes, so that each
//    ray's two shared-memory loads serve both, over every S-th live ray of
//    its slice, with S = 256 / ceil(kept / 2) slices so that a tile that
//    keeps few boxes still fills its block.  Per box and thread the running
//    key is min over its rays of (reach ? t_near : NaN) with fminf, which
//    passes over a NaN, so a box none of them reaches stays NaN and no
//    reach flag is kept; max(key, 0) is taken once at the end (max(., 0)
//    commutes with min), as +0.0 where t_near <= 0, and the threads' keys
//    of a box are folded by a shared-memory atomicMin on their float bits
//    (a key >= +0.0 orders as its bits do, and a minimum is the same in any
//    order).  The reach test is slab.cuh's slab and the reaches() decision
//    with lim >= 0 known: t_far >= 0 & t_near <= min(t_far, lim).
// 5. The reached boxes are compacted (ballot and prefix, in box order),
//    each packed as (float bits of key) << 32 | box.  A key is >= +0.0
//    (never -0.0) and never NaN, so the packed values order as (key, box)
//    do: ascending is the stable sort of the keys, and a box not reached
//    (which the plain version sorts after every reached one, at +inf) is
//    not in the list, unless a box is reached at key +inf (see there).  A bitonic sort over M, the power of two >= the count
//    and >= 32, orders them: by one warp's shuffles for M = 32, in 4 KB of
//    shared memory otherwise; the block writes its row with coalesced
//    stores.
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

constexpr int kMaxBoxes = 512;  // coarse boxes a row (ops/walk.py MAX_BOXES)
constexpr int kMaxTile = 256;   // largest fine tile the walk stages
constexpr int kBoxesPerThread = kMaxBoxes / kRays;
constexpr unsigned kUnreached = 0xffffffffu;  // a box key no ray set
constexpr int kBounds = 13;     // the tile's o lo/hi, inv lo/hi, max lim

// A prepass block's shared memory.
struct PrepassBlock {
  float4 ray[kRays][2];                 // live rays: (o, lim) (inv, 0)
  float box[6][kMaxBoxes];              // the boxes kept, in box order
  short list[kMaxBoxes];                // ... and their ids
  unsigned key[kMaxBoxes];              // float bits of each box's key
  unsigned long long sort[kMaxBoxes];   // (key bits) << 32 | box
  int bound[kBounds][kWarps];           // the warps' bounds (ordered())
  float tile[kBounds];                  // the tile's
  int count[kWarps];                    // live rays a warp (pack_count)
  int kept[kBoxesPerThread][kWarps];    // boxes kept (listed) a warp
  int reached[kBoxesPerThread][kWarps]; // boxes reached a warp
};

// A float as an int that orders as the float does (not NaN), and back.
__device__ __forceinline__ int ordered(float x) {
  const int i = __float_as_int(x);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float unordered(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

// This lane's slot in a block-wide list of the set ballot bits, in (warp,
// lane) order after `total` earlier entries, from the warps' counts `n`;
// adds the block's count to `total`.
__device__ __forceinline__ int list_slot(const int (&n)[kWarps],
                                         unsigned ballot, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int slot = total + __popc(ballot & ((1u << lane) - 1u));
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) slot += n[w];
    total += n[w];
  }
  return slot;
}

// Whether no ray of the tile can reach the box: bounds on every live ray's
// (plane - o) inv from the tile's o in [o_lo, o_hi] and inv in [i_lo, i_hi]
// (b: the tile's bounds, o_lo xyz, o_hi xyz, i_lo xyz, i_hi xyz, max lim).
// Rounding is monotone, so fl(plane - o) lies in [fl(plane - o_hi),
// fl(plane - o_lo)] and the rounded product within the least and greatest
// rounded corner product; then t_near >= NL and t_far <= FU for every ray,
// and a ray that reaches needs FU >= 0, NL <= FU and NL <= lim.  A NaN
// bound (a corner 0 x inf) fails every comparison: the box is kept.
__device__ __forceinline__ bool box_pruned(const float* __restrict__ b,
                                           const float* box) {
  float nl = 0.0f, fu = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float lb[2], ub[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float plane = box[a + 3 * h];
      const float d_lo = plane - b[3 + a], d_hi = plane - b[a];
      const float c0 = d_lo * b[6 + a], c1 = d_lo * b[9 + a],
                  c2 = d_hi * b[6 + a], c3 = d_hi * b[9 + a];
      lb[h] = min_nan(min_nan(c0, c1), min_nan(c2, c3));
      ub[h] = max_nan(max_nan(c0, c1), max_nan(c2, c3));
    }
    const float n_a = min_nan(lb[0], lb[1]), f_a = max_nan(ub[0], ub[1]);
    nl = a == 0 ? n_a : max_nan(nl, n_a);
    fu = a == 0 ? f_a : min_nan(fu, f_a);
  }
  return fu < 0.0f || nl > fu || nl > b[12];
}

__global__ void __launch_bounds__(kRays) walk_prepass_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ lim, int R, const float* __restrict__ boxes,
    int C, int* __restrict__ visits) {
  __shared__ PrepassBlock s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r = blockIdx.x * kRays + tid;
  const float l = lim[r];   // padded: -1 past R
  const bool live = r < R && l >= 0.0f;
  int* row = visits + static_cast<size_t>(blockIdx.x) * (1 + C);

  // the live rays, packed, and the tile's bounds over them
  float ray[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};  // o, inv
  if (live)
    for (int a = 0; a < 3; ++a) {
      ray[a] = o[3 * r + a];
      ray[3 + a] = inverse(d[3 * r + a]);
    }
  const unsigned ballot = pack_count(s, live);
#pragma unroll
  for (int j = 0; j < kBounds; ++j) {   // a warp's least or greatest
    const bool lo = j < 3 || (j >= 6 && j < 9);
    const int v = ordered(
        j == 12 ? (live ? l : -1.0f)
                : (live ? ray[j < 6 ? j % 3 : 3 + j % 3]
                        : (lo ? CUDART_INF_F : -CUDART_INF_F)));
    const int w = lo ? __reduce_min_sync(0xffffffffu, v)
                     : __reduce_max_sync(0xffffffffu, v);
    if (lane == 0) s.bound[j][warp] = w;
  }
  __syncthreads();
  int L;
  const int pos = pack_slot(s, ballot, L);
  if (L == 0) {   // the same in every thread
    for (int j = tid; j <= C; j += kRays) row[j] = 0;
    return;
  }
  if (live) {
    s.ray[pos][0] = make_float4(ray[0], ray[1], ray[2], l);
    s.ray[pos][1] = make_float4(ray[3], ray[4], ray[5], 0.0f);
  }
  if (tid < kBounds) {   // the tile's, over the warps
    const bool lo = tid < 3 || (tid >= 6 && tid < 9);
    int v = s.bound[tid][0];
    for (int w = 1; w < kWarps; ++w)
      v = lo ? min(v, s.bound[tid][w]) : max(v, s.bound[tid][w]);
    s.tile[tid] = unordered(v);
  }
  __syncthreads();
  float tile[kBounds];
#pragma unroll
  for (int j = 0; j < kBounds; ++j) tile[j] = s.tile[j];

  // the boxes no ray of the tile can reach are pruned; the rest are kept,
  // in box order
  float box[kBoxesPerThread][6];
  unsigned kept[kBoxesPerThread];
#pragma unroll
  for (int b = 0; b < kBoxesPerThread; ++b) {
    const int c = tid + b * kRays;
#pragma unroll
    for (int a = 0; a < 6; ++a) box[b][a] = c < C ? boxes[6 * c + a] : 0.0f;
    kept[b] = __ballot_sync(0xffffffffu, c < C && !box_pruned(tile, box[b]));
    if (lane == 0) s.kept[b][warp] = __popc(kept[b]);
    if (c < C) s.key[c] = kUnreached;
  }
  __syncthreads();
  int U = 0;
#pragma unroll
  for (int b = 0; b < kBoxesPerThread; ++b) {
    const int slot = list_slot(s.kept[b], kept[b], U);
    if (kept[b] >> lane & 1u) {
      s.list[slot] = static_cast<short>(tid + b * kRays);
#pragma unroll
      for (int a = 0; a < 6; ++a) s.box[a][slot] = box[b][a];
    }
  }
  __syncthreads();

  // the kept boxes' (live ray, box) pairs: each thread two kept boxes, u0
  // and u0 + P, over every S-th live ray from its slice
  if (U > 0) {
    const int P = (U + 1) / 2, S = max(1, kRays / P);
    const int u0 = tid % P, slice = tid / P, u1 = u0 + P;
    if (slice < S) {
      float bx[2][6], k_min[2] = {CUDART_NAN_F, CUDART_NAN_F};
#pragma unroll
      for (int a = 0; a < 6; ++a) {
        bx[0][a] = s.box[a][u0];
        bx[1][a] = s.box[a][u1 < U ? u1 : u0];
      }
#pragma unroll 4
      for (int q = slice; q < L; q += S) {
        const float4 ol = s.ray[q][0], iv = s.ray[q][1];
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          float t_near, t_far;
          slab(ol.x, ol.y, ol.z, iv.x, iv.y, iv.z, bx[b], t_near, t_far);
          // reaches(t_near, t_far, lim) for a live ray (lim >= 0, not NaN)
          const bool reach = t_far >= 0.0f && t_near <= min_nan(t_far, ol.w);
          k_min[b] = fminf(k_min[b], reach ? t_near : CUDART_NAN_F);
        }
      }
#pragma unroll
      for (int b = 0; b < 2; ++b)
        if (k_min[b] == k_min[b] && (b == 0 || u1 < U))
          atomicMin(&s.key[s.list[b == 0 ? u0 : u1]],
                    __float_as_uint(k_min[b] > 0.0f ? k_min[b] : 0.0f));
    }
  }
  __syncthreads();

  // the reached boxes, compacted in box order, then sorted by (key, box).
  // A box reached at key +inf (only under an infinite limit) ties with the
  // boxes not reached, which the plain version sorts at +inf too: then
  // every box is listed, and the row takes the first `count`.
  unsigned bits[kBoxesPerThread];
  bool inf_key = false;
#pragma unroll
  for (int b = 0; b < kBoxesPerThread; ++b) {
    const int c = tid + b * kRays;
    bits[b] = c < C ? s.key[c] : kUnreached;
    inf_key |= bits[b] == 0x7f800000u;
  }
  const bool all = __syncthreads_or(inf_key);
  unsigned listed[kBoxesPerThread];
#pragma unroll
  for (int b = 0; b < kBoxesPerThread; ++b) {
    const bool reached = bits[b] != kUnreached;
    listed[b] = __ballot_sync(0xffffffffu,
                              all ? tid + b * kRays < C : reached);
    const unsigned n_reached = __popc(__ballot_sync(0xffffffffu, reached));
    if (lane == 0) {
      s.kept[b][warp] = __popc(listed[b]);
      s.reached[b][warp] = n_reached;
    }
  }
  __syncthreads();
  int count = 0, n_list = 0;
#pragma unroll
  for (int b = 0; b < kBoxesPerThread; ++b) {
    const int slot = list_slot(s.kept[b], listed[b], n_list);
    for (int w = 0; w < kWarps; ++w) count += s.reached[b][w];
    if (listed[b] >> lane & 1u)
      s.sort[slot] = static_cast<unsigned long long>(
                         bits[b] != kUnreached ? bits[b] : 0x7f800000u) << 32 |
                     static_cast<unsigned>(tid + b * kRays);
  }
  if (count == 0) {   // the same in every thread
    for (int j = tid; j <= C; j += kRays) row[j] = 0;
    return;
  }
  int M = 32;         // the sort's width: a power of two >= n_list
  while (M < n_list) M <<= 1;
  for (int i = n_list + tid; i < M; i += kRays) s.sort[i] = ~0ull;
  __syncthreads();
  if (M == 32) {      // one warp, by shuffles
    if (warp == 0) {
      unsigned long long v = s.sort[lane];
      for (int k = 2; k <= 32; k <<= 1)
        for (int j = k >> 1; j > 0; j >>= 1) {
          const unsigned long long w = __shfl_xor_sync(0xffffffffu, v, j);
          v = (((lane & j) == 0) == ((lane & k) == 0)) ? min(v, w)
                                                       : max(v, w);
        }
      s.sort[lane] = v;
    }
    __syncthreads();
  } else {
    for (int k = 2; k <= M; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int i = tid; i < M / 2; i += kRays) {
          const int lo = 2 * i - (i & (j - 1)), hi = lo + j;
          const unsigned long long x = s.sort[lo], y = s.sort[hi];
          if ((x > y) == ((lo & k) == 0)) {
            s.sort[lo] = y;
            s.sort[hi] = x;
          }
        }
        __syncthreads();
      }
    }
  }
  const int last = static_cast<int>(s.sort[count - 1] & 0xffffffffu);
  if (tid == 0) row[0] = count;
  for (int j = tid; j < C; j += kRays)
    row[1 + j] = j < count ? static_cast<int>(s.sort[j] & 0xffffffffu) : last;
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
// n_tiles * 256 entries (-1 past R), exclude may be null; the prepass's
// `visits` are int32[n_tiles, 1 + C] for 1 <= C <= 512; the walk's
// `records` are f32[n_fine_tiles * block_tris, 12], 16-byte aligned, and
// `order` a permutation of the n_tiles ray tiles.  Each launches on
// `stream` and returns cudaGetLastError() of the launch.
extern "C" int hrt_walk_prepass(const float* o, const float* d,
                                const float* lim, int R, int n_tiles,
                                const float* boxes, int C, int* visits,
                                void* stream) {
  if (n_tiles <= 0) return 0;
  if (C <= 0 || C > kMaxBoxes) return cudaErrorInvalidValue;
  walk_prepass_kernel<<<n_tiles, kRays, 0,
                        static_cast<cudaStream_t>(stream)>>>(o, d, lim, R,
                                                             boxes, C,
                                                             visits);
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
