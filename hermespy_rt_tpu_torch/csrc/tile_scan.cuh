// What the nearest-hit kernels of a block of 256 rays share: the visit-list
// walk (walk.cu) and the brute and culled scans (intersect.cu).
//
// - The live rays of the block are packed once, by ballot and prefix count,
//   into shared memory (LiveRays): (o, lim) and (d, exclude) per live ray,
//   and its running best hit as one packed 64-bit key,
//   (float bits of t) << 32 | idx.  An accepted t is positive and finite,
//   so its bits order as unsigned integers, and the index in the low word
//   breaks ties to the lower index: the least key is the (t, idx)
//   lexicographic minimum, which does not depend on the order in which the
//   hits are folded in.
// - Triangle tiles are staged as 48-byte records (v0, 0 | e1, 0 | e2, 0;
//   ops/walk.py::triangle_records) by one bulk copy each (cp.async.bulk)
//   into a ring of shared-memory buffers, each completed on its own
//   mbarrier, so that a tile is read as three 16-byte loads a triangle.
// - A staged tile's (live ray, triangle) pairs are dealt over the block's
//   8 warps (Deal, eval_tile): live rays in groups of Lw (32, or the next
//   power of two >= L below 32) to the lanes of a warp, 32 / Lw lanes per
//   ray taking every (32 / Lw)-th triangle; the tile is cut into
//   8 / gcd(G, 8) slices for the G groups, so the (group, slice) tasks are
//   a multiple of the 8 warps and every warp takes as many.  With 256 live
//   rays that is one ray a thread over the whole tile; one live ray spreads
//   its tile over the block.  Each lane keeps the least (t, idx) of its
//   triangles (ascending index, strict <) and folds it into its ray's key
//   with one shared-memory atomicMin.
#pragma once

#include <math_constants.h>

#include "mt.cuh"

namespace {

constexpr int kRays = 256;       // rays a block: one per thread
constexpr int kWarps = kRays / 32;
constexpr int kRecord = 3;       // float4s a triangle record
constexpr int kNoHit = 0x7fffffff;
constexpr unsigned long long kNoHitKey =
    (static_cast<unsigned long long>(0x7f800000u) << 32) | kNoHit;

static_assert(kWarps == 8, "the slices of a tile are dealt over 8 warps");

// A block's live rays, packed.
struct LiveRays {
  float4 ray[kRays][2];            // (o, lim) (d, exclude as int bits)
  unsigned long long best[kRays];  // packed (t, idx), kNoHitKey before a hit
  int count[kWarps];               // live rays a warp, for the prefix
};

__device__ __forceinline__ float hit_t(unsigned long long key) {
  return __uint_as_float(static_cast<unsigned>(key >> 32));
}

// First half of the packing: each warp counts its live rays into s.count
// (LiveRays, or any block's record of rays with an int count[kWarps]).  A
// barrier must follow before pack_slot.
template <class Rays>
__device__ __forceinline__ unsigned pack_count(Rays& s, bool live) {
  const unsigned ballot = __ballot_sync(0xffffffffu, live);
  if ((threadIdx.x & 31) == 0) s.count[threadIdx.x >> 5] = __popc(ballot);
  return ballot;
}

// Second half: this thread's slot among the live rays (meaningful where
// live) and their number L.
template <class Rays>
__device__ __forceinline__ int pack_slot(const Rays& s, unsigned ballot,
                                         int& L) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int pos = __popc(ballot & ((1u << lane) - 1u));
  L = 0;
  for (int w = 0; w < kWarps; ++w) {
    const int c = s.count[w];
    if (w < warp) pos += c;
    L += c;
  }
  return pos;
}

__device__ __forceinline__ void pack_ray(LiveRays& s, int pos, float ox,
                                         float oy, float oz, float lim,
                                         float dx, float dy, float dz,
                                         int exclude) {
  s.ray[pos][0] = make_float4(ox, oy, oz, lim);
  s.ray[pos][1] = make_float4(dx, dy, dz, __int_as_float(exclude));
  s.best[pos] = kNoHitKey;
}

// The deal of a staged tile's pairs over the block for L live rays.
struct Deal {
  int Lw, per_ray, slices, tasks, qi, sub;

  __device__ __forceinline__ explicit Deal(int L) {
    const int lane = threadIdx.x & 31;
    Lw = L >= 32 ? 32 : (L <= 1 ? 1 : 1 << (32 - __clz(L - 1)));
    per_ray = 32 / Lw;                              // lanes a ray
    const int groups = (L + Lw - 1) / Lw;
    slices = L > 0 ? kWarps >> min(__ffs(groups) - 1, 3) : 1;
    tasks = groups * slices;
    qi = lane & (Lw - 1);
    sub = lane / Lw;
  }
};

// Evaluate triangles [0, n) of the staged tile (global indices base + k)
// for each of the L packed live rays: the Möller–Trumbore step of mt.cuh,
// the ray's excluded triangle and t <= lim inside the test, each lane's
// least (t, idx) folded into the ray's key.  The caller puts a barrier
// between the packing (or the staging) and this, and after it before the
// keys are read or the tile's buffer is refilled.
__device__ __forceinline__ void eval_tile(LiveRays& s, const Deal& deal,
                                          int L, const float4* tile, int n,
                                          int base) {
  for (int task = threadIdx.x >> 5; task < deal.tasks; task += kWarps) {
    const int g = task / deal.slices, slice = task - g * deal.slices;
    const int q = g * deal.Lw + deal.qi;
    if (q >= L) continue;
    const float4 ro = s.ray[q][0], rd = s.ray[q][1];
    const int ex = __float_as_int(rd.w);
    const int k_end = (slice + 1) * n / deal.slices;
    float best = CUDART_INF_F;
    int best_k = 0;
    for (int k = slice * n / deal.slices + deal.sub; k < k_end;
         k += deal.per_ray) {
      const float4 p = tile[kRecord * k], e = tile[kRecord * k + 1],
                   f = tile[kRecord * k + 2];
      float t;
      if (hrt::mt_valid(ro.x, ro.y, ro.z, rd.x, rd.y, rd.z, p.x, p.y, p.z,
                        e.x, e.y, e.z, f.x, f.y, f.z, t) &&
          base + k != ex && t <= ro.w && t < best) {
        best = t;
        best_k = k;
      }
    }
    if (best < CUDART_INF_F)
      atomicMin(&s.best[q],
                (static_cast<unsigned long long>(__float_as_uint(best))
                 << 32) | static_cast<unsigned>(base + best_k));
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void barrier_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(1u)
               : "memory");
}

// Make the barriers' initialisation visible to the copy engine; once, by
// the thread that initialised them, before a barrier of the block.
__device__ __forceinline__ void barrier_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Wait until the phase of `bar` with the given parity has completed.
__device__ __forceinline__ void barrier_wait(unsigned long long* bar,
                                             unsigned parity) {
  const unsigned a = smem_addr(bar);
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// One bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from device memory into shared memory, completing a phase of `bar`.
__device__ __forceinline__ void tile_copy(float4* dst, const float4* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

}  // namespace
