// The table scatter-add for NVIDIA Hopper (sm_90a):
// out[k, col + j] += sum over rows r with idx[r] == k of g[r, j].
//
// Replaces hermespy_rt_tpu/ops/fetch_pallas.py::_bwd_kernel
// (pallas_scatter_add), and the in-kernel one-hot scatter contraction that
// ends each of the TPU's per-stage bounce backwards
// (ops/bounce_fused.py::_scatter_add_oht).  The TPU kernel contracts a
// one-hot of each ray tile with the tile's rows on the MXU, a sum in a fixed
// order.  Plain torch versions: hermespy_rt_tpu_torch/ops/fetch.py::
// scatter_add_plain, and ::scatter_add_ordered_plain (the dense route's
// grouping, bit for bit).
//
// The sums must come out the same in every run, so there are no float
// atomics, and the grouping of the adds does not depend on the card: the
// grid is a constant, and the warps of a block follow from (T, C) alone
// (ops/fetch.py::dense_plan, the same numbers).  Ids outside [0, T) (-1 for
// a dead ray) are dropped and their rows of g are not read.  g is read
// through its leading dimension ld_g, so a column window of a wider
// cotangent is read where it lies.  What bounds it is device memory: the
// ids once, the kept rows of g once, the table once, and the route's own
// traffic.
//
// Dense route (every table whose [T, C] f32 fits a warp's share of shared
// memory: the canyon's 256 triangles, the material tables).  Two launches
// and no sort, so its cost follows the kept rows, not a sort of all N.
//  1. scatter_add_kernel_partials: `blocks` blocks of `warps` warps.  The
//     rows are cut into groups of 32, dealt to the blocks in turn, then to
//     a block's warps in turn (group r to block r mod P, warp (r div P) mod
//     W): compacted rays put every kept row first, and a cut into
//     contiguous ranges left all of them to one or a few blocks.  Each warp
//     keeps a private [T, C] accumulator in shared memory, lanes on columns
//     (j on its own bank for C <= 32), and adds its groups' rows in row
//     order.  It loads the ids of kIdBatch groups at once, coalesced, the
//     next batch's while it adds this one's, and packs the batch's kept
//     rows, in row order, into packs of 32 (a ballot a group, then each
//     lane finds its entry by the popcounts): kept rows lie scattered
//     between dead rays, and a warp then waits on memory once a pack, not
//     once a group that keeps a row; dropped rows' g is never read.  A
//     pack's 32 rows are loaded at once, by predicated loads written as
//     PTX: written in C++, the compiler moved each load next to its add,
//     and every row waited on its own load.  The running sum of the current
//     key stays in a register while the key repeats (a large triangle takes
//     long runs of hits), the same adds in the same order as adding into
//     shared memory.  The block then sums its warps' copies in warp order
//     and writes one [T, C] partial.
//  2. scatter_add_kernel_sum: one thread per (k, j) sums the partials in
//     block order, every load in flight before the first add, and adds the
//     sum into out.
//  Its own traffic: blocks x T x C x 4 bytes of partials, written once and
//  read once (3.6 MB at 132 blocks on the canyon's 27 columns).
//
// Sorted route (larger tables: the config-5 city's 131,072 triangles).  The
// wrapper sorts the keys stably (torch.sort): equal keys become runs in ray
// order.  Runs are very uneven, so the work is cut by position, not by key.
// scatter_add_kernel_sorted cuts the sorted rows into chunks of `chunk`
// rows; one thread per (chunk, column) sums each run in its chunk in order.
// A run inside the chunk, touching neither end, has no other writer and is
// added to `out` at once.  The run at the chunk's start and the run at its
// end become the chunk's two boundary entries (key, partial sum), the second
// an empty (key, 0) when one run fills the chunk.  The boundary entries of
// all chunks are again sorted by key, each key's in ray order, so the same
// kernel sums them, level after level, until one chunk is left.  Each
// thread loads kBatch rows' keys and permutation entries, then their g (as
// the dense route, by loads written as PTX), before it adds them in row
// order; a chunk whose keys are all dropped reads only its two end keys.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 16;   // ops/fetch.py::SCATTER_MAX_WARPS
constexpr int kIdBatch = 8;     // groups of 32 ids a warp loads at once
constexpr int kSumThreads = 128;
constexpr int kSumBatch = 132;  // partials a thread of the sum keeps in
                                // flight: all (ops/fetch.py::SCATTER_BLOCKS)

// *p where `pred`, else +0.0 (-1 for an id): one predicated load, written
// as PTX so that the compiler issues it where it stands (a load written in
// C++ was moved next to its first use, which left each row waiting on its
// own load).  The rows of g are read once: a streaming load.
__device__ __forceinline__ float load_if(const float* p, bool pred) {
  float v;
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.u32 p, %2, 0;\n\t"
      "mov.f32 %0, 0f00000000;\n\t@p ld.global.cs.f32 %0, [%1];\n\t}"
      : "=f"(v)
      : "l"(p), "r"(static_cast<unsigned>(pred)));
  return v;
}

__device__ __forceinline__ int load_id_if(const int* p, bool pred) {
  int k;
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.u32 p, %2, 0;\n\t"
      "mov.b32 %0, -1;\n\t@p ld.global.nc.b32 %0, [%1];\n\t}"
      : "=r"(k)
      : "l"(p), "r"(static_cast<unsigned>(pred)));
  return k;
}

// The rows of this warp's groups (group i is group first + i stride of the
// call, rows 32 (first + i stride) ...) and the columns it reads.
struct Rows {
  const float* g;
  int64_t ld_g, first, stride;
  int lane, T;
  bool col_lane;

  __device__ __forceinline__ bool kept(int k) const {
    return static_cast<unsigned>(k) < static_cast<unsigned>(T);
  }

  // The row of entry `bit` of group i.
  __device__ __forceinline__ int64_t row(int i, int bit) const {
    return (first + i * stride) * 32 + bit;
  }
};

// The position of the n-th (from 0) set bit of `mask`: the largest p with
// fewer than n + 1 set bits below it.
__device__ __forceinline__ int nth_bit(unsigned mask, int n) {
  int pos = 0;
#pragma unroll
  for (int step = 16; step > 0; step >>= 1)
    if (__popc(mask & ((1u << (pos + step)) - 1u)) <= n) pos += step;
  return pos;
}

// Adds a pack's rows (`live`: the lanes that hold one) in row order into the
// warp's accumulator `mine`.
// The running sum of the current key `cur` stays in `run` while the key
// repeats, and goes back to shared memory where a run of another key starts:
// the same adds in the same order as adding each row into shared memory.  A
// dead row takes the key of the live row before it (or `cur`), so it starts
// no run and adds its +0.0, which changes no bit (a sum from +0.0 is never
// -0.0).  The starts are one ballot, so a row costs one add unless it starts
// a run.
__device__ __forceinline__ void add_pack(const float (&v)[32], int k,
                                          unsigned live, float* mine, int C,
                                          int lane, bool col_lane, int& cur,
                                          float& run) {
  const unsigned upto = live & (kFull >> (31 - lane));   // live lanes <= lane
  const int from = __shfl_sync(kFull, k, upto ? 31 - __clz(upto) : 0);
  const int key = upto ? from : cur;
  const int before = __shfl_up_sync(kFull, key, 1);
  const unsigned starts =
      __ballot_sync(kFull, key != (lane == 0 ? cur : before));
#pragma unroll
  for (int u = 0; u < 32; ++u) {
    if ((starts >> u) & 1u) {   // warp-uniform
      const int ku = __shfl_sync(kFull, key, u);
      if (cur >= 0 && col_lane) mine[cur * C + lane] = run;
      cur = ku;
      run = col_lane ? mine[ku * C + lane] : 0.0f;
    }
    run += v[u];
  }
}

__global__ void __launch_bounds__(kMaxWarps * 32, 1)
    scatter_add_kernel_partials(const int* __restrict__ idx,
                                const float* __restrict__ g, int64_t ld_g,
                                int N, int C, int T,
                                float* __restrict__ partials) {
  extern __shared__ float4 smem4[];
  float* acc = reinterpret_cast<float*>(smem4);
  const int warps = blockDim.x >> 5;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tc = T * C;
  const int n_acc = warps * tc;
  for (int i = threadIdx.x; i < n_acc / 4; i += blockDim.x)
    smem4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int i = (n_acc / 4) * 4 + threadIdx.x; i < n_acc; i += blockDim.x)
    acc[i] = 0.0f;
  __syncthreads();

  // group r of 32 rows goes to block r mod P, then warp (r div P) mod W, so
  // the kept rows are spread over every warp wherever they lie (compacted
  // rays put them first); a warp takes its groups in row order
  const int64_t n_groups = (static_cast<int64_t>(N) + 31) / 32;
  const Rows rows{g, ld_g, blockIdx.x + static_cast<int64_t>(gridDim.x) * w,
                  static_cast<int64_t>(gridDim.x) * warps, lane, T,
                  lane < C};
  const int n_i = rows.first < n_groups ? static_cast<int>(
      (n_groups - rows.first + rows.stride - 1) / rows.stride) : 0;
  auto id_of = [&](int i) {
    const int64_t r = (rows.first + i * rows.stride) * 32 + lane;
    return load_id_if(idx + r, i < n_i && r < N);
  };
  float* mine = acc + w * tc;
  int cur = -1;       // the key whose running sum is in `run` (warp-uniform)
  float run = 0.0f;
  // ids kIdBatch groups at a time, the next batch's in flight while this
  // one is added.  The kept rows of a batch are packed, in row order, into
  // packs of 32: kept rows are scattered (dead rays lie between them), and
  // a warp waits on memory once a pack, not once a group that keeps a row.
  // A pack's rows of g are loaded at once, then added.
  int ks[kIdBatch], kn[kIdBatch];
#pragma unroll
  for (int q = 0; q < kIdBatch; ++q) ks[q] = id_of(q);
  for (int i0 = 0; i0 < n_i; i0 += kIdBatch) {
#pragma unroll
    for (int q = 0; q < kIdBatch; ++q) kn[q] = id_of(i0 + kIdBatch + q);
    unsigned m[kIdBatch];
    int pre[kIdBatch + 1];   // kept rows in the groups before group q
    pre[0] = 0;
#pragma unroll
    for (int q = 0; q < kIdBatch; ++q) {
      m[q] = __ballot_sync(kFull, rows.kept(ks[q]));
      pre[q + 1] = pre[q] + __popc(m[q]);
    }
    for (int p0 = 0; p0 < pre[kIdBatch]; p0 += 32) {   // warp-uniform
      // this lane's entry of the pack: the r-th kept row of the batch
      const int r = p0 + lane;
      int q_r = 0;
#pragma unroll
      for (int q = 1; q < kIdBatch; ++q) q_r += r >= pre[q];
      unsigned m_r = m[0];
      int pre_r = 0;
#pragma unroll
      for (int q = 1; q < kIdBatch; ++q)
        if (q_r == q) {
          m_r = m[q];
          pre_r = pre[q];
        }
      const int bit = nth_bit(m_r, r - pre_r);
      int key = -1;
#pragma unroll
      for (int q = 0; q < kIdBatch; ++q) {
        const int k_q = __shfl_sync(kFull, ks[q], bit);
        if (q_r == q) key = k_q;
      }
      const int n_pack = min(32, pre[kIdBatch] - p0);
      const unsigned live = n_pack == 32 ? kFull : (1u << n_pack) - 1u;
      // a pack that is one whole group (every row kept) is read from the
      // group's own rows, without a shuffle before each load
      const int q_0 = __shfl_sync(kFull, q_r, 0);
      float v[32];
      if (n_pack == 32 && __shfl_sync(kFull, bit, 0) == 0 &&
          __shfl_sync(kFull, q_r, 31) == q_0) {
        const float* at = rows.g + rows.row(i0 + q_0, 0) * rows.ld_g + lane;
#pragma unroll
        for (int u = 0; u < 32; ++u)
          v[u] = load_if(at + u * rows.ld_g, rows.col_lane);
      } else {
        const long long at = rows.row(i0 + q_r, bit) * rows.ld_g;
#pragma unroll
        for (int u = 0; u < 32; ++u)
          v[u] = load_if(rows.g + __shfl_sync(kFull, at, u) + lane,
                         rows.col_lane && u < n_pack);
      }
      add_pack(v, r < pre[kIdBatch] ? key : -1, live, mine, C, lane,
               rows.col_lane, cur, run);
    }
#pragma unroll
    for (int q = 0; q < kIdBatch; ++q) ks[q] = kn[q];
  }
  if (cur >= 0 && rows.col_lane) mine[cur * C + lane] = run;
  __syncthreads();

  float* part = partials + static_cast<size_t>(blockIdx.x) * tc;
  for (int i = threadIdx.x; i < tc; i += blockDim.x) {
    float s = 0.0f;
    for (int q = 0; q < warps; ++q) s += acc[q * tc + i];
    part[i] = s;
  }
}

__global__ void __launch_bounds__(kSumThreads, 1) scatter_add_kernel_sum(
    const float* __restrict__ partials, int blocks, int tc, int C,
    float* __restrict__ out, int ldo, int col) {
  const int i = blockIdx.x * kSumThreads + threadIdx.x;
  if (i >= tc) return;
  float s = 0.0f;
  for (int b0 = 0; b0 < blocks; b0 += kSumBatch) {
    // every load issued before the first add (unconditional loads: past
    // the last block, the last block's partial again, not added)
    float v[kSumBatch];
#pragma unroll
    for (int u = 0; u < kSumBatch; ++u)
      v[u] = __ldg(partials +
                   static_cast<size_t>(min(b0 + u, blocks - 1)) * tc + i);
#pragma unroll
    for (int u = 0; u < kSumBatch; ++u)
      if (b0 + u < blocks) s += v[u];
  }
  const int k = i / C;
  out[static_cast<size_t>(k) * ldo + col + (i - k * C)] += s;
}

constexpr int kThreads = 256;
constexpr int kBatch = 16;   // rows whose loads a thread keeps in flight

struct Level {
  const int* keys;           // [N], sorted
  const int64_t* perm;       // [N] rows of g in sorted order, or null: g is
  const float* g;            // [N, ldg] (in sorted order when perm is null)
  int64_t ldg;
  int N, C, chunk;
  float* out;                // [T, ldo]
  int T, ldo, col;
  int* next_keys;            // [2 n_chunks] boundary entries, or null on
  float* next_g;             // [2 n_chunks, C] the last level
};

__device__ __forceinline__ void add_out(const Level& a, int key, int j,
                                        float v) {
  if (key >= 0 && key < a.T)
    a.out[static_cast<size_t>(key) * a.ldo + a.col + j] += v;
}

__global__ void __launch_bounds__(kThreads) scatter_add_kernel_sorted(
    Level a) {
  const int n_chunks = (a.N + a.chunk - 1) / a.chunk;
  const long t = static_cast<long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= static_cast<long>(n_chunks) * a.C) return;
  const int c = static_cast<int>(t / a.C), j = static_cast<int>(t % a.C);
  const int lo = c * a.chunk;
  const int hi = min(a.N, lo + a.chunk);
  const int k0 = a.keys[lo];
  const int k_last = a.keys[hi - 1];
  // a chunk whose keys are all dropped (the sort puts them at the ends)
  // reads no more: its boundary entries are (k0, 0) and (k_last, 0)
  const bool dropped = k_last < 0 || k0 >= a.T;
  int key = dropped ? k_last : k0;
  float acc = 0.0f, head = 0.0f;
  bool first = true;
  for (int b = lo; b < hi && !dropped; b += kBatch) {
    int ks[kBatch];
    int64_t rows[kBatch];
    float vs[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = min(b + u, hi - 1);  // past the end: read, not added
      ks[u] = a.keys[i];
      rows[u] = a.perm != nullptr ? a.perm[i] : i;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)  // a dropped row: its g is not read
      vs[u] = load_if(a.g + rows[u] * a.ldg + j, ks[u] >= 0 && ks[u] < a.T);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (b + u >= hi) break;
      const int k = ks[u];
      if (k != key) {
        if (first)
          head = acc;
        else
          add_out(a, key, j, acc);  // a run inside the chunk
        first = false;
        key = k;
        acc = 0.0f;
      }
      if (k >= 0 && k < a.T) acc += vs[u];
    }
  }
  if (first) head = acc;  // one run fills the chunk
  if (a.next_keys == nullptr) {
    add_out(a, k0, j, head);
    if (!first) add_out(a, key, j, acc);
    return;
  }
  a.next_g[(2 * static_cast<size_t>(c)) * a.C + j] = head;
  a.next_g[(2 * static_cast<size_t>(c) + 1) * a.C + j] = first ? 0.0f : acc;
  if (j == 0) {
    a.next_keys[2 * c] = k0;
    a.next_keys[2 * c + 1] = key;
  }
}

}  // namespace

// Plain C entry points for ctypes.  Each launches on `stream` and returns the
// first nonzero cudaError (cudaGetLastError() after each launch).

// The shared memory a block may opt in to on `device`, in `*bytes`.
extern "C" int hrt_smem_optin(int device, int* bytes) {
  return static_cast<int>(cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
}

// The dense route (ops/fetch.py::dense_plan): `partials` holds blocks x T x
// C floats.
extern "C" int hrt_scatter_add_dense(const int* idx, const float* g,
                                     long long ld_g, int N, int C, int T,
                                     int blocks, int warps, float* partials,
                                     float* out, int ldo, int col,
                                     void* stream) {
  if (N <= 0 || C <= 0 || T <= 0) return 0;
  if (C > 32 || warps < 1 || warps > kMaxWarps || blocks < 1 || ld_g < C ||
      col < 0 || col + C > ldo)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(warps) * T * C * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        scatter_add_kernel_partials,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  scatter_add_kernel_partials<<<blocks, warps * 32, smem, s>>>(
      idx, g, ld_g, N, C, T, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tc = T * C;
  scatter_add_kernel_sum<<<(tc + kSumThreads - 1) / kSumThreads, kSumThreads,
                           0, s>>>(partials, blocks, tc, C, out, ldo, col);
  return static_cast<int>(cudaGetLastError());
}

// The sorted route: every level on `stream`.  `scratch_g` holds 2 x 2
// ceil(N / chunk) C floats and `scratch_keys` 2 x 2 ceil(N / chunk) ints (the
// boundary entries of two levels in turn).
extern "C" int hrt_scatter_add_sorted(const int* keys, const int64_t* perm,
                                      const float* g, long long ld_g, int N,
                                      int C, int chunk, float* out, int T,
                                      int ldo, int col, float* scratch_g,
                                      int* scratch_keys, void* stream) {
  if (N <= 0 || C <= 0) return 0;
  if (chunk < 4 || ld_g < C || col < 0 || col + C > ldo)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t half = 2 * static_cast<size_t>((N + chunk - 1) / chunk);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Level a{keys, perm, g, ld_g, N, C, chunk, out, T, ldo, col, nullptr,
          nullptr};
  for (int level = 0;; ++level) {
    const int n_chunks = (a.N + a.chunk - 1) / a.chunk;
    const bool last = n_chunks == 1;
    a.next_keys = last ? nullptr : scratch_keys + (level % 2) * half;
    a.next_g = last ? nullptr : scratch_g + (level % 2) * half * C;
    const long threads = static_cast<long>(n_chunks) * C;
    scatter_add_kernel_sorted<<<static_cast<int>((threads + kThreads - 1) /
                                                 kThreads),
                                kThreads, 0, s>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || last) return static_cast<int>(err);
    a.keys = a.next_keys;
    a.perm = nullptr;
    a.g = a.next_g;
    a.ldg = C;
    a.N = 2 * n_chunks;
  }
}
