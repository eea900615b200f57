// The table scatter-add for NVIDIA Hopper (sm_90a):
// out[k, col + j] += sum over rows i with key[i] == k of g[i, j].
//
// Replaces hermespy_rt_tpu/ops/fetch_pallas.py::_bwd_kernel
// (pallas_scatter_add), and the in-kernel one-hot scatter contraction that
// ends each of the TPU's per-stage bounce backwards
// (ops/bounce_fused.py::_scatter_add_oht).  Plain torch version:
// hermespy_rt_tpu_torch/ops/fetch.py::scatter_add_plain.
//
// The sums must come out the same in every run, so there are no atomics.
// The wrapper sorts the keys stably (torch.sort): equal keys become runs in
// ray order.  Runs are very uneven (a large triangle takes a large share of
// the hits, a run of 10^5 rows is common), so the work is cut by position,
// not by key.  scatter_add_kernel cuts the sorted rows into chunks of
// `chunk` rows; one thread per (chunk, column) sums each run in its chunk in
// order.  A run that lies inside the chunk without touching either end has
// no other writer and is added to `out` at once.  The run at the chunk's
// start and the run at its end become the chunk's two boundary entries
// (key, partial sum), the second an empty (key, 0) when one run fills the
// chunk.  The boundary entries of all chunks are again sorted by key, with
// each key's entries in ray order, so the same kernel sums them, level after
// level, 2 entries per `chunk` rows, until one chunk is left, whose runs it
// writes.  Every key's sum is thus its rows' sum in ray order, in a fixed
// grouping, written by one thread, and no thread walks a long run alone.
// Keys outside [0, T) (-1 for a dead ray) are dropped, their rows of g not
// read.  What bounds it is device memory: each kept row of g is read once
// (C consecutive floats, read by C neighbouring threads), the sorted keys
// and permutation once per column thread (through L1), each table row
// written once; the levels after the first move 2 / chunk of the first's
// bytes.  A chunk's sum is one chain of adds; were each row loaded as it is
// added, a thread would wait a memory latency per row (key, then
// permutation, then g).  So each thread loads kBatch rows' keys and
// permutation entries, then their g, before it adds them in row order.
// Most rows of a late bounce are dead rays, so a chunk whose keys are all
// dropped reads only its two end keys.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBatch = 16;   // rows whose loads a thread keeps in flight

struct Level {
  const int* keys;           // [N], sorted
  const int64_t* perm;       // [N] rows of g in sorted order, or null: g is
  const float* g;            // [N, C] (in sorted order when perm is null)
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

__global__ void __launch_bounds__(kThreads) scatter_add_kernel(Level a) {
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
      vs[u] = ks[u] >= 0 && ks[u] < a.T ? a.g[rows[u] * a.C + j] : 0.0f;
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

// Plain C entry point for ctypes: every level on `stream`; returns
// cudaGetLastError() after the launches.  `scratch_g` holds 2 x 2 ceil(N /
// chunk) C floats and `scratch_keys` 2 x 2 ceil(N / chunk) ints (the
// boundary entries of two levels in turn).
extern "C" int hrt_scatter_add(const int* keys, const int64_t* perm,
                               const float* g, int N, int C, int chunk,
                               float* out, int T, int ldo, int col,
                               float* scratch_g, int* scratch_keys,
                               void* stream) {
  if (N <= 0 || C <= 0) return 0;
  if (chunk < 4 || col < 0 || col + C > ldo)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t half = 2 * static_cast<size_t>((N + chunk - 1) / chunk);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Level a{keys, perm, g, N, C, chunk, out, T, ldo, col, nullptr, nullptr};
  for (int level = 0;; ++level) {
    const int n_chunks = (a.N + a.chunk - 1) / a.chunk;
    const bool last = n_chunks == 1;
    a.next_keys = last ? nullptr : scratch_keys + (level % 2) * half;
    a.next_g = last ? nullptr : scratch_g + (level % 2) * half * C;
    const long threads = static_cast<long>(n_chunks) * C;
    scatter_add_kernel<<<static_cast<int>((threads + kThreads - 1) /
                                          kThreads),
                         kThreads, 0, s>>>(a);
    if (last) break;
    a.keys = a.next_keys;
    a.perm = nullptr;
    a.g = a.next_g;
    a.N = 2 * n_chunks;
  }
  return static_cast<int>(cudaGetLastError());
}
