// The row fetch for NVIDIA Hopper (sm_90a):
// out[i, j] = table[idx[i], col + j] for j < C.
//
// Replaces hermespy_rt_tpu/ops/fetch_pallas.py::_fwd_kernel (reached through
// pallas_onehot_fetch and pallas_onehot_fetch_t).  The TPU kernel builds a
// one-hot of each ray tile's ids in VMEM and multiplies it with the table
// split into three bf16 limbs, so that the MXU sums the limbs of the chosen
// row exactly; a GPU loads the row.  Plain torch version:
// hermespy_rt_tpu_torch/ops/fetch.py::gather_plain.  The output keeps the
// [N, C] layout the tracer's fetch consumes (the TPU kernel writes [C, N],
// rays on lanes, which is the same bytes as XLA's [N, C]).
//
// An exact copy: no arithmetic, so the bits equal the plain version's.  Ids
// outside [0, T) give rows of zeros, as the TPU kernel's one-hot does.  What
// bounds it is device memory: the ids read once, the output written once
// (4 N C bytes, 113 MB for 2^20 ids of 27 columns) and the table rows that
// are hit read once.  So the design spends few instructions per output
// byte and writes wide:
// - one warp per group of 32 output rows (ops/fetch.py::gather_plan); lane
//   l loads the id of row l once, in one coalesced 128-byte load, and the
//   id of the warp's next group before it writes this one;
// - the group's 32 C floats (128 C bytes: whole 16-byte vectors, aligned
//   since the output's base is) are written as float4 stores; each vector's
//   row and column come from one 32-bit division, and each element's id by
//   __shfl_sync from the lane that loaded it;
// - the ragged last group (N mod 32 rows) is written one float a lane;
// - a table whose column window fits 48 KB (the canyon's 256 x 27 x 4 =
//   27.6 KB) is staged in shared memory once per block of a persistent
//   grid; a larger one (the city's 14 MB) is read with __ldg from L2.
// Offsets are 64-bit only where N C can pass 2^31: a group's base.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 512;            // ops/fetch.py::GATHER_THREADS
constexpr int kStageBytes = 48 * 1024;   // ops/fetch.py::GATHER_STAGE_BYTES

template <bool kStaged>
__device__ __forceinline__ float row_at(const float* tab, int ldt, int k,
                                        int j) {
  if (k < 0) return 0.0f;
  return kStaged ? tab[k * ldt + j]
                 : __ldg(tab + static_cast<int64_t>(k) * ldt + j);
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads) gather_kernel(
    const float* __restrict__ table, int T, int ld, int col, int C,
    const int* __restrict__ idx, int64_t full_groups, int tail,
    float* __restrict__ out) {
  extern __shared__ float stage[];
  const float* tab = table + col;
  int ldt = ld;
  if (kStaged) {
    for (int i = threadIdx.x; i < T * C; i += kThreads) {
      const int r = i / C;
      stage[i] = __ldg(table + static_cast<int64_t>(r) * ld + col +
                       (i - r * C));
    }
    __syncthreads();
    tab = stage;
    ldt = C;
  }
  const int lane = threadIdx.x & 31;
  const int64_t warp0 =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int64_t n_warps = (static_cast<int64_t>(gridDim.x) * kThreads) >> 5;
  const int vecs = 8 * C;  // float4 a group
  int k_next = warp0 < full_groups ? __ldg(idx + warp0 * 32 + lane) : -1;
  for (int64_t grp = warp0; grp < full_groups; grp += n_warps) {
    const int k = k_next;
    const int64_t nxt = grp + n_warps;
    k_next = nxt < full_groups ? __ldg(idx + nxt * 32 + lane) : -1;
    const int kv =
        static_cast<unsigned>(k) < static_cast<unsigned>(T) ? k : -1;
    float4* dst = reinterpret_cast<float4*>(out + grp * 32 * C);
    for (int v0 = 0; v0 < vecs; v0 += 32) {  // uniform: every lane shuffles
      const int v = v0 + lane;
      int r = (4 * v) / C;
      int j = 4 * v - r * C;
      float x[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        x[t] = row_at<kStaged>(tab, ldt, __shfl_sync(kFull, kv, r & 31), j);
        if (++j == C) {
          j = 0;
          ++r;
        }
      }
      if (v < vecs) dst[v] = make_float4(x[0], x[1], x[2], x[3]);
    }
  }
  if (tail > 0 && warp0 == n_warps - 1) {
    const int64_t base = full_groups * 32;
    const int k = lane < tail ? __ldg(idx + base + lane) : -1;
    const int kv =
        static_cast<unsigned>(k) < static_cast<unsigned>(T) ? k : -1;
    float* dst = out + base * C;
    for (int e0 = 0; e0 < tail * C; e0 += 32) {
      const int e = e0 + lane;
      const int r = e / C;
      const float x =
          row_at<kStaged>(tab, ldt, __shfl_sync(kFull, kv, r & 31), e - r * C);
      if (e < tail * C) dst[e] = x;
    }
  }
}

}  // namespace

// Plain C entry point for ctypes: `table` is [T, ld] row-major on the
// device, `idx` [32 full_groups + tail], `out` [32 full_groups + tail, C]
// (16-byte aligned); reads the columns col .. col + C.  `staged` and
// `blocks` come from ops/fetch.py::gather_plan.  Launches on `stream` and
// returns cudaGetLastError() of the launch.
extern "C" int hrt_gather(const float* table, int T, int ld, int col, int C,
                          const int* idx, long long full_groups, int tail,
                          float* out, int staged, int blocks, void* stream) {
  if (full_groups * 32 + tail <= 0 || C <= 0) return 0;
  const size_t smem = static_cast<size_t>(T) * C * sizeof(float);
  if (col < 0 || col + C > ld || tail < 0 || tail >= 32 || blocks < 1 ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0 ||
      (staged && smem > kStageBytes))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (staged)
    gather_kernel<true><<<blocks, kThreads, smem, s>>>(
        table, T, ld, col, C, idx, full_groups, tail, out);
  else
    gather_kernel<false><<<blocks, kThreads, 0, s>>>(
        table, T, ld, col, C, idx, full_groups, tail, out);
  return static_cast<int>(cudaGetLastError());
}
