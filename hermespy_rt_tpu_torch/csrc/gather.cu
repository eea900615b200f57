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
// An exact copy: no arithmetic, so the bits equal the plain version's.  What
// bounds it is device memory: the ids read once, the output written once and
// the table rows that are hit read once (the same rows are hit many times
// and come from L2: 27 KB for the 256-triangle canyon, 14 MB for the
// 131,072-triangle city).  One thread per output element, consecutive
// threads on consecutive elements of the output, so writes are coalesced and
// the C threads of one row read its C consecutive floats.  Ids outside
// [0, T) give rows of zeros, as the TPU kernel's one-hot does (the tracer
// passes clamped ids only).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) gather_kernel(
    const float* __restrict__ table, int T, int ld, int col, int C,
    const int* __restrict__ idx, int64_t N, float* __restrict__ out) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= N * C) return;
  const int64_t i = e / C;
  const int j = static_cast<int>(e - i * C);
  const int k = __ldg(idx + i);
  out[e] = (k >= 0 && k < T)
               ? __ldg(table + static_cast<int64_t>(k) * ld + col + j)
               : 0.0f;
}

}  // namespace

// Plain C entry point for ctypes: `table` is [T, ld] row-major on the
// device, `idx` [N], `out` [N, C]; reads the columns col .. col + C.
// Launches on `stream` and returns cudaGetLastError() of the launch.
extern "C" int hrt_gather(const float* table, int T, int ld, int col, int C,
                          const int* idx, long long N, float* out,
                          void* stream) {
  if (N <= 0 || C <= 0) return 0;
  if (col < 0 || col + C > ld) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (N * C + kThreads - 1) / kThreads;
  gather_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(table, T, ld, col, C,
                                                       idx, N, out);
  return static_cast<int>(cudaGetLastError());
}
