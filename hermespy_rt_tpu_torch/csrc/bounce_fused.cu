// The fused bounce stages and the whole-loop material backward for NVIDIA
// Hopper (sm_90a).
//
// Replaces three TPU kernels of hermespy_rt_tpu/ops/bounce_fused.py:
//   bounce_pre_kernel    <- _pre_fwd_kernel (with_mat=True)
//   bounce_post_kernel   <- _post_fwd_kernel
//   loop_bwd_slim_kernel <- _loop_bwd_slim_kernel
// Their plain torch versions are hermespy_rt_tpu_torch/ops/bounce_fused.py::
// bounce_pre_plain, ::bounce_post_plain and ::loop_bwd_slim_plain.
//
// All three are per-ray maps: one thread per ray, rays on the fastest axis
// of every [k, R] row operand (coalesced), 3-vectors as [R, 3] (the form the
// nearest-hit kernel reads).  What bounds them on this card is device
// memory: a few hundred bytes per ray against a few hundred f32 operations.
// The design keeps every intermediate in registers and moves each operand
// once.  The TPU kernels fetch the hit row with an exact bf16 three-limb
// one-hot matmul to use the MXU; here the hit row is a direct load through
// the read-only cache from the [T, 27] payload table (27 KB at 256
// triangles, resident in L1/L2), and the material id an int32 load (the
// TPU kernel's bf16 id is exact only below 256 materials).
//
// Built with -fmad=false and without fast math, every product, sum, IEEE
// square root and division is rounded on its own, in the operation order of
// the plain versions (which are the op path's torch ops), so every decision
// and every geometric value of the pre stage equals the plain version's.
// The stages' per-ray bodies are device functions of bounce.cuh, which the
// per-stage backwards (bounce_bwd.cu) recompute through.
// expf/sinf/cosf are the CUDA math library's (not the __ intrinsics); they
// may differ from torch's by an ulp, so the post stage's scattering rows may
// differ by a few ulp.
//
// The backward is the vjp of the plain version's _post_light then
// _pre_light per bounce in reverse, derived by hand, honouring each of the
// plain version's guards: total internal reflection, the safe square roots,
// the complex division's zero-denominator branch and the scattering
// normalisation's threshold.  The 6-row state cotangent is carried in
// registers.  A (ray, RX) is written only where the ray is live (the post
// stage's write), so a dead ray reads only its freq cotangents; a live ray
// reads its material, state rows 0-3 and pre residuals, and its next state
// rows 0-3 and post residuals only where an RX was written.  The eta
// cotangent is summed per MATERIAL (the [M, 12] table, not per triangle)
// without atomics, in a fixed order: each warp keeps its own table in shared
// memory; for each material among its live rays, in order of the lowest
// lane, it sums that material's rays with a shuffle tree and lane 0 adds the
// sum.  Each block sums its warps' tables in warp order into its partial;
// the wrapper sums the partials in a fixed order.  The result is the same
// from run to run.

#include "bounce.cuh"

namespace {

// ---------------------------------------------------------------------------
// pre stage

struct PreArgs {
  const float *o, *d, *st;
  const unsigned char* act;
  const int* idx;
  const float* table;
  const int* material;
  const float *rx, *sc;
  int R, nrx, physical;
  float eps_o;
  float *o2, *d2, *st2, *ex, *sh_o, *sh_d, *d2rx, *t_self;
  unsigned char* crossing;
  int* excl;
  unsigned char* live_out;
  int* mat;
  float* res;
};

__global__ void __launch_bounds__(kThreads) bounce_pre_kernel(PreArgs a) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= a.R) return;
  const size_t R = a.R;
  const int idx = a.idx[r];
  const bool live = a.act[r] != 0 && idx >= 0;
  const int safe = idx > 0 ? idx : 0;
  const Payload p = load_payload(a.table + static_cast<size_t>(safe) * kCols);
  const float fslm = __ldg(a.sc), k_dop = __ldg(a.sc + 1);
  float o[3], d[3], st[6];
  for (int c = 0; c < 3; ++c) {
    o[c] = a.o[3 * r + c];
    d[c] = a.d[3 * r + c];
  }
  for (int j = 0; j < 6; ++j) st[j] = a.st[j * R + r];
  const PreFwd f = pre_forward(o, d, st, p, fslm, k_dop, live);

  for (int c = 0; c < 3; ++c) {
    a.o2[3 * r + c] = f.o2[c];
    a.d2[3 * r + c] = f.d2[c];
  }
  for (int j = 0; j < 6; ++j) a.st2[j * R + r] = f.st2[j];
  a.ex[r] = f.theta;
  a.ex[R + r] = f.cos_t1;
  a.ex[2 * R + r] = f.ndot;

  // per-RX shadow setup (tracer.bounce_step's scatter-pre lines)
  const float dint = dot3(f.d2, p.n);
  for (int k = 0; k < a.nrx; ++k) {
    const size_t i = k * R + r;
    const ShadowRx s = shadow_rx(a.rx + 3 * k, f.o2, p.n, dint, live);
    for (int c = 0; c < 3; ++c) {
      a.sh_d[3 * i + c] = s.ds[c];
      a.sh_o[3 * i + c] = a.physical ? f.o2[c] + a.eps_o * s.ds[c] : f.o2[c];
    }
    a.d2rx[i] = s.d2rx;
    a.t_self[i] = s.t_self;
    a.crossing[i] = s.crossing;
  }
  a.excl[r] = live ? idx : -1;
  a.live_out[r] = live;
  a.mat[r] = __ldg(a.material + safe);
  a.res[r] = f.cos_t1;
  a.res[R + r] = f.sin_t1;
  a.res[2 * R + r] = f.fscale;
}

// ---------------------------------------------------------------------------
// post stage

struct PostArgs {
  const float *d2, *st2, *ex, *sh_d, *d2rx, *t_self;
  const unsigned char* crossing;
  const int* excl;
  const unsigned char* live;
  const float* t_o;
  const int* idx_o;
  const float *table, *sc;
  int R, nrx, physical;
  float eps_o;
  float* out;
  unsigned char* write;
  float* res;
};

__global__ void __launch_bounds__(kThreads) bounce_post_kernel(PostArgs a) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= a.R) return;
  const size_t R = a.R;
  const bool live = a.live[r] != 0;
  const int excl = a.excl[r];
  const float* row =
      a.table + static_cast<size_t>(excl > 0 ? excl : 0) * kCols;
  float n[3], vel[3], d2[3];
  for (int c = 0; c < 3; ++c) {
    n[c] = __ldg(row + 9 + c);
    vel[c] = __ldg(row + 12 + c);
    d2[c] = a.d2[3 * r + c];
  }
  const float s = __ldg(row + kGeom + kEtaS);
  const float s1a = __ldg(row + kGeom + kEtaS1Alpha);
  const float fslm = __ldg(a.sc), k_dop = __ldg(a.sc + 1);
  float st2[6];
  for (int j = 0; j < 6; ++j) st2[j] = a.st2[j * R + r];
  const float theta = a.ex[r], cos_t1 = a.ex[R + r];
  const float ndot = a.physical ? a.ex[2 * R + r] : 0.0f;  // physical only

  float th_c = theta, cos_c = cos_t1;  // the reference clobber chain
  for (int k = 0; k < a.nrx; ++k) {
    const size_t i = k * R + r;
    float ds[3];
    for (int c = 0; c < 3; ++c) ds[c] = a.sh_d[3 * i + c];
    const float d2rx = a.d2rx[i];
    const PostRx q = post_rx(a.physical, a.eps_o, a.table, ds, d2rx,
                             a.t_self[i], a.crossing[i] != 0, a.t_o[i],
                             a.idx_o[i], excl, live, n, vel, s, s1a, d2, st2,
                             theta, cos_t1, ndot, fslm, &th_c, &cos_c);
    float* out = a.out + 6 * k * R + r;
    out[0] = q.amp[0] * q.wf;
    out[R] = q.amp[1] * q.wf;
    out[2 * R] = q.amp[2] * q.wf;
    out[3 * R] = q.amp[3] * q.wf;
    out[4 * R] = q.write ? st2[4] + d2rx / kLight : 0.0f;
    out[5 * R] = st2[5] - (live ? q.dop * k_dop : 0.0f);
    float* res = a.res + 6 * k * R + r;
    res[0] = q.theta_s;
    res[R] = q.theta_i;
    res[2 * R] = q.cos_ts;
    res[3 * R] = q.cos_ti;
    res[4 * R] = q.sin_ti;
    res[5 * R] = q.wf;
    a.write[i] = q.write;
  }
}

// ---------------------------------------------------------------------------
// whole-loop materials-only backward

struct BwdArgs {
  const float* eta_tab;
  int M;
  const float* st_all;        // [B+1, 6, R]
  const unsigned char* live;  // [B, R]
  const int* mat;             // [B, R]
  const float* res_pre;       // [B, 3, R]
  const float* res_post;      // [B, nrx, 6, R]
  const float* d_out;         // [B, nrx, 6, R]
  int R, B, nrx;
  float* d_st0;               // [6, R]
  float* d_tab_part;          // [gridDim.x, M, 12]
};

// blockDim.x is a multiple of 32 up to kThreads, chosen by the host so that
// the warps' tables fit in shared memory
__global__ void __launch_bounds__(kThreads) loop_bwd_slim_kernel(BwdArgs a) {
  extern __shared__ float acc[];  // [blockDim.x / 32, M, 12]
  const int n_acc = a.M * kEta;
  const int n_warps = blockDim.x / 32;
  for (int i = threadIdx.x; i < n_warps * n_acc; i += blockDim.x)
    acc[i] = 0.0f;
  __syncthreads();
  float* wacc = acc + (threadIdx.x / 32) * n_acc;  // this warp's table
  const size_t R = a.R;
  const int lane = threadIdx.x & 31;

  // every lane of a warp runs every iteration (the warp reduction below
  // needs them all); rays past R contribute nothing
  for (int base = blockIdx.x * blockDim.x; base < a.R;
       base += gridDim.x * blockDim.x) {
    const int r = base + threadIdx.x;
    const bool in = r < a.R;
    float dc[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int b = a.B - 1; b >= 0; --b) {
      const size_t br = b * R + r;
      const bool live = in && a.live[br] != 0;
      int m = 0;
      float d_eta[kEta];
      for (int j = 0; j < kEta; ++j) d_eta[j] = 0.0f;
      if (in) {
        const size_t b_off = static_cast<size_t>(b) * a.nrx * 6 * R + r;
        float dst2[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        for (int k = 0; k < a.nrx; ++k)
          dst2[5] += a.d_out[b_off + (k * 6 + 5) * R];
        if (live) {
          m = a.mat[br];
          float eta[kEta], st[4], st2[4];
          for (int j = 0; j < kEta; ++j)
            eta[j] = __ldg(a.eta_tab + m * kEta + j);
          bool have_st2 = false;
          float d_s = 0.0f, d_s1a = 0.0f;
          for (int k = 0; k < a.nrx; ++k) {
            const float* rp = a.res_post + b_off + k * 6 * R;
            const float* dout = a.d_out + b_off + k * 6 * R;
            const float wf = rp[5 * R];
            if (wf > 0.0f) {
              if (!have_st2) {
                for (int j = 0; j < 4; ++j)
                  st2[j] = a.st_all[((b + 1) * 6 + j) * R + r];
                have_st2 = true;
              }
              dst2[4] += dout[4 * R];
              post_rx_vjp(rp, dout, R, wf, eta[kEtaS], eta[kEtaS1Alpha],
                          st2, dst2, &d_s, &d_s1a);
            }
          }
          for (int j = 0; j < 6; ++j) dst2[j] += dc[j];
          dc[4] = dst2[4];
          dc[5] = dst2[5];
          for (int j = 0; j < 4; ++j) st[j] = a.st_all[(b * 6 + j) * R + r];
          const float* rq = a.res_pre + b * 3 * R + r;
          pre_vjp(eta, rq[0], rq[R], rq[2 * R], st, dst2, dc, d_eta);
          d_eta[kEtaS] += d_s;
          d_eta[kEtaS1Alpha] += d_s1a;
        } else {
          dc[5] += dst2[5];  // rows 0-4 pass through unchanged
        }
      }

      // add this bounce's eta cotangent to the warp's material table: one
      // material at a time, that of the lowest lane still pending
      unsigned pending = __ballot_sync(0xffffffffu, live);
      while (pending != 0u) {
        const int m0 = __shfl_sync(0xffffffffu, m, __ffs(pending) - 1);
        const bool mine = live && m == m0;
        for (int j = 0; j < kEta; ++j) {
          float v = mine ? d_eta[j] : 0.0f;
          for (int off = 16; off > 0; off >>= 1)
            v += __shfl_xor_sync(0xffffffffu, v, off);
          if (lane == 0) wacc[m0 * kEta + j] += v;
        }
        pending &= ~__ballot_sync(0xffffffffu, mine);
      }
    }
    if (in)
      for (int j = 0; j < 6; ++j) a.d_st0[j * R + r] = dc[j];
  }
  __syncthreads();
  float* part = a.d_tab_part + static_cast<size_t>(blockIdx.x) * n_acc;
  for (int i = threadIdx.x; i < n_acc; i += blockDim.x) {
    float s = 0.0f;
    for (int w = 0; w < n_warps; ++w) s += acc[w * n_acc + i];
    part[i] = s;
  }
}

}  // namespace

// Plain C entry points for ctypes.  Pointers are device pointers; each
// launches on `stream` and returns cudaGetLastError() of the launch.

extern "C" int hrt_bounce_pre(
    const float* o, const float* d, const float* st, const unsigned char* act,
    const int* idx, const float* table, const int* material, const float* rx,
    const float* sc, int R, int nrx, int physical, float eps_o, float* o2,
    float* d2, float* st2, float* ex, float* sh_o, float* sh_d, float* d2rx,
    float* t_self, unsigned char* crossing, int* excl, unsigned char* live,
    int* mat, float* res, void* stream) {
  if (R <= 0) return 0;
  const PreArgs a{o,    d,    st,  act,    idx,   table, material, rx,
                  sc,   R,    nrx, physical, eps_o, o2,  d2,       st2,
                  ex,   sh_o, sh_d, d2rx,  t_self, crossing, excl, live,
                  mat,  res};
  bounce_pre_kernel<<<(R + kThreads - 1) / kThreads, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hrt_bounce_post(
    const float* d2, const float* st2, const float* ex, const float* sh_d,
    const float* d2rx, const float* t_self, const unsigned char* crossing,
    const int* excl, const unsigned char* live, const float* t_o,
    const int* idx_o, const float* table, const float* sc, int R, int nrx,
    int physical, float eps_o, float* out, unsigned char* write, float* res,
    void* stream) {
  if (R <= 0) return 0;
  const PostArgs a{d2,   st2, ex,    sh_d,  d2rx,   t_self, crossing,
                   excl, live, t_o,  idx_o, table,  sc,     R,
                   nrx,  physical, eps_o, out, write,  res};
  bounce_post_kernel<<<(R + kThreads - 1) / kThreads, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// d_tab_part holds n_blocks partial [M, 12] tables; each block of `threads`
// (a multiple of 32, at most 256) uses threads / 32 * M * 12 floats of
// dynamic shared memory.
extern "C" int hrt_loop_bwd_slim(const float* eta_tab, int M,
                                 const float* st_all,
                                 const unsigned char* live, const int* mat,
                                 const float* res_pre, const float* res_post,
                                 const float* d_out, int R, int B, int nrx,
                                 float* d_st0, float* d_tab_part, int n_blocks,
                                 int threads, void* stream) {
  if (R <= 0 || n_blocks <= 0) return 0;
  if (threads <= 0 || threads > kThreads || threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      static_cast<size_t>(threads / 32) * M * kEta * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        loop_bwd_slim_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const BwdArgs a{eta_tab, M,   st_all, live,  mat,   res_pre, res_post,
                  d_out,   R,   B,      nrx,   d_st0, d_tab_part};
  loop_bwd_slim_kernel<<<n_blocks, threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
