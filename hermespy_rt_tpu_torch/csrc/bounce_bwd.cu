// The per-stage backwards of the fused bounce stages for NVIDIA Hopper
// (sm_90a).
//
// Replaces four TPU kernels of hermespy_rt_tpu/ops/bounce_fused.py:
//   bounce_pre_bwd_kernel       <- _pre_bwd_kernel       (grad_positions)
//   bounce_post_bwd_kernel      <- _post_bwd_kernel      (grad_positions)
//   bounce_pre_bwd_slim_kernel  <- _pre_bwd_slim_kernel
//   bounce_post_bwd_slim_kernel <- _post_bwd_slim_kernel
// Their plain torch versions are hermespy_rt_tpu_torch/ops/bounce_fused.py::
// bounce_pre_bwd_plain, ::bounce_post_bwd_plain, ::bounce_pre_bwd_slim_plain
// and ::bounce_post_bwd_slim_plain (torch.func.vjp of the stages' cores).
//
// One thread per ray, as the forward kernels: each recomputes its ray's
// forward through the forward's own device functions (bounce.cuh:
// pre_forward, shadow_rx, post_rx), so the decisions it differentiates at
// are the forward's, then runs the vjp by hand, in registers, the way torch
// autograd differentiates the plain version: torch.where passes the
// cotangent to the selected branch only; clamp passes it inside its bounds,
// ends included; abs and |theta_s - theta_i| take sign() (0 at 0);
// fast_acos is differentiated as its polynomial; the safe square roots and
// divisions give 0 where their guard holds.  The reference theta-clobber
// chain is reversed in one forward sweep over the RX: the cotangent of each
// RX's incidence angle belongs to the last occluded RX at or before it (or
// to the pre stage's theta/cos_t1), which is finished, with its occluder
// normal's and shadow direction's cotangents, when the next occluded RX
// comes or the sweep ends.
//
// What bounds them is device memory: a few hundred bytes per ray (inputs,
// the 108-byte payload row, cotangents in and out) against ~1000 f32
// operations.  Each operand is read once (the payload row through the
// read-only cache); per-ray payload cotangent rows go out [R, n] for the
// table scatter-add (scatter_add.cu), the TPU kernels' in-kernel one-hot
// MXU scatter being a TPU device.  Sums across rays (the RX positions' and
// carrier scalars' cotangents) are per-block partials in a fixed order
// (bounce.cuh: block_sum; kernel 12 reduces all of its sums with one barrier,
// see there), summed by the wrapper in a fixed order, so the result is the
// same from run to run.

#include "bounce.cuh"

namespace {

// ---------------------------------------------------------------------------
// kernel 12: the full pre-stage backward
//
// Blocks of 128 rays.  The per-ray arithmetic is the same device functions
// in the same order as before, so every per-ray output keeps its bits; what
// changed is how the block moves its rows and sums:
// - the block's [R, 3] rows (o, d and the cotangents of o2 and d2 in; d_o
//   and d_d out) and its d_pay rows (one contiguous run of 128 pc floats)
//   go through shared memory and are read and written as 16-byte vectors
//   (copy_rows), where a thread's own 3 or pc scalars at a 12- or 108-byte
//   stride touched a sector a lane;
// - the 3 nrx + 2 sums across rays: each warp reduces its lanes' terms by
//   the butterfly of block_sum as the RX loop goes, lane 0 keeps them in
//   shared memory [part][warp], and after the one barrier of the block one
//   thread a part adds the warps in order into the block's partial.  The
//   same adds in the same order every run, and no float atomics.

constexpr int kPreBwdRays = 128;
constexpr int kPreBwdWarps = kPreBwdRays / 32;
constexpr int kPreBwdMaxParts = 1024;  // 3 nrx + 2: nrx <= 340

struct PreBwdArgs {
  const float *o, *d, *st;
  const unsigned char* act;
  const int* idx;
  const float *table, *rx, *sc;
  const float *g_o2, *g_d2, *g_st2, *g_ex, *g_sh_d, *g_d2rx;  // cotangents
  int R, nrx, pc;            // pc: payload cotangent columns (27 or 12)
  float *d_o, *d_d, *d_st, *d_pay;
  float* part;               // [gridDim.x, 3 nrx + 2]
};

// the sum of v over the warp's lanes, in every lane: block_sum's butterfly
__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// n floats from src to dst by the block's threads, as 16-byte vectors where
// both ends are 16-byte aligned
__device__ __forceinline__ void copy_rows(float* __restrict__ dst,
                                          const float* __restrict__ src,
                                          int n) {
  int done = 0;
  if (((reinterpret_cast<size_t>(dst) | reinterpret_cast<size_t>(src)) &
       15) == 0) {
    done = n & ~3;
    for (int i = threadIdx.x; i < done / 4; i += blockDim.x)
      reinterpret_cast<float4*>(dst)[i] =
          reinterpret_cast<const float4*>(src)[i];
  }
  for (int i = done + threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

__global__ void __launch_bounds__(kPreBwdRays)
    bounce_pre_bwd_kernel(PreBwdArgs a) {
  // the block's rows: o and d (then d_o and d_d), the cotangents of o2 and
  // d2, the payload cotangent rows; then the warps' sums [part][warp]
  __shared__ __align__(16) float s_o[3 * kPreBwdRays], s_d[3 * kPreBwdRays],
      s_go2[3 * kPreBwdRays], s_gd2[3 * kPreBwdRays];
  __shared__ __align__(16) float s_pay[kPreBwdRays * kCols];
  extern __shared__ float s_part[];
  const int base = blockIdx.x * kPreBwdRays;
  const int n_in = min(kPreBwdRays, a.R - base);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  copy_rows(s_o, a.o + 3 * static_cast<size_t>(base), 3 * n_in);
  copy_rows(s_d, a.d + 3 * static_cast<size_t>(base), 3 * n_in);
  copy_rows(s_go2, a.g_o2 + 3 * static_cast<size_t>(base), 3 * n_in);
  copy_rows(s_gd2, a.g_d2 + 3 * static_cast<size_t>(base), 3 * n_in);
  __syncthreads();
  const bool in = static_cast<int>(threadIdx.x) < n_in;
  // every thread joins the warps' sums: one past the rays takes the last
  // ray's operands and adds 0
  const int ts = in ? static_cast<int>(threadIdx.x) : n_in - 1;
  const int r = base + ts;
  const size_t R = a.R;
  const int nparts = 3 * a.nrx + 2;

  const int idx = a.idx[r];
  const bool live = a.act[r] != 0 && idx >= 0;
  const Payload p = load_payload(
      a.table + static_cast<size_t>(idx > 0 ? idx : 0) * kCols);
  const float fslm = __ldg(a.sc), k_dop = __ldg(a.sc + 1);
  float o[3], d[3], st[6];
  for (int c = 0; c < 3; ++c) {
    o[c] = s_o[3 * ts + c];
    d[c] = s_d[3 * ts + c];
  }
  for (int j = 0; j < 6; ++j) st[j] = a.st[j * R + r];
  const PreFwd f = pre_forward(o, d, st, p, fslm, k_dop, live);

  float g_o[3] = {0.0f, 0.0f, 0.0f}, g_d[3] = {0.0f, 0.0f, 0.0f};
  float g_v0[3] = {0.0f, 0.0f, 0.0f}, g_e1[3] = {0.0f, 0.0f, 0.0f};
  float g_e2[3] = {0.0f, 0.0f, 0.0f}, g_n[3] = {0.0f, 0.0f, 0.0f};
  float g_vel[3] = {0.0f, 0.0f, 0.0f}, g_st[6], g_eta[kEta];
  for (int j = 0; j < kEta; ++j) g_eta[j] = 0.0f;
  float g_fslm = 0.0f, g_kdop = 0.0f, g_t = 0.0f;
  float g_o2[3], g_d2[3];
  for (int c = 0; c < 3; ++c) {
    g_o2[c] = s_go2[3 * ts + c];
    g_d2[c] = s_gd2[3 * ts + c];
  }

  // per RX: ds = (rx - o2) / |rx - o2| and d2rx = |rx - o2| (the shadow
  // origins and the crossing decisions carry no cotangent).  The sums are
  // associated as autograd associates them (a cotangent that is a small
  // difference of large terms, as at a grazing hit, then rounds alike): the
  // RX's terms of o2 summed first, then added to o2's own cotangent.
  const float dint = dot3(f.d2, p.n);
  float g_so[3] = {0.0f, 0.0f, 0.0f};
  for (int k = 0; k < a.nrx; ++k) {
    const size_t i = k * R + r;
    const ShadowRx s = shadow_rx(a.rx + 3 * k, f.o2, p.n, dint, live);
    float gds[3];
    for (int c = 0; c < 3; ++c) gds[c] = a.g_sh_d[3 * i + c];
    float gdr = a.g_d2rx[i];
    float g_den = 0.0f;
    for (int c = 0; c < 3; ++c)
      g_den += -gds[c] * s.ds_un[c] / (s.den * s.den);
    gdr += s.d2rx > 0.0f ? g_den : 0.0f;
    const float g_n2 = s.n2 > 0.0f ? gdr / (2.0f * s.d2rx) : 0.0f;
    for (int c = 0; c < 3; ++c) {
      const float g_sq = g_n2 * s.ds_un[c];
      const float gdu = gds[c] / s.den + g_sq + g_sq;
      g_so[c] += -gdu;
      const float sum = warp_sum(in ? gdu : 0.0f);
      if (lane == 0) s_part[(3 * k + c) * kPreBwdWarps + warp] = sum;
    }
  }
  for (int c = 0; c < 3; ++c) g_o2[c] += g_so[c];

  // freq: st2[5] = st[5] + live (d_ref - d) . vel k_dop
  const float g5 = a.g_st2[5 * R + r];
  g_st[5] = g5;
  float g_dref[3] = {0.0f, 0.0f, 0.0f};
  if (live) {
    g_kdop += g5 * dot3(f.dd, p.vel);
    const float g_dot = g5 * k_dop;
    for (int c = 0; c < 3; ++c) {
      g_vel[c] += g_dot * f.dd[c];
      g_dref[c] += g_dot * p.vel[c];
      g_d[c] -= g_dot * p.vel[c];
    }
  }
  // o2 = live ? o + t d + 1e-4 d_ref : o, d2 = live ? d_ref : d
  if (live) {
    for (int c = 0; c < 3; ++c) {
      g_dref[c] += g_d2[c] + kOffset * g_o2[c];
      g_o[c] += g_o2[c];
      g_d[c] += f.t * g_o2[c];
    }
    g_t += dot3(g_o2, d);
  } else {
    for (int c = 0; c < 3; ++c) {
      g_o[c] += g_o2[c];
      g_d[c] += g_d2[c];
    }
  }
  // d_ref = d - (2 d . n) n
  const float g_dn = -2.0f * dot3(g_dref, p.n);
  for (int c = 0; c < 3; ++c) {
    g_d[c] += g_dref[c] + g_dn * p.n[c];
    g_n[c] += -f.two_dn * g_dref[c] + g_dn * d[c];
  }
  // tau: st2[4] = st[4] + live t / c
  const float g4 = a.g_st2[4 * R + r];
  g_st[4] = g4;
  if (live) g_t += g4 / kLight;
  // amplitudes: Fresnel at (cos_t1, sin_t1), scaled by fscale
  float g_cos = a.g_ex[R + r], g_sin = 0.0f, g_fscale = 0.0f;
  float g_st2[4];
  for (int j = 0; j < 4; ++j) g_st2[j] = a.g_st2[j * R + r];
  if (live) {
    float trig[3];
    pre_vjp(p.eta, f.cos_t1, f.sin_t1, f.fscale, st, g_st2, g_st, g_eta,
            trig);
    g_cos += trig[0];
    g_sin = trig[1];
    g_fscale = trig[2];
  } else {
    for (int j = 0; j < 4; ++j) g_st[j] = g_st2[j];
  }
  // fscale = fsl2 > 1 ? 1 / fsl2 : 1, fsl2 = (fslm t)^2
  const float g_fsl2 =
      f.fsl2 > 1.0f ? -g_fscale * (f.fscale * f.fscale) : 0.0f;
  const float g_fsl = 2.0f * f.fsl * g_fsl2;
  g_fslm += g_fsl * f.t;
  g_t += g_fsl * fslm;
  // theta = fast_acos(cos_t1), sin_t1 = sqrt(1 - cos_t1^2),
  // cos_t1 = clamp(|ndot|, 0, 1 - eps), ndot = n . d
  g_cos += a.g_ex[r] * fast_acos_grad(f.cos_t1);
  g_cos += -2.0f * (g_sin / (2.0f * f.sin_t1)) * f.cos_t1;
  const float g_ndot = a.g_ex[2 * R + r] +
                       (fabsf(f.ndot) <= kClip ? g_cos : 0.0f) * signf(f.ndot);
  for (int c = 0; c < 3; ++c) {
    g_n[c] += g_ndot * d[c];
    g_d[c] += g_ndot * p.n[c];
  }
  // t = live ? (e2 . qvec) / det : 0, qvec = (o - v0) x e1, pvec = d x e2
  if (live) {
    const float g_tq = g_t * f.inv_det;
    const float g_inv = g_t * f.tq;
    const float g_det = f.det != 0.0f ? -g_inv * f.inv_det * f.inv_det : 0.0f;
    float g_q[3], g_sv[3], g_p[3], tmp[3];
    for (int c = 0; c < 3; ++c) {
      g_e2[c] += g_tq * f.qvec[c];
      g_q[c] = g_tq * p.e2[c];
      g_e1[c] += g_det * f.pvec[c];
      g_p[c] = g_det * p.e1[c];
    }
    cross3(p.e1, g_q, g_sv);
    cross3(g_q, f.sv, tmp);
    for (int c = 0; c < 3; ++c) {
      g_e1[c] += tmp[c];
      g_o[c] += g_sv[c];
      g_v0[c] -= g_sv[c];
    }
    cross3(p.e2, g_p, tmp);
    for (int c = 0; c < 3; ++c) g_d[c] += tmp[c];
    cross3(g_p, d, tmp);
    for (int c = 0; c < 3; ++c) g_e2[c] += tmp[c];
  }

  {
    const float s_fslm = warp_sum(in ? g_fslm : 0.0f);
    const float s_kdop = warp_sum(in ? g_kdop : 0.0f);
    if (lane == 0) {
      s_part[(nparts - 2) * kPreBwdWarps + warp] = s_fslm;
      s_part[(nparts - 1) * kPreBwdWarps + warp] = s_kdop;
    }
  }
  if (in) {
    for (int c = 0; c < 3; ++c) {
      s_o[3 * ts + c] = g_o[c];
      s_d[3 * ts + c] = g_d[c];
    }
    for (int j = 0; j < 6; ++j) a.d_st[j * R + r] = g_st[j];
    float* pay = s_pay + ts * a.pc;
    if (a.pc == kCols) {
      for (int c = 0; c < 3; ++c) {
        pay[c] = g_v0[c];
        pay[3 + c] = g_e1[c];
        pay[6 + c] = g_e2[c];
        pay[9 + c] = g_n[c];
        pay[12 + c] = g_vel[c];
      }
      pay += kGeom;
    }
    for (int j = 0; j < kEta; ++j) pay[j] = g_eta[j];
  }
  __syncthreads();
  for (int q = threadIdx.x; q < nparts; q += blockDim.x) {
    float sum = 0.0f;
    for (int w = 0; w < kPreBwdWarps; ++w) sum += s_part[q * kPreBwdWarps + w];
    a.part[static_cast<size_t>(blockIdx.x) * nparts + q] = sum;
  }
  copy_rows(a.d_o + 3 * static_cast<size_t>(base), s_o, 3 * n_in);
  copy_rows(a.d_d + 3 * static_cast<size_t>(base), s_d, 3 * n_in);
  copy_rows(a.d_pay + static_cast<size_t>(base) * a.pc, s_pay, n_in * a.pc);
}

// ---------------------------------------------------------------------------
// kernel 13: the full post-stage backward

struct PostBwdArgs {
  const float *d2, *st2, *ex, *sh_d, *d2rx, *t_self;
  const unsigned char* crossing;
  const int* excl;
  const unsigned char* live;
  const float* t_o;
  const int* idx_o;
  const float *table, *sc, *g_out;
  int R, nrx, physical;
  float eps_o;
  int pc;                    // payload cotangent columns (27 or 2)
  float *d_d2, *d_st2, *d_ex, *d_sh_d, *d_d2rx, *d_pay;
  float* d_no;               // [nrx, R, 3] or null (reference + geometry)
  int* occ;                  // [nrx, R] or null
  float* part;               // [gridDim.x, 2]
};

// the cotangents that belong to an occluded RX's clobber: its incidence
// angle's cotangent (g_th, g_cos) goes through cos_o = clamp(|n_o . ds|) to
// the occluder normal and the RX's shadow direction; writes both
__device__ __forceinline__ void finish_occluder(const PostBwdArgs& a,
                                                size_t i, int idx_m,
                                                const float* n_o, float dno,
                                                const float* ds, float* g_ds,
                                                float g_th, float g_cos) {
  const float cos_o = clampf(fabsf(dno), 0.0f, kClip);
  g_cos += g_th * fast_acos_grad(cos_o);
  const float g_dno = (fabsf(dno) <= kClip ? g_cos : 0.0f) * signf(dno);
  for (int c = 0; c < 3; ++c) {
    g_ds[c] += g_dno * n_o[c];
    a.d_sh_d[3 * i + c] = g_ds[c];
  }
  if (a.d_no != nullptr) {
    for (int c = 0; c < 3; ++c) a.d_no[3 * i + c] = g_dno * ds[c];
    a.occ[i] = idx_m;
  }
}

__global__ void __launch_bounds__(kThreads)
    bounce_post_bwd_kernel(PostBwdArgs a) {
  __shared__ float smem[kThreads / 32];
  const int r0 = blockIdx.x * kThreads + threadIdx.x;
  const bool in = r0 < a.R;
  const int r = in ? r0 : a.R - 1;
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
  const float ndot = a.physical ? a.ex[2 * R + r] : 0.0f;

  float g_d2[3] = {0.0f, 0.0f, 0.0f}, g_st2[6];
  for (int j = 0; j < 6; ++j) g_st2[j] = 0.0f;
  float g_n[3] = {0.0f, 0.0f, 0.0f}, g_vel[3] = {0.0f, 0.0f, 0.0f};
  float g_s = 0.0f, g_s1a = 0.0f, g_fslm = 0.0f, g_kdop = 0.0f;
  float g_theta = 0.0f, g_cos_t1 = 0.0f;
  // the last occluded RX so far (reference parity): its index, merged
  // occluder, normal, n_o . ds, ds, its ds cotangent so far, and the
  // incidence-angle cotangents that belong to it
  int own = -1, own_idx = -1;
  float own_no[3], own_dno = 0.0f, own_ds[3], own_gds[3];
  float own_gth = 0.0f, own_gcos = 0.0f;

  float th_c = theta, cos_c = cos_t1;
  for (int k = 0; k < a.nrx && in; ++k) {
    const size_t i = k * R + r;
    float ds[3];
    for (int c = 0; c < 3; ++c) ds[c] = a.sh_d[3 * i + c];
    const float d2rx = a.d2rx[i];
    const PostRx q = post_rx(a.physical, a.eps_o, a.table, ds, d2rx,
                             a.t_self[i], a.crossing[i] != 0, a.t_o[i],
                             a.idx_o[i], excl, live, n, vel, s, s1a, d2, st2,
                             theta, cos_t1, ndot, fslm, &th_c, &cos_c);
    const float* g = a.g_out + 6 * k * R + r;
    float g_ds[3] = {0.0f, 0.0f, 0.0f}, g_dr = 0.0f;
    // freq: out5 = st2[5] - live (ds - d2) . vel k_dop
    g_st2[5] += g[5 * R];
    if (live) {
      const float g_dop = -g[5 * R];
      g_kdop += g_dop * q.dop;
      const float g_dot = g_dop * k_dop;
      for (int c = 0; c < 3; ++c) {
        g_vel[c] += g_dot * q.dsd[c];
        g_ds[c] += g_dot * vel[c];
        g_d2[c] -= g_dot * vel[c];
      }
    }
    float g_thi = 0.0f, g_cti = 0.0f;
    if (q.write) {
      // tau: out4 = st2[4] + d2rx / c
      g_st2[4] += g[4 * R];
      g_dr += g[4 * R] / kLight;
      // amplitudes out0-3 = (st2 (x) S) wf, wf = sscale(fslm d2rx)
      float g_amp[4], dS[4], ang[5];
      float g_wf = 0.0f;
      for (int j = 0; j < 4; ++j) {
        g_amp[j] = g[j * R] * q.wf;
        g_wf += g[j * R] * q.amp[j];
      }
      const float g_fsl2 =
          q.fsl_s2 > 1.0f ? -g_wf * (q.sscale * q.sscale) : 0.0f;
      const float g_fsl = 2.0f * q.fsl_s * g_fsl2;
      g_fslm += g_fsl * d2rx;
      g_dr += g_fsl * fslm;
      amp_vjp(g_amp, st2, q.sc.out, g_st2, dS);
      scat_vjp(q.sc, s, s1a, q.theta_s, q.theta_i, q.cos_ts, q.cos_ti,
               q.sin_ti, dS, &g_s, &g_s1a, ang);
      // sin_ti = sqrt(1 - cos_ti^2); theta_s = fast_acos(cos_ts),
      // cos_ts = clamp(ds . n, +-(1 - eps))
      g_thi = ang[1];
      g_cti = ang[3] - 2.0f * (ang[4] / (2.0f * q.sin_ti)) * q.cos_ti;
      const float g_cts = ang[2] + ang[0] * fast_acos_grad(q.cos_ts);
      const float g_dsn = q.dsn >= -kClip && q.dsn <= kClip ? g_cts : 0.0f;
      for (int c = 0; c < 3; ++c) {
        g_ds[c] += g_dsn * n[c];
        g_n[c] += g_dsn * ds[c];
      }
    }
    a.d_d2rx[i] = g_dr;
    if (a.physical) {
      g_theta += g_thi;
      g_cos_t1 += g_cti;
      for (int c = 0; c < 3; ++c) a.d_sh_d[3 * i + c] = g_ds[c];
    } else if (q.occ) {
      if (own >= 0)
        finish_occluder(a, own * R + r, own_idx, own_no, own_dno, own_ds,
                        own_gds, own_gth, own_gcos);
      own = k;
      own_idx = q.idx_m;
      own_dno = q.dno;
      for (int c = 0; c < 3; ++c) {
        own_no[c] = q.n_o[c];
        own_ds[c] = ds[c];
        own_gds[c] = g_ds[c];
      }
      own_gth = g_thi;
      own_gcos = g_cti;
    } else {
      if (own >= 0) {
        own_gth += g_thi;
        own_gcos += g_cti;
      } else {
        g_theta += g_thi;
        g_cos_t1 += g_cti;
      }
      for (int c = 0; c < 3; ++c) a.d_sh_d[3 * i + c] = g_ds[c];
      if (a.d_no != nullptr) {
        for (int c = 0; c < 3; ++c) a.d_no[3 * i + c] = 0.0f;
        a.occ[i] = -1;
      }
    }
  }
  if (in && own >= 0)
    finish_occluder(a, own * R + r, own_idx, own_no, own_dno, own_ds,
                    own_gds, own_gth, own_gcos);

  block_sum(in ? g_fslm : 0.0f, a.part + 2 * blockIdx.x, smem);
  block_sum(in ? g_kdop : 0.0f, a.part + 2 * blockIdx.x + 1, smem);
  if (!in) return;
  for (int c = 0; c < 3; ++c) a.d_d2[3 * r + c] = g_d2[c];
  for (int j = 0; j < 6; ++j) a.d_st2[j * R + r] = g_st2[j];
  a.d_ex[r] = g_theta;
  a.d_ex[R + r] = g_cos_t1;
  a.d_ex[2 * R + r] = 0.0f;  // ndot enters only the hemisphere decision
  float* pay = a.d_pay + static_cast<size_t>(r) * a.pc;
  if (a.pc == kCols) {
    for (int j = 0; j < kCols; ++j) pay[j] = 0.0f;
    for (int c = 0; c < 3; ++c) {
      pay[9 + c] = g_n[c];
      pay[12 + c] = g_vel[c];
    }
    pay += kCols - 2;
  }
  pay[0] = g_s;
  pay[1] = g_s1a;
}

// ---------------------------------------------------------------------------
// kernels 14 and 15: the slim backwards (no geometric recompute: the vjps of
// _pre_light and _post_light at the saved residuals)

struct PreBwdSlimArgs {
  const float* st;
  const unsigned char* act;
  const int* idx;
  const float *table, *res, *g_st2;
  int R;
  float *d_st, *d_eta;       // [6, R], [R, 12]
};

__global__ void __launch_bounds__(kThreads)
    bounce_pre_bwd_slim_kernel(PreBwdSlimArgs a) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= a.R) return;
  const size_t R = a.R;
  const int idx = a.idx[r];
  const bool live = a.act[r] != 0 && idx >= 0;
  float g[6], d_st[6], d_eta[kEta];
  for (int j = 0; j < 6; ++j) d_st[j] = g[j] = a.g_st2[j * R + r];
  for (int j = 0; j < kEta; ++j) d_eta[j] = 0.0f;
  if (live) {
    const float* row =
        a.table + static_cast<size_t>(idx) * kCols + kGeom;
    float eta[kEta], st[4];
    for (int j = 0; j < kEta; ++j) eta[j] = __ldg(row + j);
    for (int j = 0; j < 4; ++j) st[j] = a.st[j * R + r];
    pre_vjp(eta, a.res[r], a.res[R + r], a.res[2 * R + r], st, g, d_st,
            d_eta);
  }
  for (int j = 0; j < 6; ++j) a.d_st[j * R + r] = d_st[j];
  float* out = a.d_eta + static_cast<size_t>(r) * kEta;
  for (int j = 0; j < kEta; ++j) out[j] = d_eta[j];
}

struct PostBwdSlimArgs {
  const float* st2;
  const int* excl;
  const float *table, *res, *g_out;
  int R, nrx;
  float *d_st2, *d_ss;       // [6, R], [R, 2]
};

__global__ void __launch_bounds__(kThreads)
    bounce_post_bwd_slim_kernel(PostBwdSlimArgs a) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= a.R) return;
  const size_t R = a.R;
  const int excl = a.excl[r];
  const float* row =
      a.table + static_cast<size_t>(excl > 0 ? excl : 0) * kCols + kGeom;
  const float s = __ldg(row + kEtaS), s1a = __ldg(row + kEtaS1Alpha);
  float dst2[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f}, st2[4];
  float d_s = 0.0f, d_s1a = 0.0f;
  bool have_st2 = false;
  for (int k = 0; k < a.nrx; ++k) {
    const float* rp = a.res + 6 * k * R + r;
    const float* g = a.g_out + 6 * k * R + r;
    dst2[5] += g[5 * R];
    const float wf = rp[5 * R];
    if (wf > 0.0f) {
      if (!have_st2) {
        for (int j = 0; j < 4; ++j) st2[j] = a.st2[j * R + r];
        have_st2 = true;
      }
      dst2[4] += g[4 * R];
      post_rx_vjp(rp, g, R, wf, s, s1a, st2, dst2, &d_s, &d_s1a);
    }
  }
  for (int j = 0; j < 6; ++j) a.d_st2[j * R + r] = dst2[j];
  a.d_ss[2 * r] = d_s;
  a.d_ss[2 * r + 1] = d_s1a;
}

}  // namespace

// Plain C entry points for ctypes.  Pointers are device pointers; each
// launches on `stream` and returns cudaGetLastError() of the launch.

extern "C" int hrt_bounce_pre_bwd(
    const float* o, const float* d, const float* st, const unsigned char* act,
    const int* idx, const float* table, const float* rx, const float* sc,
    const float* g_o2, const float* g_d2, const float* g_st2,
    const float* g_ex, const float* g_sh_d, const float* g_d2rx, int R,
    int nrx, int pc, float* d_o, float* d_d, float* d_st, float* d_pay,
    float* part, void* stream) {
  if (R <= 0) return 0;
  const int nparts = 3 * nrx + 2;
  if ((pc != kCols && pc != kEta) || nrx < 0 || nparts > kPreBwdMaxParts)
    return static_cast<int>(cudaErrorInvalidValue);
  const PreBwdArgs a{o,    d,    st,    act,  idx,    table,  rx,  sc,
                     g_o2, g_d2, g_st2, g_ex, g_sh_d, g_d2rx, R,   nrx,
                     pc,   d_o,  d_d,   d_st, d_pay,  part};
  bounce_pre_bwd_kernel<<<(R + kPreBwdRays - 1) / kPreBwdRays, kPreBwdRays,
                          nparts * kPreBwdWarps * sizeof(float),
                          static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hrt_bounce_post_bwd(
    const float* d2, const float* st2, const float* ex, const float* sh_d,
    const float* d2rx, const float* t_self, const unsigned char* crossing,
    const int* excl, const unsigned char* live, const float* t_o,
    const int* idx_o, const float* table, const float* sc,
    const float* g_out, int R, int nrx, int physical, float eps_o, int pc,
    float* d_d2, float* d_st2, float* d_ex, float* d_sh_d, float* d_d2rx,
    float* d_pay, float* d_no, int* occ, float* part, void* stream) {
  if (R <= 0) return 0;
  if ((pc != kCols && pc != 2) || ((d_no == nullptr) != (occ == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const PostBwdArgs a{d2,    st2,   ex,       sh_d,  d2rx,   t_self, crossing,
                      excl,  live,  t_o,      idx_o, table,  sc,     g_out,
                      R,     nrx,   physical, eps_o, pc,     d_d2,   d_st2,
                      d_ex,  d_sh_d, d_d2rx,  d_pay, d_no,   occ,    part};
  bounce_post_bwd_kernel<<<(R + kThreads - 1) / kThreads, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hrt_bounce_pre_bwd_slim(const float* st,
                                       const unsigned char* act,
                                       const int* idx, const float* table,
                                       const float* res, const float* g_st2,
                                       int R, float* d_st, float* d_eta,
                                       void* stream) {
  if (R <= 0) return 0;
  const PreBwdSlimArgs a{st, act, idx, table, res, g_st2, R, d_st, d_eta};
  bounce_pre_bwd_slim_kernel<<<(R + kThreads - 1) / kThreads, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hrt_bounce_post_bwd_slim(const float* st2, const int* excl,
                                        const float* table, const float* res,
                                        const float* g_out, int R, int nrx,
                                        float* d_st2, float* d_ss,
                                        void* stream) {
  if (R <= 0) return 0;
  const PostBwdSlimArgs a{st2, excl, table, res, g_out, R, nrx, d_st2, d_ss};
  bounce_post_bwd_slim_kernel<<<(R + kThreads - 1) / kThreads, kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
