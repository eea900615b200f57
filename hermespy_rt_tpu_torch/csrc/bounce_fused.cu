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

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 27;           // payload columns: 15 geometry + 12 eta
constexpr int kGeom = 15;
constexpr int kEta = 12;
// eta columns (ops/fresnel.py::ETA_FIELDS)
constexpr int kEtaAbsPow2 = 3, kEtaAbsInvSqrt = 4, kEtaSqrtRe = 5,
              kEtaSqrtIm = 6, kEtaInvRe = 7, kEtaInvIm = 8, kEtaR = 9,
              kEtaS = 10, kEtaS1Alpha = 11;

constexpr float kFltEps = 0x1p-23f;            // FLT_EPSILON
constexpr float kClip = 0x1.fffffcp-1f;        // 1 - FLT_EPSILON
constexpr float kLight = 299792448.0f;         // f32(299792458)
constexpr float kOffset = 0x1.a36e2ep-14f;     // f32(1e-4)
constexpr float kHalfPi = 0x1.921fb6p+0f;      // f32(pi / 2)
constexpr float kPi = 0x1.921fb6p+1f;          // f32(pi)
constexpr float kPhase = 0x1.99999ap-4f;       // f32(0.1)
constexpr float kNormMin = 0x1.0c6f7ap-20f;    // f32(1e-6)

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

__device__ __forceinline__ void cross3(const float* a, const float* b,
                                       float* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// ops/geometry.py::_asin_core and ::fast_acos, in their operation order
__device__ __forceinline__ float asin_core(float x, float x2) {
  float p = 0x1.5c99a6p-5f;
  p = p * x2 + 0x1.87bb68p-6f;
  p = p * x2 + 0x1.750e1cp-5f;
  p = p * x2 + 0x1.32f9e6p-4f;
  p = p * x2 + 0x1.5555f6p-3f;
  p = p * x2 + 1.0f;
  return x * p;
}

__device__ __forceinline__ float fast_acos(float x) {
  const float ax = fabsf(x);
  const float asin_inner = asin_core(x, x * x);
  const float s = fmaxf(0.5f * (1.0f - ax), 0.0f);
  const float acos_pos = 2.0f * asin_core(sqrtf(s), s);
  const float acos_outer = x >= 0.0f ? acos_pos : kPi - acos_pos;
  return ax <= 0.5f ? kHalfPi - asin_inner : acos_outer;
}

__device__ __forceinline__ float safe_sqrt(float x) {
  return x > 0.0f ? sqrtf(x) : 0.0f;
}

// ops/fresnel.py::_cdiv: a / b, 0 where |b| = 0
__device__ __forceinline__ void cdiv(float a_re, float a_im, float b_re,
                                     float b_im, float* c_re, float* c_im) {
  const float den = b_re * b_re + b_im * b_im;
  const bool pos = den > 0.0f;
  const float sd = pos ? den : 1.0f;
  const float x = (a_re * b_re + a_im * b_im) / sd;
  const float y = (a_im * b_re - a_re * b_im) / sd;
  *c_re = pos ? x : 0.0f;
  *c_im = pos ? y : 0.0f;
}

// the vjp of cdiv: cotangents of (a_re, a_im, b_re, b_im) from (dc_re,
// dc_im); zero where the denominator is zero, as autograd of the guard gives
__device__ __forceinline__ void cdiv_vjp(float a_re, float a_im, float b_re,
                                         float b_im, float dc_re, float dc_im,
                                         float* da_re, float* da_im,
                                         float* db_re, float* db_im) {
  const float den = b_re * b_re + b_im * b_im;
  if (!(den > 0.0f)) {
    *da_re = *da_im = *db_re = *db_im = 0.0f;
    return;
  }
  const float n_re = a_re * b_re + a_im * b_im;
  const float n_im = a_im * b_re - a_re * b_im;
  const float dn_re = dc_re / den, dn_im = dc_im / den;
  const float dden = -(dc_re * n_re + dc_im * n_im) / (den * den);
  *da_re = dn_re * b_re - dn_im * b_im;
  *da_im = dn_re * b_im + dn_im * b_re;
  *db_re = dn_re * a_re + dn_im * a_im + 2.0f * b_re * dden;
  *db_im = dn_re * a_im - dn_im * a_re + 2.0f * b_im * dden;
}

// ops/fresnel.py::refl_coefs before the TIR select and the 1 - s factor;
// keeps the intermediates the vjp needs
struct Refl {
  bool tir;
  float sin2, q_re, q_im, x_re, x_im, c2r, c2i, sec_re, sec_im, sc1_re,
      sc1_im, te_re, te_im, tm_re, tm_im;
};

__device__ __forceinline__ Refl refl_core(const float* eta, float cos_t1,
                                          float sin_t1) {
  Refl f;
  f.tir = eta[kEtaAbsInvSqrt] * sin_t1 > 1.0f - kFltEps;
  f.sin2 = sin_t1 * sin_t1;
  f.q_re = eta[kEtaInvRe] / eta[kEtaAbsPow2];
  f.q_im = eta[kEtaInvIm] / eta[kEtaAbsPow2];
  f.x_re = 1.0f + f.q_re * f.sin2;
  f.x_im = 1.0f - f.q_im * f.sin2;
  f.c2r = safe_sqrt(f.x_re);
  f.c2i = safe_sqrt(f.x_im);
  const float esr = eta[kEtaSqrtRe], esi = eta[kEtaSqrtIm];
  f.sec_re = esr * f.c2r - esi * f.c2i;
  f.sec_im = esr * f.c2i + esi * f.c2r;
  cdiv(cos_t1 - f.sec_re, -f.sec_im, cos_t1 + f.sec_re, f.sec_im, &f.te_re,
       &f.te_im);
  f.sc1_re = esr * cos_t1;
  f.sc1_im = esi * cos_t1;
  cdiv(f.sc1_re - f.c2r, f.sc1_im - f.c2i, f.sc1_re + f.c2r,
       f.sc1_im + f.c2i, &f.tm_re, &f.tm_im);
  return f;
}

// refl_coefs' four outputs (TIR select, 1 - s factor)
__device__ __forceinline__ void refl_out(const Refl& f, const float* eta,
                                         float* r) {
  const float rr = eta[kEtaR];
  r[0] = f.tir ? 1.0f : f.te_re * rr;
  r[1] = f.tir ? 0.0f : f.te_im * rr;
  r[2] = f.tir ? 1.0f : f.tm_re * rr;
  r[3] = f.tir ? 0.0f : f.tm_im * rr;
}

// ops/scattering.py::scat_coefs with the trig handed in; keeps the
// intermediates the vjp needs
struct Scat {
  float dth, e, f, rough, spec, diffu, te_re0, tm_re0, phase, sp, te_im0,
      tm_im0, norm2, norm, inv;
  bool do_norm;
  float out[4];
};

__device__ __forceinline__ Scat scat_core(float theta_s, float theta_i,
                                          float s, float s1a, float cos_ts,
                                          float cos_ti, float sin_ti) {
  Scat c;
  c.dth = fabsf(theta_s - theta_i);
  c.e = expf(-s1a * c.dth);
  c.f = s * c.e;
  c.rough = 1.0f / (1.0f + s1a);
  c.spec = c.rough * cos_ts;
  c.diffu = (1.0f - c.rough) * cos_ts;
  c.te_re0 = c.f * (c.spec + c.diffu);
  c.tm_re0 = c.f * (c.spec * cos_ti + c.diffu);
  c.phase = s1a * sin_ti * kPhase;
  c.sp = sinf(c.phase);
  c.te_im0 = c.te_re0 * c.sp;
  c.tm_im0 = c.tm_re0 * c.sp;
  c.norm2 = c.te_re0 * c.te_re0 + c.te_im0 * c.te_im0 +
            c.tm_re0 * c.tm_re0 + c.tm_im0 * c.tm_im0;
  c.norm = sqrtf(c.norm2 > 0.0f ? c.norm2 : 1.0f);
  c.do_norm = c.norm > kNormMin;
  c.inv = c.do_norm ? 1.0f / c.norm : 1.0f;
  c.out[0] = c.te_re0 * c.inv;
  c.out[1] = c.te_im0 * c.inv;
  c.out[2] = c.tm_re0 * c.inv;
  c.out[3] = c.tm_im0 * c.inv;
  return c;
}

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
  const float* row = a.table + static_cast<size_t>(safe) * kCols;
  float v0[3], e1[3], e2[3], n[3], vel[3], eta[kEta];
  for (int c = 0; c < 3; ++c) {
    v0[c] = __ldg(row + c);
    e1[c] = __ldg(row + 3 + c);
    e2[c] = __ldg(row + 6 + c);
    n[c] = __ldg(row + 9 + c);
    vel[c] = __ldg(row + 12 + c);
  }
  for (int j = 0; j < kEta; ++j) eta[j] = __ldg(row + kGeom + j);
  const float fslm = __ldg(a.sc), k_dop = __ldg(a.sc + 1);
  float o[3], d[3], st[6];
  for (int c = 0; c < 3; ++c) {
    o[c] = a.o[3 * r + c];
    d[c] = a.d[3 * r + c];
  }
  for (int j = 0; j < 6; ++j) st[j] = a.st[j * R + r];

  // ops/shade.py::shade_a
  float pvec[3], sv[3], qvec[3];
  cross3(d, e2, pvec);
  const float det = dot3(e1, pvec);
  for (int c = 0; c < 3; ++c) sv[c] = o[c] - v0[c];
  cross3(sv, e1, qvec);
  const float inv_det = 1.0f / (det == 0.0f ? 1.0f : det);
  const float t = live ? dot3(e2, qvec) * inv_det : 0.0f;

  const float ndot = dot3(n, d);
  const float cos_t1 = clampf(fabsf(ndot), 0.0f, kClip);
  const float sin_t1 = sqrtf(1.0f - cos_t1 * cos_t1);
  const float theta = fast_acos(cos_t1);

  float rc[4];
  refl_out(refl_core(eta, cos_t1, sin_t1), eta, rc);
  const float fsl = fslm * t;
  const float fsl2 = fsl * fsl;
  const float fscale = fsl2 > 1.0f ? 1.0f / fsl2 : 1.0f;
  for (int j = 0; j < 4; ++j) rc[j] = rc[j] * fscale;

  const float new_ate_re = st[0] * rc[0] - st[1] * rc[1];
  const float new_ate_im = st[0] * rc[1] + st[1] * rc[0];
  const float new_atm_re = st[2] * rc[2] - st[3] * rc[3];
  const float new_atm_im = st[2] * rc[3] + st[3] * rc[2];
  const float st2[6] = {
      live ? new_ate_re : st[0], live ? new_ate_im : st[1],
      live ? new_atm_re : st[2], live ? new_atm_im : st[3],
      st[4] + (live ? t / kLight : 0.0f), 0.0f};

  const float two_dn = 2.0f * dot3(d, n);
  float d_ref[3], o2[3], d2[3], dd[3];
  for (int c = 0; c < 3; ++c) {
    d_ref[c] = d[c] - two_dn * n[c];
    const float hitp = o[c] + t * d[c];
    const float o_ref = hitp + kOffset * d_ref[c];
    o2[c] = live ? o_ref : o[c];
    d2[c] = live ? d_ref[c] : d[c];
    dd[c] = d_ref[c] - d[c];
  }
  const float freq2 = st[5] + (live ? dot3(dd, vel) * k_dop : 0.0f);

  for (int c = 0; c < 3; ++c) {
    a.o2[3 * r + c] = o2[c];
    a.d2[3 * r + c] = d2[c];
  }
  for (int j = 0; j < 5; ++j) a.st2[j * R + r] = st2[j];
  a.st2[5 * R + r] = freq2;
  a.ex[r] = theta;
  a.ex[R + r] = cos_t1;
  a.ex[2 * R + r] = ndot;

  // per-RX shadow setup (tracer.bounce_step's scatter-pre lines)
  const float dint = dot3(d2, n);
  for (int k = 0; k < a.nrx; ++k) {
    const size_t i = k * R + r;
    float ds[3];
    for (int c = 0; c < 3; ++c) ds[c] = __ldg(a.rx + 3 * k + c) - o2[c];
    const float n2 = dot3(ds, ds);
    const float d2rx = n2 > 0.0f ? sqrtf(n2) : 0.0f;
    const float den = d2rx > 0.0f ? d2rx : 1.0f;
    for (int c = 0; c < 3; ++c) ds[c] = ds[c] / den;
    const float dsn = dot3(ds, n);
    const float t_self = -kOffset * dint / (dsn == 0.0f ? 1.0f : dsn);
    for (int c = 0; c < 3; ++c) {
      a.sh_d[3 * i + c] = ds[c];
      a.sh_o[3 * i + c] = a.physical ? o2[c] + a.eps_o * ds[c] : o2[c];
    }
    a.d2rx[i] = d2rx;
    a.t_self[i] = t_self;
    a.crossing[i] = (dsn * dint < 0.0f) && live;
  }
  a.excl[r] = live ? idx : -1;
  a.live_out[r] = live;
  a.mat[r] = __ldg(a.material + safe);
  a.res[r] = cos_t1;
  a.res[R + r] = sin_t1;
  a.res[2 * R + r] = fscale;
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
  const float two_eps = 2.0f * a.eps_o;

  float th_c = theta, cos_c = cos_t1;  // the reference clobber chain
  for (int k = 0; k < a.nrx; ++k) {
    const size_t i = k * R + r;
    float ds[3];
    for (int c = 0; c < 3; ++c) ds[c] = a.sh_d[3 * i + c];
    const float d2rx = a.d2rx[i], t_self = a.t_self[i], t_o = a.t_o[i];
    const bool crossing = a.crossing[i] != 0;
    const int idx_o = a.idx_o[i];

    // self-hit merge and occlusion decisions
    int idx_m;
    bool blocked;
    if (a.physical) {
      const float limit = d2rx - two_eps;
      const float t_self_q = t_self - a.eps_o;
      const bool closer = crossing && t_self_q > kFltEps &&
                          t_self_q <= limit && t_self_q < t_o;
      const float t_m = closer ? t_self_q : t_o;
      idx_m = closer ? excl : idx_o;
      blocked = idx_m >= 0 && t_m <= limit;
    } else {
      const bool closer = crossing && t_self > kFltEps && t_self < t_o;
      const float t_m = closer ? t_self : t_o;
      idx_m = closer ? excl : idx_o;
      blocked = idx_m >= 0 && t_m <= 1.0f;
    }

    const float ds_dot_n = dot3(ds, n);
    const float cos_ts = clampf(ds_dot_n, -kClip, kClip);
    const float theta_s = fast_acos(cos_ts);
    float theta_i, cos_ti;
    bool write;
    if (a.physical) {
      theta_i = theta;
      cos_ti = cos_t1;
      write = live && !blocked && ds_dot_n * ndot < 0.0f;
    } else {
      if (idx_m >= 0) {
        const float* orow = a.table + static_cast<size_t>(idx_m) * kCols;
        const float n_o[3] = {__ldg(orow + 9), __ldg(orow + 10),
                              __ldg(orow + 11)};
        cos_c = clampf(fabsf(dot3(n_o, ds)), 0.0f, kClip);
        th_c = fast_acos(cos_c);
      }
      theta_i = th_c;
      cos_ti = cos_c;
      write = live && !blocked;
    }
    const float sin_ti = sqrtf(1.0f - cos_ti * cos_ti);
    const Scat sc = scat_core(theta_s, theta_i, s, s1a, cos_ts, cos_ti,
                              sin_ti);
    const float out_te_re = st2[0] * sc.out[0] - st2[1] * sc.out[1];
    const float out_te_im = st2[0] * sc.out[1] + st2[1] * sc.out[0];
    const float out_tm_re = st2[2] * sc.out[2] - st2[3] * sc.out[3];
    const float out_tm_im = st2[2] * sc.out[3] + st2[3] * sc.out[2];

    const float fsl_s = fslm * d2rx;
    const float fsl_s2 = fsl_s * fsl_s;
    const float sscale = fsl_s2 > 1.0f ? 1.0f / fsl_s2 : 1.0f;
    const float wf = (write ? 1.0f : 0.0f) * sscale;
    float dsd[3];
    for (int c = 0; c < 3; ++c) dsd[c] = ds[c] - d2[c];
    const float scat_dop = dot3(dsd, vel) * k_dop;

    float* out = a.out + 6 * k * R + r;
    out[0] = out_te_re * wf;
    out[R] = out_te_im * wf;
    out[2 * R] = out_tm_re * wf;
    out[3 * R] = out_tm_im * wf;
    out[4 * R] = write ? st2[4] + d2rx / kLight : 0.0f;
    out[5 * R] = st2[5] - (live ? scat_dop : 0.0f);
    float* res = a.res + 6 * k * R + r;
    res[0] = theta_s;
    res[R] = theta_i;
    res[2 * R] = cos_ts;
    res[3 * R] = cos_ti;
    res[4 * R] = sin_ti;
    res[5 * R] = wf;
    a.write[i] = write;
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

// vjp of _post_light for one RX: adds the cotangents of (s, s1_alpha) and of
// the state rows 0-3 (the tau and freq rows are handled by the caller)
__device__ __forceinline__ void post_rx_vjp(const float* rp, const float* dout,
                                            size_t R, float wf, float s,
                                            float s1a, const float* st2,
                                            float* dst2, float* d_s,
                                            float* d_s1a) {
  const float theta_s = rp[0], theta_i = rp[R], cos_ts = rp[2 * R],
              cos_ti = rp[3 * R], sin_ti = rp[4 * R];
  const Scat c = scat_core(theta_s, theta_i, s, s1a, cos_ts, cos_ti, sin_ti);
  const float g0 = dout[0] * wf, g1 = dout[R] * wf, g2 = dout[2 * R] * wf,
              g3 = dout[3 * R] * wf;
  dst2[0] += g0 * c.out[0] + g1 * c.out[1];
  dst2[1] += g1 * c.out[0] - g0 * c.out[1];
  dst2[2] += g2 * c.out[2] + g3 * c.out[3];
  dst2[3] += g3 * c.out[2] - g2 * c.out[3];
  const float dy[4] = {g0 * st2[0] + g1 * st2[1], g1 * st2[0] - g0 * st2[1],
                       g2 * st2[2] + g3 * st2[3], g3 * st2[2] - g2 * st2[3]};
  const float x[4] = {c.te_re0, c.te_im0, c.tm_re0, c.tm_im0};
  float dx[4];
  for (int j = 0; j < 4; ++j) dx[j] = dy[j] * c.inv;
  if (c.do_norm) {
    const float d_inv = dy[0] * x[0] + dy[1] * x[1] + dy[2] * x[2] +
                        dy[3] * x[3];
    const float d_norm = -d_inv * c.inv * c.inv;
    if (c.norm2 > 0.0f) {
      const float d_n2 = d_norm / (2.0f * c.norm);
      for (int j = 0; j < 4; ++j) dx[j] += 2.0f * x[j] * d_n2;
    }
  }
  const float dte_re0 = dx[0] + dx[1] * c.sp;
  const float dtm_re0 = dx[2] + dx[3] * c.sp;
  const float d_sp = dx[1] * c.te_re0 + dx[3] * c.tm_re0;
  const float d_phase = d_sp * cosf(c.phase);
  float ds1a = d_phase * kPhase * sin_ti;
  const float d_f = dte_re0 * (c.spec + c.diffu) +
                    dtm_re0 * (c.spec * cos_ti + c.diffu);
  const float d_spec = dte_re0 * c.f + dtm_re0 * c.f * cos_ti;
  const float d_diffu = (dte_re0 + dtm_re0) * c.f;
  const float d_rough = (d_spec - d_diffu) * cos_ts;
  ds1a += -d_rough * c.rough * c.rough;
  const float d_e = d_f * s;
  ds1a += -(d_e * c.e) * c.dth;
  *d_s += d_f * c.e;
  *d_s1a += ds1a;
}

// vjp of _pre_light for a live ray: the state cotangent rows 0-3 and the
// eta cotangent (rows 3, 5, 6, 7, 8, 9; the others stay 0)
__device__ __forceinline__ void pre_vjp(const float* eta, float cos_t1,
                                        float sin_t1, float fscale,
                                        const float* st, const float* g,
                                        float* dst, float* d_eta) {
  const Refl f = refl_core(eta, cos_t1, sin_t1);
  float rc[4];
  refl_out(f, eta, rc);
  for (int j = 0; j < 4; ++j) rc[j] = rc[j] * fscale;
  dst[0] = g[0] * rc[0] + g[1] * rc[1];
  dst[1] = g[1] * rc[0] - g[0] * rc[1];
  dst[2] = g[2] * rc[2] + g[3] * rc[3];
  dst[3] = g[3] * rc[2] - g[2] * rc[3];
  if (f.tir) return;
  const float h_te_re = (g[0] * st[0] + g[1] * st[1]) * fscale;
  const float h_te_im = (g[1] * st[0] - g[0] * st[1]) * fscale;
  const float h_tm_re = (g[2] * st[2] + g[3] * st[3]) * fscale;
  const float h_tm_im = (g[3] * st[2] - g[2] * st[3]) * fscale;
  const float rr = eta[kEtaR];
  d_eta[kEtaR] = h_te_re * f.te_re + h_te_im * f.te_im + h_tm_re * f.tm_re +
                 h_tm_im * f.tm_im;
  float da_re, da_im, db_re, db_im;
  cdiv_vjp(cos_t1 - f.sec_re, -f.sec_im, cos_t1 + f.sec_re, f.sec_im,
           h_te_re * rr, h_te_im * rr, &da_re, &da_im, &db_re, &db_im);
  const float d_sec_re = db_re - da_re, d_sec_im = db_im - da_im;
  cdiv_vjp(f.sc1_re - f.c2r, f.sc1_im - f.c2i, f.sc1_re + f.c2r,
           f.sc1_im + f.c2i, h_tm_re * rr, h_tm_im * rr, &da_re, &da_im,
           &db_re, &db_im);
  const float esr = eta[kEtaSqrtRe], esi = eta[kEtaSqrtIm];
  float d_c2r = db_re - da_re, d_c2i = db_im - da_im;
  float d_esr = (da_re + db_re) * cos_t1, d_esi = (da_im + db_im) * cos_t1;
  d_esr += d_sec_re * f.c2r + d_sec_im * f.c2i;
  d_esi += d_sec_im * f.c2r - d_sec_re * f.c2i;
  d_c2r += d_sec_re * esr + d_sec_im * esi;
  d_c2i += d_sec_im * esr - d_sec_re * esi;
  const float d_xre = f.x_re > 0.0f ? d_c2r / (2.0f * f.c2r) : 0.0f;
  const float d_xim = f.x_im > 0.0f ? d_c2i / (2.0f * f.c2i) : 0.0f;
  const float d_qre = d_xre * f.sin2, d_qim = -d_xim * f.sin2;
  const float eap2 = eta[kEtaAbsPow2];
  d_eta[kEtaAbsPow2] = -(d_qre * f.q_re + d_qim * f.q_im) / eap2;
  d_eta[kEtaSqrtRe] = d_esr;
  d_eta[kEtaSqrtIm] = d_esi;
  d_eta[kEtaInvRe] = d_qre / eap2;
  d_eta[kEtaInvIm] = d_qim / eap2;
}

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
