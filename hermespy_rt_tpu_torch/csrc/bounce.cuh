// Device functions of the fused bounce stages, shared by the forward kernels
// (bounce_fused.cu) and the per-stage backward kernels (bounce_bwd.cu), so
// that the decisions a backward recomputes are the forward's own: the pre
// stage's per-ray body (pre_forward) and per-RX shadow set-up (shadow_rx),
// the post stage's decisions and per-RX body (post_rx), and the hand-derived
// vjps of the Fresnel and scattering chains (pre_vjp, post_rx_vjp,
// scat_vjp), each honouring the plain version's guards as torch autograd
// differentiates them.  Built with -fmad=false: every product and sum is
// rounded on its own, in the plain versions' operation order.
// pre_forward and post_rx take the forward's transmission modes as a
// template parameter (kTransmission, kSpawn), 0 by default: what the
// backwards and the reflect-only forward compile is the same code at 0.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 27;           // payload columns: 15 geometry + 12 eta
constexpr int kGeom = 15;
constexpr int kEta = 12;
constexpr int kNormal = 9;          // the normal's first payload column
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

// the fused forward's transmission modes (TracerConfig's flags, straight
// refraction only), bits of the forward kernels' template parameter
constexpr int kTransmission = 1;  // blocked shadow rays pass their blocker
constexpr int kSpawn = 2;         // rays transmit by their pattern bits

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

// torch.sign: 0 at 0 (the derivative autograd gives abs there)
__device__ __forceinline__ float signf(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

// ops/geometry.py::_asin_core and ::fast_acos, in their operation order
// (the polynomial ::_ASIN_POLY in Horner form); *dp, when given, is the
// polynomial's derivative in x2
__device__ __forceinline__ float asin_poly(float x2, float* dp = nullptr) {
  const float c[5] = {0x1.87bb68p-6f, 0x1.750e1cp-5f, 0x1.32f9e6p-4f,
                      0x1.5555f6p-3f, 1.0f};
  float p = 0x1.5c99a6p-5f, d = 0.0f;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    d = d * x2 + p;
    p = p * x2 + c[i];
  }
  if (dp != nullptr) *dp = d;
  return p;
}

__device__ __forceinline__ float asin_core(float x, float x2) {
  return x * asin_poly(x2);
}

__device__ __forceinline__ float fast_acos(float x) {
  const float ax = fabsf(x);
  const float asin_inner = asin_core(x, x * x);
  const float s = fmaxf(0.5f * (1.0f - ax), 0.0f);
  const float acos_pos = 2.0f * asin_core(sqrtf(s), s);
  const float acos_outer = x >= 0.0f ? acos_pos : kPi - acos_pos;
  return ax <= 0.5f ? kHalfPi - asin_inner : acos_outer;
}

// d fast_acos / dx: the derivative of the polynomial (not of acos), of the
// branch the forward takes; |x| < 1 on every path (the callers clamp)
__device__ __forceinline__ float fast_acos_grad(float x) {
  const float ax = fabsf(x);
  float dp;
  if (ax <= 0.5f) {
    const float p = asin_poly(x * x, &dp);
    return -(p + 2.0f * (x * x) * dp);
  }
  // acos_pos = 2 r p(s), r = sqrt(s), s = (1 - |x|) / 2
  const float s = fmaxf(0.5f * (1.0f - ax), 0.0f);
  const float p = asin_poly(s, &dp);
  const float r = sqrtf(s);
  return -0.5f * (2.0f * (r * dp + p / (2.0f * r)));
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

// ops/fresnel.py::trans_coefs: (T_TE re, im, T_TM re, im), 0 under total
// internal reflection, from refl_core's cos(t2) terms (its reflection
// quotients go unused); reads the eta columns 3-8
__device__ __forceinline__ void trans_out(const float* eta, float cos_t1,
                                          float sin_t1, float* t) {
  const Refl f = refl_core(eta, cos_t1, sin_t1);
  float te_re, te_im, tm_re, tm_im;
  cdiv(2.0f * cos_t1, 0.0f, cos_t1 + f.sec_re, f.sec_im, &te_re, &te_im);
  cdiv(2.0f * f.sc1_re, 2.0f * f.sc1_im, f.sc1_re + f.c2r, f.sc1_im + f.c2i,
       &tm_re, &tm_im);
  t[0] = f.tir ? 0.0f : te_re;
  t[1] = f.tir ? 0.0f : te_im;
  t[2] = f.tir ? 0.0f : tm_re;
  t[3] = f.tir ? 0.0f : tm_im;
}

// ops/shade.py::through_blocker for one blocked (ray, RX): its gains amp
// times the blocker's transmission coefficients at the shadow direction
// ds; the blocker's normal and eta columns 3-8 read from its payload row
__device__ __forceinline__ void through_blocker(const float* table,
                                                int blocker, const float* ds,
                                                float* amp) {
  const float* row = table + static_cast<size_t>(blocker) * kCols;
  float n[3], eta[kEta];
  for (int c = 0; c < 3; ++c) n[c] = __ldg(row + kNormal + c);
  for (int j = kEtaAbsPow2; j <= kEtaInvIm; ++j)
    eta[j] = __ldg(row + kGeom + j);
  const float cos1 = clampf(fabsf(dot3(n, ds)), 0.0f, kClip);
  const float sin1 = sqrtf(1.0f - cos1 * cos1);
  float t[4];
  trans_out(eta, cos1, sin1, t);
  // the plain version's 1 + b (T - 1) and b T at b = 1
  const float f_te_re = 1.0f + (t[0] - 1.0f), f_te_im = t[1];
  const float f_tm_re = 1.0f + (t[2] - 1.0f), f_tm_im = t[3];
  const float te_re = amp[0] * f_te_re - amp[1] * f_te_im;
  const float te_im = amp[0] * f_te_im + amp[1] * f_te_re;
  const float tm_re = amp[2] * f_tm_re - amp[3] * f_tm_im;
  const float tm_im = amp[2] * f_tm_im + amp[3] * f_tm_re;
  amp[0] = te_re;
  amp[1] = te_im;
  amp[2] = tm_re;
  amp[3] = tm_im;
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
// pre stage body (ops/shade.py::shade_a, then tracer.bounce_step's
// scatter-pre lines per RX)

struct PreFwd {
  float pvec[3], det, sv[3], qvec[3], inv_det, tq, t;
  float ndot, cos_t1, sin_t1, theta;
  float rc[4];         // refl_coefs before the free-space scale
  float fsl, fsl2, fscale;
  float two_dn, d_ref[3], o2[3], d2[3], dd[3];
  float st2[6];
};

// the hit payload row: v0, e1, e2, normal, velocity, eta
struct Payload {
  float v0[3], e1[3], e2[3], n[3], vel[3], eta[kEta];
};

__device__ __forceinline__ Payload load_payload(const float* row) {
  Payload p;
  for (int c = 0; c < 3; ++c) {
    p.v0[c] = __ldg(row + c);
    p.e1[c] = __ldg(row + 3 + c);
    p.e2[c] = __ldg(row + 6 + c);
    p.n[c] = __ldg(row + 9 + c);
    p.vel[c] = __ldg(row + 12 + c);
  }
  for (int j = 0; j < kEta; ++j) p.eta[j] = __ldg(row + kGeom + j);
  return p;
}

// kTrans & kSpawn: a ray with `transmit` takes the transmission
// coefficients and keeps its direction (ops/shade.py::shade_a's straight
// continuation)
template <int kTrans = 0>
__device__ __forceinline__ PreFwd pre_forward(const float* o, const float* d,
                                              const float* st,
                                              const Payload& p, float fslm,
                                              float k_dop, bool live,
                                              bool transmit = false) {
  constexpr bool kSpawnT = (kTrans & kSpawn) != 0;
  PreFwd f;
  cross3(d, p.e2, f.pvec);
  f.det = dot3(p.e1, f.pvec);
  for (int c = 0; c < 3; ++c) f.sv[c] = o[c] - p.v0[c];
  cross3(f.sv, p.e1, f.qvec);
  f.inv_det = 1.0f / (f.det == 0.0f ? 1.0f : f.det);
  f.tq = dot3(p.e2, f.qvec);
  f.t = live ? f.tq * f.inv_det : 0.0f;

  f.ndot = dot3(p.n, d);
  f.cos_t1 = clampf(fabsf(f.ndot), 0.0f, kClip);
  f.sin_t1 = sqrtf(1.0f - f.cos_t1 * f.cos_t1);
  f.theta = fast_acos(f.cos_t1);

  if (kSpawnT && transmit)
    trans_out(p.eta, f.cos_t1, f.sin_t1, f.rc);
  else
    refl_out(refl_core(p.eta, f.cos_t1, f.sin_t1), p.eta, f.rc);
  f.fsl = fslm * f.t;
  f.fsl2 = f.fsl * f.fsl;
  f.fscale = f.fsl2 > 1.0f ? 1.0f / f.fsl2 : 1.0f;
  float rc[4];
  for (int j = 0; j < 4; ++j) rc[j] = f.rc[j] * f.fscale;

  const float new_ate_re = st[0] * rc[0] - st[1] * rc[1];
  const float new_ate_im = st[0] * rc[1] + st[1] * rc[0];
  const float new_atm_re = st[2] * rc[2] - st[3] * rc[3];
  const float new_atm_im = st[2] * rc[3] + st[3] * rc[2];
  f.st2[0] = live ? new_ate_re : st[0];
  f.st2[1] = live ? new_ate_im : st[1];
  f.st2[2] = live ? new_atm_re : st[2];
  f.st2[3] = live ? new_atm_im : st[3];
  f.st2[4] = st[4] + (live ? f.t / kLight : 0.0f);

  f.two_dn = 2.0f * dot3(d, p.n);
  for (int c = 0; c < 3; ++c) {
    f.d_ref[c] = (kSpawnT && transmit) ? d[c] : d[c] - f.two_dn * p.n[c];
    const float hitp = o[c] + f.t * d[c];
    const float o_ref = hitp + kOffset * f.d_ref[c];
    f.o2[c] = live ? o_ref : o[c];
    f.d2[c] = live ? f.d_ref[c] : d[c];
    f.dd[c] = f.d_ref[c] - d[c];
  }
  f.st2[5] = st[5] + (live ? dot3(f.dd, p.vel) * k_dop : 0.0f);
  return f;
}

// one RX's shadow-ray set-up from the bounced origin o2
struct ShadowRx {
  float ds_un[3], n2, d2rx, den, ds[3], dsn, t_self;
  bool crossing;
};

__device__ __forceinline__ ShadowRx shadow_rx(const float* rx,
                                              const float* o2, const float* n,
                                              float dint, bool live) {
  ShadowRx s;
  for (int c = 0; c < 3; ++c) s.ds_un[c] = __ldg(rx + c) - o2[c];
  s.n2 = dot3(s.ds_un, s.ds_un);
  s.d2rx = s.n2 > 0.0f ? sqrtf(s.n2) : 0.0f;
  s.den = s.d2rx > 0.0f ? s.d2rx : 1.0f;
  for (int c = 0; c < 3; ++c) s.ds[c] = s.ds_un[c] / s.den;
  s.dsn = dot3(s.ds, n);
  s.t_self = -kOffset * dint / (s.dsn == 0.0f ? 1.0f : s.dsn);
  s.crossing = (s.dsn * dint < 0.0f) && live;
  return s;
}

// ---------------------------------------------------------------------------
// post stage body

// self-hit merge and occlusion decisions: the merged occluder (-1: none)
__device__ __forceinline__ int post_decide(bool physical, float eps_o,
                                          float d2rx, float t_self,
                                          bool crossing, float t_o, int idx_o,
                                          int excl, bool* blocked) {
  if (physical) {
    const float limit = d2rx - 2.0f * eps_o;
    const float t_self_q = t_self - eps_o;
    const bool closer = crossing && t_self_q > kFltEps &&
                        t_self_q <= limit && t_self_q < t_o;
    const float t_m = closer ? t_self_q : t_o;
    const int idx_m = closer ? excl : idx_o;
    *blocked = idx_m >= 0 && t_m <= limit;
    return idx_m;
  }
  const bool closer = crossing && t_self > kFltEps && t_self < t_o;
  const float t_m = closer ? t_self : t_o;
  const int idx_m = closer ? excl : idx_o;
  *blocked = idx_m >= 0 && t_m <= 1.0f;
  return idx_m;
}

struct PostRx {
  int idx_m;
  bool occ, write;
  float dsn, cos_ts, theta_s;
  float n_o[3], dno;  // the occluder's normal and n_o . ds (reference, occ)
  float theta_i, cos_ti, sin_ti;
  Scat sc;
  float amp[4];       // st2 (x) S, before the write scale
  float fsl_s, fsl_s2, sscale, wf;
  float dsd[3], dop;  // ds - d2 and its Doppler dot
};

// one RX of the post stage; (th_c, cos_c) is the reference clobber carry.
// Under physical parity, kTrans & kTransmission: a blocked pair is written
// and its gains pass its merged blocker (through_blocker); kTrans & kSpawn:
// a ray with `transmit` writes into the exit side's hemisphere
template <int kTrans = 0>
__device__ __forceinline__ PostRx post_rx(
    bool physical, float eps_o, const float* table, const float* ds,
    float d2rx, float t_self, bool crossing, float t_o, int idx_o, int excl,
    bool live, const float* n, const float* vel, float s, float s1a,
    const float* d2, const float* st2, float theta, float cos_t1, float ndot,
    float fslm, float* th_c, float* cos_c, bool transmit = false) {
  PostRx q;
  bool blocked;
  q.idx_m = post_decide(physical, eps_o, d2rx, t_self, crossing, t_o, idx_o,
                        excl, &blocked);
  q.dsn = dot3(ds, n);
  q.cos_ts = clampf(q.dsn, -kClip, kClip);
  q.theta_s = fast_acos(q.cos_ts);
  q.occ = false;
  if (physical) {
    q.theta_i = theta;
    q.cos_ti = cos_t1;
    if constexpr (kTrans == 0) {
      q.write = live && !blocked && q.dsn * ndot < 0.0f;
    } else {
      const bool hemi = ((kTrans & kSpawn) && transmit)
                            ? q.dsn * ndot > 0.0f
                            : q.dsn * ndot < 0.0f;
      q.write = live && ((kTrans & kTransmission) || !blocked) && hemi;
    }
  } else {
    q.occ = q.idx_m >= 0;
    if (q.occ) {
      const float* orow = table + static_cast<size_t>(q.idx_m) * kCols;
      for (int c = 0; c < 3; ++c) q.n_o[c] = __ldg(orow + kNormal + c);
      q.dno = dot3(q.n_o, ds);
      *cos_c = clampf(fabsf(q.dno), 0.0f, kClip);
      *th_c = fast_acos(*cos_c);
    }
    q.theta_i = *th_c;
    q.cos_ti = *cos_c;
    q.write = live && !blocked;
  }
  q.sin_ti = sqrtf(1.0f - q.cos_ti * q.cos_ti);
  q.sc = scat_core(q.theta_s, q.theta_i, s, s1a, q.cos_ts, q.cos_ti,
                   q.sin_ti);
  q.amp[0] = st2[0] * q.sc.out[0] - st2[1] * q.sc.out[1];
  q.amp[1] = st2[0] * q.sc.out[1] + st2[1] * q.sc.out[0];
  q.amp[2] = st2[2] * q.sc.out[2] - st2[3] * q.sc.out[3];
  q.amp[3] = st2[2] * q.sc.out[3] + st2[3] * q.sc.out[2];
  if constexpr ((kTrans & kTransmission) != 0) {
    if (blocked) through_blocker(table, q.idx_m, ds, q.amp);
  }
  q.fsl_s = fslm * d2rx;
  q.fsl_s2 = q.fsl_s * q.fsl_s;
  q.sscale = q.fsl_s2 > 1.0f ? 1.0f / q.fsl_s2 : 1.0f;
  q.wf = (q.write ? 1.0f : 0.0f) * q.sscale;
  for (int c = 0; c < 3; ++c) q.dsd[c] = ds[c] - d2[c];
  q.dop = dot3(q.dsd, vel);
  return q;
}

// ---------------------------------------------------------------------------
// vjps

// vjp of the amplitude products amp = st2 (x) S from their cotangents g[4]:
// adds the state rows' cotangents, returns those of S
__device__ __forceinline__ void amp_vjp(const float* g, const float* st2,
                                        const float* S, float* dst2,
                                        float* dS) {
  dst2[0] += g[0] * S[0] + g[1] * S[1];
  dst2[1] += g[1] * S[0] - g[0] * S[1];
  dst2[2] += g[2] * S[2] + g[3] * S[3];
  dst2[3] += g[3] * S[2] - g[2] * S[3];
  dS[0] = g[0] * st2[0] + g[1] * st2[1];
  dS[1] = g[1] * st2[0] - g[0] * st2[1];
  dS[2] = g[2] * st2[2] + g[3] * st2[3];
  dS[3] = g[3] * st2[2] - g[2] * st2[3];
}

// vjp of scat_coefs from the cotangents dy[4] of its four outputs: adds
// those of s and s1_alpha and, when d_ang is given, returns those of
// (theta_s, theta_i, cos_ts, cos_ti, sin_ti)
__device__ __forceinline__ void scat_vjp(const Scat& c, float s, float s1a,
                                         float theta_s, float theta_i,
                                         float cos_ts, float cos_ti,
                                         float sin_ti, const float* dy,
                                         float* d_s, float* d_s1a,
                                         float* d_ang) {
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
  const float d_u = d_e * c.e;  // e = exp(u), u = -s1a * dth
  ds1a += -d_u * c.dth;
  *d_s += d_f * c.e;
  *d_s1a += ds1a;
  if (d_ang != nullptr) {
    const float d_dth = -d_u * s1a;
    const float sg = signf(theta_s - theta_i);
    d_ang[0] = d_dth * sg;
    d_ang[1] = -d_dth * sg;
    d_ang[2] = d_spec * c.rough + d_diffu * (1.0f - c.rough);
    d_ang[3] = dtm_re0 * c.f * c.spec;
    d_ang[4] = d_phase * kPhase * s1a;
  }
}

// vjp of _post_light for one RX from its residual rows rp (stride R): adds
// the cotangents of (s, s1_alpha) and of the state rows 0-3 (the tau and
// freq rows are handled by the caller)
__device__ __forceinline__ void post_rx_vjp(const float* rp, const float* dout,
                                            size_t R, float wf, float s,
                                            float s1a, const float* st2,
                                            float* dst2, float* d_s,
                                            float* d_s1a) {
  const float theta_s = rp[0], theta_i = rp[R], cos_ts = rp[2 * R],
              cos_ti = rp[3 * R], sin_ti = rp[4 * R];
  const Scat c = scat_core(theta_s, theta_i, s, s1a, cos_ts, cos_ti, sin_ti);
  const float g[4] = {dout[0] * wf, dout[R] * wf, dout[2 * R] * wf,
                      dout[3 * R] * wf};
  float dy[4];
  amp_vjp(g, st2, c.out, dst2, dy);
  scat_vjp(c, s, s1a, theta_s, theta_i, cos_ts, cos_ti, sin_ti, dy, d_s,
           d_s1a, nullptr);
}

// vjp of _pre_light for a live ray (the Fresnel chain at (cos_t1, sin_t1),
// scaled by fscale, then the amplitude update) from the state cotangent g:
// the state cotangent rows 0-3 and the eta cotangent (rows 3, 5, 6, 7, 8,
// 9; the others stay 0); when d_trig is given, also the cotangents of
// (cos_t1, sin_t1, fscale)
__device__ __forceinline__ void pre_vjp(const float* eta, float cos_t1,
                                        float sin_t1, float fscale,
                                        const float* st, const float* g,
                                        float* dst, float* d_eta,
                                        float* d_trig = nullptr) {
  const Refl f = refl_core(eta, cos_t1, sin_t1);
  float rc0[4], rc[4];
  refl_out(f, eta, rc0);
  for (int j = 0; j < 4; ++j) rc[j] = rc0[j] * fscale;
  dst[0] = g[0] * rc[0] + g[1] * rc[1];
  dst[1] = g[1] * rc[0] - g[0] * rc[1];
  dst[2] = g[2] * rc[2] + g[3] * rc[3];
  dst[3] = g[3] * rc[2] - g[2] * rc[3];
  // the scaled coefficients' cotangents
  const float g_rc[4] = {g[0] * st[0] + g[1] * st[1],
                         g[1] * st[0] - g[0] * st[1],
                         g[2] * st[2] + g[3] * st[3],
                         g[3] * st[2] - g[2] * st[3]};
  if (d_trig != nullptr) {
    d_trig[0] = d_trig[1] = 0.0f;
    d_trig[2] = g_rc[0] * rc0[0] + g_rc[1] * rc0[1] + g_rc[2] * rc0[2] +
                g_rc[3] * rc0[3];
  }
  if (f.tir) return;
  const float h_te_re = g_rc[0] * fscale;
  const float h_te_im = g_rc[1] * fscale;
  const float h_tm_re = g_rc[2] * fscale;
  const float h_tm_im = g_rc[3] * fscale;
  const float rr = eta[kEtaR];
  d_eta[kEtaR] = h_te_re * f.te_re + h_te_im * f.te_im + h_tm_re * f.tm_re +
                 h_tm_im * f.tm_im;
  float ta_re, ta_im, tb_re, tb_im;
  cdiv_vjp(cos_t1 - f.sec_re, -f.sec_im, cos_t1 + f.sec_re, f.sec_im,
           h_te_re * rr, h_te_im * rr, &ta_re, &ta_im, &tb_re, &tb_im);
  const float d_sec_re = tb_re - ta_re, d_sec_im = tb_im - ta_im;
  float da_re, da_im, db_re, db_im;
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
  if (d_trig != nullptr) {
    // cos_t1 enters R_TE's numerator and denominator and R_TM's sc1 terms;
    // sin_t1 enters through sin2
    d_trig[0] = (ta_re + tb_re) + (da_re + db_re) * esr +
                (da_im + db_im) * esi;
    const float d_sin2 = d_xre * f.q_re - d_xim * f.q_im;
    d_trig[1] = 2.0f * sin_t1 * d_sin2;
  }
}

// ---------------------------------------------------------------------------
// moving rows and summing across rays, in the full backwards

// the sum of v over the warp's lanes, in every lane, by a butterfly
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

// A warp's span of n floats at g in device memory moved to (kLoad) or from
// shared memory at s + m, where m = the float offset of g in its 16 bytes:
// both sides then sit alike in their 16 bytes, so the span moves as 16-byte
// vectors with at most 3 scalars at each end.  s must be 16-byte aligned
// with room for n + 3 floats.  Every lane of the warp calls it; returns m
// (span_offset).
__device__ __forceinline__ int span_offset(const float* g) {
  return static_cast<int>((reinterpret_cast<size_t>(g) >> 2) & 3);
}

template <bool kLoad>
__device__ __forceinline__ int warp_span(float* g, float* s, int n) {
  const int lane = threadIdx.x & 31;
  const int m = span_offset(g);
  const int head = min((4 - m) & 3, n);
  const int n_vec = (n - head) >> 2;
  float* sm = s + m;
  if (lane < head) {
    if (kLoad) sm[lane] = g[lane];
    else g[lane] = sm[lane];
  }
  for (int v = lane; v < n_vec; v += 32) {
    float4* gv = reinterpret_cast<float4*>(g + head) + v;
    float4* sv = reinterpret_cast<float4*>(sm + head) + v;
    if (kLoad) *sv = *gv;
    else *gv = *sv;
  }
  const int tail = head + 4 * n_vec + lane;
  if (tail < n) {
    if (kLoad) sm[tail] = g[tail];
    else g[tail] = sm[tail];
  }
  return m;
}

__device__ __forceinline__ void vadd(float2& a, float2 b) {
  a.x += b.x;
  a.y += b.y;
}
__device__ __forceinline__ float2 vshfl(float2 a, int off) {
  return make_float2(__shfl_xor_sync(0xffffffffu, a.x, off),
                     __shfl_xor_sync(0xffffffffu, a.y, off));
}

// Whether this block is the last of the grid to finish: every thread calls
// it after writing its share of the block's partial sums to device memory.
// The count (one per kernel) goes back to 0 in the last block, so the next
// launch on the stream finds it at 0.
__device__ __forceinline__ bool last_block(unsigned int* count, bool* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    *flag = atomicAdd(count, 1u) == gridDim.x - 1;
    if (*flag) *count = 0u;
  }
  __syncthreads();
  if (*flag) __threadfence();
  return *flag;
}

// The last block's sum of the grid's n partial pairs (part[j] = the j-th
// block's two sums) into out[0] and out[1], in a fixed grouping: thread t
// adds pairs t, t + nt, t + 2 nt, ... in order (16 loads in flight: one at
// a time, the sum took a round trip to L2 a pair), and the threads' sums
// are joined by warp butterflies and then the warps in order (smem: 2 *
// blockDim.x / 32 floats).  The same adds in the same order every run, and
// no float atomics.  Every thread calls it.
__device__ __forceinline__ void sum_pairs(const float2* part, int n,
                                          float* out, float* smem) {
  constexpr int kBatch = 16;
  const int t = threadIdx.x, nt = blockDim.x, nw = nt / 32;
  float2 acc = make_float2(0.0f, 0.0f);
  for (int j0 = t; j0 < n; j0 += kBatch * nt) {
    float2 row[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (j0 + u * nt < n) row[u] = __ldcg(part + j0 + u * nt);
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (j0 + u * nt < n) vadd(acc, row[u]);
  }
  for (int off = 16; off > 0; off >>= 1) vadd(acc, vshfl(acc, off));
  if ((t & 31) == 0) {
    smem[t / 32] = acc.x;
    smem[nw + t / 32] = acc.y;
  }
  __syncthreads();
  if (t < 2) {
    float sum = 0.0f;
    for (int w = 0; w < nw; ++w) sum += smem[t * nw + w];
    out[t] = sum;
  }
}

}  // namespace
