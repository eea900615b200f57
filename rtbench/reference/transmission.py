"""The plain reference of the transmission modes that decides ``correct``.

The program's op path under ``parity="physical"``, ``transmission=True``,
``spawn_transmission=True`` and ``refraction="straight"``
(``hermespy_rt_tpu_torch/tracer.py``: ``_los_pass``, ``bounce_step``,
``launch_state``, ``transmit_patterns``; ``ops/shade.py::shade_a`` and
``ops/fresnel.py::trans_coefs``), written out again in plain torch on top of
the frozen :mod:`.tracer`, whose scene, nearest hit, Fresnel reflection,
scattering and launch directions it imports and does not change.  It
imports nothing of the port and nothing of JAX.

What it computes:

* the LoS pass: a blocked LoS path passes through its nearest blocker
  within the TX-RX segment, its gains the free-space amplitude times that
  blocker's transmission coefficients (:func:`trans_coefs`), its delay and
  direction those of the unblocked path;
* each bounce's choice: ray ``i`` of the launch set follows the pattern
  ``i mod 2^B``, bit ``b`` set meaning it passes through the surface it
  hits at bounce ``b`` (so a sample of path ids takes those ids' patterns);
  a passing ray takes the transmission coefficients in place of the
  reflection coefficients and goes on straight, its origin 1e-4 m past the
  hit point;
* the shadow ray to each RX: the nearest blocker within the physical limit
  (the distance less twice the 1e-4 m offset, the ray's own triangle
  crossed analytically), and on a blocked ray that blocker's transmission
  coefficients on the scattered gains instead of a zero;
* the hemisphere: a reflected ray scatters into the incidence side, a
  transmitted one into the exit side;
* the Doppler rules of the op path: per bounce ``(d' - d) . v k``, per
  shadow ray ``-(ds - d) . v k`` on live rays (the scene and the ends are
  static here, so every shift is 0).

Departures from the published models, which are the program's own
semantics: only the nearest blocker of a path attenuates it, so a path
through two walls is attenuated once; the coefficients are single-interface
Fresnel coefficients (ITU-R P.2040-3 eqs. 31c/31d, with eq. 33 approximated
as the reflection does) with no slab thickness and no loss inside the
slab; a slab does not bend a ray (Sionna RT's thin-slab model).  3GPP TR
38.901's O2I building-penetration loss is a statistical model and is not
computed here.

float32 is the configuration's precision and bfloat16 the control's; the
whole chain runs in the dtype of the setup it is given.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from . import tracer as ref

# a float32 matrix product may run in TF32 on the card unless told not to
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

OFFSET = 1e-4          # m: a continued ray's origin past its hit point


def trans_coefs(eta, cos_t1, sin_t1):
    """Complex (T_TE, T_TM), ITU-R P.2040-3 eqs. 31c/31d,

        T_TE = 2 cos t1 / (cos t1 + sqrt(eta) cos t2)
        T_TM = 2 sqrt(eta) cos t1 / (sqrt(eta) cos t1 + cos t2)

    with the reflection's per-component approximation of eq. 33 for
    ``cos t2`` and ``T = 0`` under total internal reflection.  ``eta``
    holds per-ray rows of :func:`.tracer.precompute_eta`."""
    tir = eta["eta_abs_inv_sqrt"] * sin_t1 > 1.0 - ref.FLT_EPS
    sin2 = sin_t1 * sin_t1
    c2_re = ref._safe_sqrt(1.0 + eta["eta_inv_re"] / eta["eta_abs_pow2"]
                           * sin2)
    c2_im = ref._safe_sqrt(1.0 - eta["eta_inv_im"] / eta["eta_abs_pow2"]
                           * sin2)
    sec_re = eta["eta_sqrt_re"] * c2_re - eta["eta_sqrt_im"] * c2_im
    sec_im = eta["eta_sqrt_re"] * c2_im + eta["eta_sqrt_im"] * c2_re
    te_re, te_im = ref._cdiv(2.0 * cos_t1, torch.zeros_like(cos_t1),
                             cos_t1 + sec_re, sec_im)
    sc1_re = eta["eta_sqrt_re"] * cos_t1
    sc1_im = eta["eta_sqrt_im"] * cos_t1
    tm_re, tm_im = ref._cdiv(2.0 * sc1_re, 2.0 * sc1_im, sc1_re + c2_re,
                             sc1_im + c2_im)
    zero = lambda x: torch.where(tir, 0.0, x)
    return zero(te_re), zero(te_im), zero(tm_re), zero(tm_im)


def _rows(su: ref.Setup, eta_tab, idx):
    """The normal, velocity and material eta rows of triangles ``idx``
    (clamped; a miss reads triangle 0, as the program's fetch does)."""
    safe = torch.clamp(idx, min=0)
    mat = su.scene.material[safe]
    return (su.scene.normal[safe], su.scene.velocity[safe],
            {k: v[mat] for k, v in eta_tab.items()})


def _cmul(a_re, a_im, b_re, b_im):
    return a_re * b_re - a_im * b_im, a_re * b_im + a_im * b_re


def _through(blocked, t):
    """The factor of a path that passes through a blocker with the
    coefficient ``t = (re, im)`` where ``blocked``, else 1."""
    bf = blocked.to(t[0].dtype)
    return 1.0 + bf * (t[0] - 1.0), bf * t[1]


def los_pass(su: ref.Setup, eta_tab) -> Dict[str, torch.Tensor]:
    """LoS per RX: complex gains as ``te_re``, ``te_im``, ``tm_re``,
    ``tm_im`` [nrx], ``tau``, ``freq``, ``dir_rx`` and ``dir_tx`` [nrx, 3],
    and ``blocked``."""
    nrx = su.rx.shape[0]
    o = su.tx[None].expand(nrx, 3)
    dvec = su.rx - su.tx[None]
    d2 = ref.dot3(dvec, dvec)
    coincident = d2 < ref.FLT_EPS
    t_hit, idx = ref.nearest_hit(su.scene, o, dvec, t_max=1.0)
    blocked = (idx >= 0) & (t_hit <= 1.0) & ~coincident
    dist = torch.sqrt(torch.where(coincident, 1.0, d2))
    dn = dvec / torch.where(coincident, 1.0, dist)[:, None]
    fsl = 4.0 * ref.PI * su.f_hz / ref.SPEED_OF_LIGHT * dist
    big = fsl > 1.0
    amp = torch.where(big, 1.0 / torch.where(big, fsl, 1.0), 1.0)
    n_b, _, eta_b = _rows(su, eta_tab, idx)
    cos1 = torch.clamp(torch.abs(ref.dot3(n_b, dn)), 0.0, ref._CLIP)
    sin1 = torch.sqrt(1.0 - cos1 * cos1)
    tte_re, tte_im, ttm_re, ttm_im = trans_coefs(eta_b, cos1, sin1)
    fte = _through(blocked, (tte_re, tte_im))
    ftm = _through(blocked, (ttm_re, ttm_im))
    one = lambda x, v: torch.where(coincident, v, amp * x)
    x_hat = dn.new_tensor([1.0, 0.0, 0.0])
    return dict(te_re=one(fte[0], 1.0), te_im=one(fte[1], 0.0),
                tm_re=one(ftm[0], 1.0), tm_im=one(ftm[1], 0.0),
                tau=torch.where(coincident, 0.0, dist / ref.SPEED_OF_LIGHT),
                freq=torch.zeros_like(dist),    # static TX and RX
                dir_tx=torch.where(coincident[:, None], x_hat, dn),
                dir_rx=torch.where(coincident[:, None], -x_hat, -dn),
                blocked=blocked)


def _bounce(su: ref.Setup, eta_tab, state, transmit):
    """One bounce of every ray in ``state``; ``transmit`` bool[K] the rays
    that pass through the surface they hit.  Returns ``(state,
    outputs)``."""
    o, d, ate_re, ate_im, atm_re, atm_im, tau, act, freq, pidx = state
    scene, rx, nrx = su.scene, su.rx, su.rx.shape[0]
    fslm = 4.0 * ref.PI * su.f_hz / ref.SPEED_OF_LIGHT
    k_dop = su.f_hz / ref.SPEED_OF_LIGHT
    _, idx = ref.nearest_hit(scene, o, d, exclude=pidx, live=act)
    live = act & (idx >= 0)
    safe = torch.clamp(idx, min=0)
    v0, e1, e2 = scene.v0[safe], scene.e1[safe], scene.e2[safe]
    n, vel, eta = _rows(su, eta_tab, idx)

    # the hit distance, incidence, the reflection or transmission
    # coefficients, free-space loss, the amplitude update, the continuation
    # (specular or straight) and its Doppler
    pvec = ref.cross3(d, e2)
    det = ref.dot3(e1, pvec)
    qvec = ref.cross3(o - v0, e1)
    inv_det = 1.0 / torch.where(det == 0, 1.0, det)
    t = torch.where(live, ref.dot3(e2, qvec) * inv_det, 0.0)
    ndot = ref.dot3(n, d)
    cos_t1 = torch.clamp(torch.abs(ndot), 0.0, ref._CLIP)
    sin_t1 = torch.sqrt(1.0 - cos_t1 * cos_t1)
    theta = ref.fast_acos(cos_t1)
    refl = ref.refl_coefs(eta, cos_t1, sin_t1)
    trans = trans_coefs(eta, cos_t1, sin_t1)
    c_te_re, c_te_im, c_tm_re, c_tm_im = (torch.where(transmit, x, r)
                                          for x, r in zip(trans, refl))
    fsl2 = (fslm * t) * (fslm * t)
    big = fsl2 > 1.0
    fscale = torch.where(big, 1.0 / torch.where(big, fsl2, 1.0), 1.0)
    n_te = _cmul(ate_re, ate_im, c_te_re * fscale, c_te_im * fscale)
    n_tm = _cmul(atm_re, atm_im, c_tm_re * fscale, c_tm_im * fscale)
    ate_re, ate_im = (torch.where(live, x, y) for x, y in zip(n_te, (
        ate_re, ate_im)))
    atm_re, atm_im = (torch.where(live, x, y) for x, y in zip(n_tm, (
        atm_re, atm_im)))
    tau = tau + torch.where(live, t / ref.SPEED_OF_LIGHT, 0.0)
    hitp = o + t[:, None] * d
    d_new = torch.where(transmit[:, None], d,
                        d - 2.0 * ref.dot3(d, n)[..., None] * n)
    lv = live[:, None]
    o2 = torch.where(lv, hitp + OFFSET * d_new, o)
    d2 = torch.where(lv, d_new, d)
    freq = freq + torch.where(live, ref.dot3(d_new - d, vel) * k_dop, 0.0)
    o, d = o2, d2

    # the shadow ray to every RX: the nearest blocker within the physical
    # limit, the ray's own triangle crossed analytically
    so = o[None].expand(nrx, -1, -1)
    ds_un = rx[:, None, :] - so
    d2rx = ref._safe_norm(ds_un)
    ds = ds_un / torch.where(d2rx > 0, d2rx, 1.0)[..., None]
    live_b = live[None].expand_as(d2rx)
    ds_dot_n = ref.dot3(ds, n[None])
    dint_n = ref.dot3(d, n)
    t_self = -OFFSET * dint_n[None, :] / torch.where(ds_dot_n == 0.0, 1.0,
                                                      ds_dot_n)
    crossing = (ds_dot_n * dint_n[None, :] < 0.0) & live_b
    excl = torch.where(live, idx, -1)[None].expand_as(d2rx).reshape(-1)
    eps_o = su.eps_o
    limit = d2rx.reshape(-1) - 2.0 * eps_o
    t_o, idx_o = ref.nearest_hit(scene, (so + eps_o * ds).reshape(-1, 3),
                                 ds.reshape(-1, 3), exclude=excl,
                                 t_max=limit, live=live_b.reshape(-1))
    t_self_q = t_self.reshape(-1) - eps_o
    self_hit = (crossing.reshape(-1) & (t_self_q > ref.FLT_EPS)
                & (t_self_q <= limit))
    closer = self_hit & (t_self_q < t_o)
    t_o = torch.where(closer, t_self_q, t_o)
    idx_o = torch.where(closer, excl, idx_o)
    blocked = ((idx_o >= 0) & (t_o <= limit)).reshape(nrx, -1)
    idx_o = idx_o.reshape(nrx, -1)

    # the scattered gains, through the blocker where blocked, into the
    # incidence side of a reflection and the exit side of a transmission
    cos_ts = torch.clamp(ds_dot_n, -ref._CLIP, ref._CLIP)
    theta_s = ref.fast_acos(cos_ts)
    hemi = torch.where(transmit[None], ds_dot_n * ndot[None] > 0.0,
                       ds_dot_n * ndot[None] < 0.0)
    theta_i = theta[None].expand_as(theta_s)
    cos_ti = cos_t1[None].expand_as(theta_s)
    sin_ti = torch.sqrt(1.0 - cos_ti * cos_ti)
    s_te_re, s_te_im, s_tm_re, s_tm_im = ref.scat_coefs(
        theta_s, theta_i, eta["s"][None], eta["s1_alpha"][None], cos_ts,
        cos_ti, sin_ti)
    te = _cmul(ate_re[None], ate_im[None], s_te_re, s_te_im)
    tm = _cmul(atm_re[None], atm_im[None], s_tm_re, s_tm_im)
    n_o, _, eta_o = _rows(su, eta_tab, idx_o)
    cos1b = torch.clamp(torch.abs(ref.dot3(n_o, ds)), 0.0, ref._CLIP)
    sin1b = torch.sqrt(1.0 - cos1b * cos1b)
    tte_re, tte_im, ttm_re, ttm_im = trans_coefs(eta_o, cos1b, sin1b)
    te = _cmul(*te, *_through(blocked, (tte_re, tte_im)))
    tm = _cmul(*tm, *_through(blocked, (ttm_re, ttm_im)))
    fsl_s2 = (fslm * d2rx) * (fslm * d2rx)
    big = fsl_s2 > 1.0
    sscale = torch.where(big, 1.0 / torch.where(big, fsl_s2, 1.0), 1.0)
    write = live[None] & hemi
    wf = write.to(sscale.dtype) * sscale
    out = dict(te_re=te[0] * wf, te_im=te[1] * wf, tm_re=tm[0] * wf,
               tm_im=tm[1] * wf,
               tau=torch.where(write, tau[None] + d2rx / ref.SPEED_OF_LIGHT,
                               0.0),
               freq=freq[None] - torch.where(
                   live[None], ref.dot3(ds - d[None], vel[None]) * k_dop,
                   0.0),
               dir_rx=torch.where(write[..., None], -ds, 0.0), live=live)
    state = (o, d, ate_re, ate_im, atm_re, atm_im, tau, live, freq,
             torch.where(live, idx, -1))
    return state, out


def patterns(ids: torch.Tensor, num_bounces: int) -> torch.Tensor:
    """The transmit pattern of launch-set rays ``ids``: ``ids mod 2^B``."""
    return ids % (1 << num_bounces)


def trace_rays(su: ref.Setup, eta_tab, dirs: torch.Tensor,
               pattern: torch.Tensor, num_bounces: int) -> List[dict]:
    """Trace the launch directions ``dirs`` [K, 3] from the TX through
    ``num_bounces`` bounces, ray ``k`` transmitting at bounce ``b`` where
    bit ``b`` of ``pattern[k]`` is set.  Returns per bounce the outputs
    (``te_re`` ... ``dir_rx`` [nrx, K(, 3)], ``live`` [K])."""
    K = dirs.shape[0]
    dt, dev = dirs.dtype, dirs.device
    ones = torch.ones(K, dtype=dt, device=dev)
    zeros = torch.zeros_like(ones)
    state = (su.tx[None].expand(K, 3), dirs, ones, zeros, ones, zeros, zeros,
             torch.ones(K, dtype=torch.bool, device=dev), zeros,
             torch.full((K,), -1, dtype=torch.int64, device=dev))
    outs = []
    with torch.no_grad():
        for b in range(num_bounces):
            state, out = _bounce(su, eta_tab, state,
                                 ((pattern >> b) & 1).bool().to(dev))
            outs.append(out)
    return outs
