"""Bounce shading, reflection half: the counterpart of
``hermespy_rt_tpu.ops.shade.shade_a_jnp`` in torch ops, same order.

Per active ray after its nearest hit: the differentiable hit distance from
the gathered triangle, the incidence trig, ITU Fresnel reflection with the
per-segment free-space loss, the complex amplitude update, the specular ray
update with the 1e-4 self-hit offset, and the mesh-velocity Doppler.  Under
transmission spawning a ray selected by ``transmit`` takes the ITU
transmission coefficients instead and passes through the surface, straight
or bent by Snell's law.

:func:`shade_a_plain` is the same chain on the operands of the CUDA kernel
``csrc/shade.cu`` (wrapper in :mod:`.shade_cuda`): the payload rows as
fetched, the state as six rows.  :func:`through_blocker` is a shadow ray's
penetration of its blocker under ``transmission``, one chain for the op
path and the fused post stage's plain version.
"""
from __future__ import annotations

import numpy as np
import torch

from .fresnel import ETA_FIELDS, EtaPrecomputed, refl_coefs, trans_coefs
from .geometry import cross3, dot3, fast_acos, reflect3
from .intersect import FLT_EPS

__all__ = ["shade_a", "shade_a_plain", "split_payload", "through_blocker",
           "GEOM_COLS"]

SPEED_OF_LIGHT = float(np.float32(299792458.0))   # m/s, as the reference
_CLIP = float(np.float32(1.0) - np.float32(FLT_EPS))  # grad-safe acos clamp
GEOM_COLS = 15     # payload columns: v0, e1, e2, normal, velocity; then eta


def split_payload(row, geo=None):
    """``(hit, eta)`` of :func:`shade_a` from payload rows ``[..., 27]``;
    ``geo``, when given, stands in for the 15 geometry columns."""
    geo = row[..., :GEOM_COLS] if geo is None else geo
    hit = dict(v0=geo[..., 0:3], e1=geo[..., 3:6], e2=geo[..., 6:9],
               normal=geo[..., 9:12], velocity=geo[..., 12:15])
    eta = EtaPrecomputed(**{f: row[..., GEOM_COLS + i]
                            for i, f in enumerate(ETA_FIELDS)})
    return hit, eta


def shade_a(o, d, ate_re, ate_im, atm_re, atm_im, tau, freq, live,
            hit, eta, fslm, k_dop, transmit=None, refraction="straight"):
    """``hit`` is the fetch dict (v0/e1/e2/normal/velocity, [R, 3] each),
    ``eta`` an :class:`~hermespy_rt_tpu_torch.ops.fresnel.EtaPrecomputed` of
    [R] rows.  ``transmit`` (bool[R] or None) selects per ray the
    transmitted continuation (``spawn_transmission``), ``refraction``
    ("straight" or "snell") its direction.  Returns ``(o', d', ate_re',
    ate_im', atm_re', atm_im', tau', freq', theta, cos_t1, ndot, sin_t1,
    fscale)``: the last two are the residuals at which the fused path's
    material backward re-evaluates the Fresnel chain."""
    n = hit["normal"]
    vel = hit["velocity"]

    pvec = cross3(d, hit["e2"])
    det = dot3(hit["e1"], pvec)
    qvec = cross3(o - hit["v0"], hit["e1"])
    inv_det = 1.0 / torch.where(det == 0, 1.0, det)
    t = torch.where(live, dot3(hit["e2"], qvec) * inv_det, 0.0)

    ndot = dot3(n, d)
    cos_t1 = torch.clamp(torch.abs(ndot), 0.0, _CLIP)
    sin_t1 = torch.sqrt(1.0 - cos_t1 * cos_t1)
    theta = fast_acos(cos_t1)

    r_te_re, r_te_im, r_tm_re, r_tm_im = refl_coefs(eta, cos_t1, sin_t1)
    if transmit is not None:
        x_te_re, x_te_im, x_tm_re, x_tm_im = trans_coefs(eta, cos_t1, sin_t1)
        r_te_re = torch.where(transmit, x_te_re, r_te_re)
        r_te_im = torch.where(transmit, x_te_im, r_te_im)
        r_tm_re = torch.where(transmit, x_tm_re, r_tm_re)
        r_tm_im = torch.where(transmit, x_tm_im, r_tm_im)
    fsl = fslm * t
    fsl2 = fsl * fsl
    big = fsl2 > 1.0
    fscale = torch.where(big, 1.0 / torch.where(big, fsl2, 1.0), 1.0)
    r_te_re, r_te_im = r_te_re * fscale, r_te_im * fscale
    r_tm_re, r_tm_im = r_tm_re * fscale, r_tm_im * fscale

    new_ate_re = ate_re * r_te_re - ate_im * r_te_im
    new_ate_im = ate_re * r_te_im + ate_im * r_te_re
    new_atm_re = atm_re * r_tm_re - atm_im * r_tm_im
    new_atm_im = atm_re * r_tm_im + atm_im * r_tm_re
    ate_re2 = torch.where(live, new_ate_re, ate_re)
    ate_im2 = torch.where(live, new_ate_im, ate_im)
    atm_re2 = torch.where(live, new_atm_re, atm_re)
    atm_im2 = torch.where(live, new_atm_im, atm_im)
    tau2 = tau + torch.where(live, t / SPEED_OF_LIGHT, 0.0)

    hitp = o + t[:, None] * d
    d_ref = reflect3(d, n)
    if transmit is not None:
        tr = transmit[:, None]
        if refraction == "snell":
            # bent at one air -> medium interface of index n = Re(sqrt(eta))
            # >= 1, so mu = 1/n <= 1 and no total internal reflection on
            # entry; the oriented normal points against the incident ray
            mu = 1.0 / torch.clamp(eta.eta_sqrt_re, min=1.0)
            sgn = torch.where(ndot >= 0.0, -1.0, 1.0)
            n_in = sgn[:, None] * n
            cos_t2 = torch.sqrt(torch.clamp(
                1.0 - mu * mu * (1.0 - cos_t1 * cos_t1), min=0.0))
            d_t = mu[:, None] * d + (mu * cos_t1 - cos_t2)[:, None] * n_in
            d_ref = torch.where(tr, d_t, d_ref)
        else:
            d_ref = torch.where(tr, d, d_ref)
    o_ref = hitp + 1e-4 * d_ref
    lv = live[:, None]
    o2 = torch.where(lv, o_ref, o)
    d2 = torch.where(lv, d_ref, d)

    freq2 = freq + torch.where(live, dot3(d_ref - d, vel) * k_dop, 0.0)
    return (o2, d2, ate_re2, ate_im2, atm_re2, atm_im2, tau2, freq2,
            theta, cos_t1, ndot, sin_t1, fscale)


def through_blocker(amp, normal, eta, ds, blocked):
    """Shadow-ray gains under ``transmission``: a blocked shadow ray passes
    through its nearest blocker with the ITU transmission coefficients
    instead of being zeroed.  ``amp`` (te_re, te_im, tm_re, tm_im) and
    ``blocked`` per (RX, ray), ``normal`` and ``eta`` the blocker rows'
    (at any clamped index where not blocked), ``ds`` the shadow directions.
    Returns the four gains; an unblocked pair keeps its own."""
    cos1 = torch.clamp(torch.abs(dot3(normal, ds)), 0.0, _CLIP)
    sin1 = torch.sqrt(1.0 - cos1 * cos1)
    tte_re, tte_im, ttm_re, ttm_im = trans_coefs(eta, cos1, sin1)
    bf = blocked.to(torch.float32)
    fte_re = 1.0 + bf * (tte_re - 1.0)
    fte_im = bf * tte_im
    ftm_re = 1.0 + bf * (ttm_re - 1.0)
    ftm_im = bf * ttm_im
    te_re, te_im, tm_re, tm_im = amp
    return (te_re * fte_re - te_im * fte_im, te_re * fte_im + te_im * fte_re,
            tm_re * ftm_re - tm_im * ftm_im, tm_re * ftm_im + tm_im * ftm_re)


def shade_a_plain(o, d, st, live, row, sc):
    """:func:`shade_a` on the kernel's operands: ``o``, ``d`` f32[R, 3],
    ``st`` f32[6, R] (ate_re, ate_im, atm_re, atm_im, tau, freq), ``live``
    bool[R], ``row`` f32[R, 27] the fetched payload rows, ``sc`` f32[2]
    (fslm, k_dop).  Returns ``(o2 [R, 3], d2 [R, 3], st2 [6, R], ex [5,
    R])``, ``ex`` the rows (theta, cos_t1, n.d, sin_t1, fscale)."""
    hit, eta = split_payload(row)
    out = shade_a(o, d, *st, live, hit, eta, sc[0], sc[1])
    return out[0], out[1], torch.stack(out[2:8]), torch.stack(out[8:])
