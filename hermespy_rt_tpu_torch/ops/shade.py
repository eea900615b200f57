"""Bounce shading, reflection half: the counterpart of
``hermespy_rt_tpu.ops.shade.shade_a_jnp`` in torch ops, same order.

Per active ray after its nearest hit: the differentiable hit distance from
the gathered triangle, the incidence trig, ITU Fresnel reflection with the
per-segment free-space loss, the complex amplitude update, the specular ray
update with the 1e-4 self-hit offset, and the mesh-velocity Doppler.
"""
from __future__ import annotations

import numpy as np
import torch

from .fresnel import refl_coefs
from .geometry import cross3, dot3, fast_acos, reflect3
from .intersect import FLT_EPS

__all__ = ["shade_a"]

SPEED_OF_LIGHT = float(np.float32(299792458.0))   # m/s, as the reference
_CLIP = float(np.float32(1.0) - np.float32(FLT_EPS))  # grad-safe acos clamp


def shade_a(o, d, ate_re, ate_im, atm_re, atm_im, tau, freq, live,
            hit, eta, fslm, k_dop):
    """``hit`` is the fetch dict (v0/e1/e2/normal/velocity, [R, 3] each),
    ``eta`` an :class:`~hermespy_rt_tpu_torch.ops.fresnel.EtaPrecomputed` of
    [R] rows.  Returns ``(o', d', ate_re', ate_im', atm_re', atm_im', tau',
    freq', theta, cos_t1, ndot, sin_t1, fscale)``: the last two are the
    residuals at which the fused path's material backward re-evaluates the
    Fresnel chain."""
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
    o_ref = hitp + 1e-4 * d_ref
    lv = live[:, None]
    o2 = torch.where(lv, o_ref, o)
    d2 = torch.where(lv, d_ref, d)

    freq2 = freq + torch.where(live, dot3(d_ref - d, vel) * k_dop, 0.0)
    return (o2, d2, ate_re2, ate_im2, atm_re2, atm_im2, tau2, freq2,
            theta, cos_t1, ndot, sin_t1, fscale)
