"""ITU-R P.2040-3 complex permittivity and Fresnel reflection coefficients.

The counterpart of :mod:`hermespy_rt_tpu.ops.fresnel`, in torch ops and in
the same operation order:

* :func:`precompute_eta` — per-material ``eta = eps' - j 17.98 sigma / f``
  and its cached derived quantities;
* :func:`refl_coefs` — complex TE/TM reflection coefficients (eqs. 31a/31b)
  with the reference's per-component approximation of eq. 33, the
  total-internal-reflection guard and the ``r = 1 - s`` reduction;
* :func:`trans_coefs` — complex TE/TM transmission coefficients (eqs.
  31c/31d) with the same approximation of eq. 33; zero under total internal
  reflection.

Branches are ``torch.where`` over NaN-safe operands, so gradients with
respect to the material coefficients stay finite.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

__all__ = ["EtaPrecomputed", "ETA_FIELDS", "precompute_eta", "refl_coefs",
           "trans_coefs", "complex_sqrt"]

_FLT_EPS = 1.1920928955078125e-07  # __FLT_EPSILON__

ETA_FIELDS = ("eta_re", "eta_im", "eta_abs", "eta_abs_pow2",
              "eta_abs_inv_sqrt", "eta_sqrt_re", "eta_sqrt_im", "eta_inv_re",
              "eta_inv_im", "r", "s", "s1_alpha")


def _safe_sqrt(x):
    """sqrt with zero (sub)gradient at x <= 0 instead of NaN/inf."""
    pos = x > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def complex_sqrt(re, im, mag):
    """Principal complex sqrt from (re, im, |z|), as the reference ``csqrtf``:
    real part ``sqrt((re+|z|)/2)``; imaginary part 0 when ``|im| < eps`` and
    ``re >= -eps``, else ``sign(im) sqrt((|z|-re)/2)``."""
    s_re = _safe_sqrt((re + mag) * 0.5)
    zero_im = (torch.abs(im) < _FLT_EPS) & (re >= -_FLT_EPS)
    s_im_mag = _safe_sqrt((mag - re) * 0.5)
    s_im = torch.where(zero_im, 0.0, torch.where(im < 0, -s_im_mag, s_im_mag))
    return s_re, s_im


def _cdiv(a_re, a_im, b_re, b_im):
    """Complex division a / b, 0 where |b| = 0."""
    den = b_re * b_re + b_im * b_im
    pos = den > 0
    safe_den = torch.where(pos, den, 1.0)
    c_re = (a_re * b_re + a_im * b_im) / safe_den
    c_im = (a_im * b_re - a_re * b_im) / safe_den
    return torch.where(pos, c_re, 0.0), torch.where(pos, c_im, 0.0)


@dataclasses.dataclass(frozen=True)
class EtaPrecomputed:
    """Per-material eta caches, each a tensor of shape ``[M]`` (or per-hit
    rows of any shape once gathered)."""

    eta_re: torch.Tensor
    eta_im: torch.Tensor
    eta_abs: torch.Tensor
    eta_abs_pow2: torch.Tensor
    eta_abs_inv_sqrt: torch.Tensor
    eta_sqrt_re: torch.Tensor
    eta_sqrt_im: torch.Tensor
    eta_inv_re: torch.Tensor
    eta_inv_im: torch.Tensor
    r: torch.Tensor  # reflection reduction factor 1 - s
    s: torch.Tensor
    s1_alpha: torch.Tensor


def precompute_eta(materials, carrier_frequency_ghz) -> EtaPrecomputed:
    """Complex relative permittivity per material at ``f`` GHz:
    ``eta_re = a f^b``, ``eta_im = (c f^d) / (0.0556325027 f)``.
    Differentiable with respect to every material coefficient."""
    f = torch.as_tensor(carrier_frequency_ghz, dtype=torch.float32,
                        device=materials.a.device)
    eta_re = materials.a * torch.pow(f, materials.b)
    eta_im = (materials.c * torch.pow(f, materials.d)) / (
        f.new_tensor(0.0556325027352135) * f)
    eta_abs_pow2 = eta_re * eta_re + eta_im * eta_im
    eta_abs = _safe_sqrt(eta_abs_pow2)
    eta_abs_inv_sqrt = 1.0 / _safe_sqrt(eta_abs)
    eta_sqrt_re, eta_sqrt_im = complex_sqrt(eta_re, eta_im, eta_abs)
    eta_inv_re = eta_re / eta_abs_pow2
    eta_inv_im = -eta_im / eta_abs_pow2
    return EtaPrecomputed(
        eta_re=eta_re, eta_im=eta_im, eta_abs=eta_abs,
        eta_abs_pow2=eta_abs_pow2, eta_abs_inv_sqrt=eta_abs_inv_sqrt,
        eta_sqrt_re=eta_sqrt_re, eta_sqrt_im=eta_sqrt_im,
        eta_inv_re=eta_inv_re, eta_inv_im=eta_inv_im,
        r=1.0 - materials.s, s=materials.s, s1_alpha=materials.s1_alpha,
    )


def refl_coefs(eta: EtaPrecomputed, cos_t1, sin_t1) -> Tuple[
        torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Complex (R_TE, R_TM) for per-hit eta rows and incidence angles, with
    the ``1 - s`` reduction applied; ``R = 1`` under total internal
    reflection.  Returns ``(r_te_re, r_te_im, r_tm_re, r_tm_im)``."""
    tir = eta.eta_abs_inv_sqrt * sin_t1 > 1.0 - _FLT_EPS

    sin2 = sin_t1 * sin_t1
    # eq. 33, the reference's elementwise (non-complex) sqrt approximation
    cos_t2_re = _safe_sqrt(1.0 + eta.eta_inv_re / eta.eta_abs_pow2 * sin2)
    cos_t2_im = _safe_sqrt(1.0 - eta.eta_inv_im / eta.eta_abs_pow2 * sin2)

    # R_TE, eq. 31a: (cos t1 - sqrt(eta) cos t2) / (cos t1 + sqrt(eta) cos t2)
    sec_re = eta.eta_sqrt_re * cos_t2_re - eta.eta_sqrt_im * cos_t2_im
    sec_im = eta.eta_sqrt_re * cos_t2_im + eta.eta_sqrt_im * cos_t2_re
    r_te_re, r_te_im = _cdiv(cos_t1 - sec_re, -sec_im, cos_t1 + sec_re, sec_im)

    # R_TM, eq. 31b: (sqrt(eta) cos t1 - cos t2) / (sqrt(eta) cos t1 + cos t2)
    sc1_re = eta.eta_sqrt_re * cos_t1
    sc1_im = eta.eta_sqrt_im * cos_t1
    r_tm_re, r_tm_im = _cdiv(sc1_re - cos_t2_re, sc1_im - cos_t2_im,
                             sc1_re + cos_t2_re, sc1_im + cos_t2_im)

    r_te_re = torch.where(tir, 1.0, r_te_re * eta.r)
    r_te_im = torch.where(tir, 0.0, r_te_im * eta.r)
    r_tm_re = torch.where(tir, 1.0, r_tm_re * eta.r)
    r_tm_im = torch.where(tir, 0.0, r_tm_im * eta.r)
    return r_te_re, r_te_im, r_tm_re, r_tm_im


def trans_coefs(eta: EtaPrecomputed, cos_t1, sin_t1) -> Tuple[
        torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Complex (T_TE, T_TM) for per-hit eta rows and incidence angles:

        T_TE = 2 cos(t1) / (cos(t1) + sqrt(eta) cos(t2))
        T_TM = 2 sqrt(eta) cos(t1) / (sqrt(eta) cos(t1) + cos(t2))

    with :func:`refl_coefs`' approximation of cos(t2); ``T = 0`` under total
    internal reflection.  Returns ``(t_te_re, t_te_im, t_tm_re, t_tm_im)``.
    """
    tir = eta.eta_abs_inv_sqrt * sin_t1 > 1.0 - _FLT_EPS

    sin2 = sin_t1 * sin_t1
    cos_t2_re = _safe_sqrt(1.0 + eta.eta_inv_re / eta.eta_abs_pow2 * sin2)
    cos_t2_im = _safe_sqrt(1.0 - eta.eta_inv_im / eta.eta_abs_pow2 * sin2)

    # sqrt(eta) * cos(t2)
    sec_re = eta.eta_sqrt_re * cos_t2_re - eta.eta_sqrt_im * cos_t2_im
    sec_im = eta.eta_sqrt_re * cos_t2_im + eta.eta_sqrt_im * cos_t2_re
    t_te_re, t_te_im = _cdiv(2.0 * cos_t1, torch.zeros_like(cos_t1),
                             cos_t1 + sec_re, sec_im)

    # sqrt(eta) * cos(t1)
    sc1_re = eta.eta_sqrt_re * cos_t1
    sc1_im = eta.eta_sqrt_im * cos_t1
    t_tm_re, t_tm_im = _cdiv(2.0 * sc1_re, 2.0 * sc1_im,
                             sc1_re + cos_t2_re, sc1_im + cos_t2_im)

    t_te_re = torch.where(tir, 0.0, t_te_re)
    t_te_im = torch.where(tir, 0.0, t_te_im)
    t_tm_re = torch.where(tir, 0.0, t_tm_re)
    t_tm_im = torch.where(tir, 0.0, t_tm_im)
    return t_te_re, t_te_im, t_tm_re, t_tm_im
