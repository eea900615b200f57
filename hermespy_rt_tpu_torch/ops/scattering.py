"""Directive rough-surface scattering coefficients, the counterpart of
:func:`hermespy_rt_tpu.ops.scattering.scat_coefs`: directivity
``f = s exp(-s1_alpha |theta_s - theta_i|)``, a specular/diffuse roughness
mix, a small roughness-phase rotation and a unit-norm normalisation guarded at
``norm > 1e-6``.  ``torch.exp`` stands where the JAX package calls the library
``exp`` off the TPU."""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["scat_coefs"]


def scat_coefs(theta_s, theta_i, s, s1_alpha, cos_ts=None, cos_ti=None,
               sin_ti=None) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor, torch.Tensor]:
    """Complex (S_TE, S_TM) scattering coefficients over broadcastable
    tensors.  ``cos_ts``/``cos_ti``/``sin_ti`` default to the trig of the
    angles.  Returns ``(s_te_re, s_te_im, s_tm_re, s_tm_im)``."""
    cos_ts = torch.cos(theta_s) if cos_ts is None else cos_ts
    cos_ti = torch.cos(theta_i) if cos_ti is None else cos_ti
    sin_ti = torch.sin(theta_i) if sin_ti is None else sin_ti

    f = s * torch.exp(-s1_alpha * torch.abs(theta_s - theta_i))

    roughness = 1.0 / (1.0 + s1_alpha)
    specular = roughness * cos_ts
    diffuse = (1.0 - roughness) * cos_ts

    te_re = f * (specular + diffuse)
    tm_re = f * (specular * cos_ti + diffuse)

    phase = s1_alpha * sin_ti * 0.1
    sin_phase = torch.sin(phase)
    te_im = te_re * sin_phase
    tm_im = tm_re * sin_phase

    norm2 = te_re * te_re + te_im * te_im + tm_re * tm_re + tm_im * tm_im
    norm = torch.sqrt(torch.where(norm2 > 0, norm2, 1.0))
    do_norm = norm > 1e-6
    inv = torch.where(do_norm, 1.0 / torch.where(do_norm, norm, 1.0), 1.0)
    return te_re * inv, te_im * inv, tm_re * inv, tm_im * inv
