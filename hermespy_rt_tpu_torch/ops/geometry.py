"""Launch directions and vector helpers.

:func:`fibonacci_sphere` is host numpy and reproduces the reference's mixed
float/double rounding chain bit for bit.  The vector helpers are written as
one elementwise tensor op per multiply and add, so every product and sum is
rounded on its own (no fused multiply-add) on every device, in the order the
JAX package writes them: ``dot3(a, b) = (a0*b0 + a1*b1) + a2*b2``.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["fibonacci_sphere", "dot3", "cross3", "normalize3", "reflect3",
           "fast_acos"]

_PI32 = np.float32(3.14159265358979323846)


def fibonacci_sphere(num_paths: int) -> np.ndarray:
    """Deterministic unit launch directions, f32[num_paths, 3], bit-exact with
    the reference (including the f32 wrap-around of ``theta``)."""
    k = np.arange(num_paths, dtype=np.float32) + np.float32(0.5)
    arg = np.float32(1.0) - (np.float32(2.0) * k) / np.float32(num_paths)
    phi32 = np.arccos(arg.astype(np.float64)).astype(np.float32)
    sqrt5 = np.sqrt(np.float32(5.0), dtype=np.float32)
    theta32 = (_PI32 * (np.float32(1.0) + sqrt5)) * k
    theta64 = theta32.astype(np.float64)
    phi64 = phi32.astype(np.float64)
    d = np.stack([
        np.cos(theta64) * np.sin(phi64),
        np.sin(theta64) * np.sin(phi64),
        np.cos(phi64),
    ], axis=-1)
    return d.astype(np.float32)


def dot3(a, b):
    """Row-wise 3-vector dot product over the trailing axis."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross3(a, b):
    """Row-wise 3-vector cross product over the trailing axis."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def normalize3(v):
    return v / torch.sqrt(dot3(v, v))[..., None]


def reflect3(d, n):
    """Specular reflection ``d' = d - 2 (d.n) n``."""
    return d - 2.0 * dot3(d, n)[..., None] * n


# asin(x)/x ~ poly(x^2) on [0, 0.5]; the JAX package's coefficients.
_ASIN_POLY = tuple(float(np.float32(v)) for v in (
    0.999999996, 0.166667869, 0.074945353, 0.0455389549, 0.0239094263,
    0.0425537353))
_HALF_PI = float(np.float32(np.pi / 2))
_PI = float(np.float32(np.pi))


def _asin_core(x, x2):
    c0, c1, c2, c3, c4, c5 = _ASIN_POLY
    p = c5
    for c in (c4, c3, c2, c1, c0):
        p = p * x2 + c
    return x * p


def fast_acos(x):
    """float32 arccos as the JAX package's polynomial (error below 1 ulp):
    asin for ``|x| <= 0.5`` and ``acos(1-2s) = 2 asin(sqrt(s))`` beyond."""
    ax = torch.abs(x)
    small = ax <= 0.5
    asin_inner = _asin_core(x, x * x)
    s = torch.clamp(0.5 * (1.0 - ax), min=0.0)
    r = torch.sqrt(s)
    acos_pos = 2.0 * _asin_core(r, s)
    acos_outer = torch.where(x >= 0, acos_pos, _PI - acos_pos)
    return torch.where(small, _HALF_PI - asin_inner, acos_outer)
