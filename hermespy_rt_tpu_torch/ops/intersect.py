"""Ray-triangle nearest hit (Möller–Trumbore), plain torch version.

:func:`intersect_torch` is the plain twin of the CUDA kernel in
:mod:`hermespy_rt_tpu_torch.ops.intersect_cuda` and the counterpart of the
JAX golden ``hermespy_rt_tpu.ops.intersect.intersect_jnp`` (``_mt_block`` +
``_nearest``): every ray is tested against every triangle with
``FLT_EPSILON``-tolerant barycentric bounds, the nearest hit with
``eps < t < T_MAX`` wins, and ties go to the lowest triangle index.

Each quantity is one elementwise op on ``[chunk, T]`` tensors, one per
vector component, in the golden's order: ``pvec = d x e2``,
``det = e1 . pvec``, ``inv_det = 1 / det``, then ``u``, ``v`` and ``t`` as
dot products times ``inv_det``.  Every product and sum is rounded on its own,
which is what the kernel does when built without FMA contraction, so the two
make the same decisions.  Rays are chunked so the temporaries stay bounded:
each ``[chunk, T]`` f32 temporary holds ``4 * chunk * T`` bytes.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .geometry import cross3, dot3

__all__ = ["intersect_torch", "mt_hit", "recompute_hit_t", "FLT_EPS", "T_MAX",
           "MISS"]

FLT_EPS = 1.1920928955078125e-07  # __FLT_EPSILON__, the C tolerance
T_MAX = 1e9                       # reference 'dist' init
MISS = -1


def _components(x):
    return x[:, 0], x[:, 1], x[:, 2]


def mt_hit(o, d, v0, e1, e2):
    """Möller–Trumbore ``(t, valid)`` of broadcasting ray and triangle
    components, each a tuple ``(x, y, z)`` of tensors, in the golden's op
    order; ``valid`` holds the epsilon tests and ``eps < t < T_MAX``.  The
    brute query and the walk (``ops/walk.py``) share it, as their kernels
    share ``csrc/mt.cuh``."""
    ox, oy, oz = o
    dx, dy, dz = d
    v0x, v0y, v0z = v0
    e1x, e1y, e1z = e1
    e2x, e2y, e2z = e2
    px = dy * e2z - dz * e2y                   # pvec = d x e2
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    sx, sy, sz = ox - v0x, oy - v0y, oz - v0z  # s = o - v0
    inv_det = 1.0 / torch.where(det == 0, 1.0, det)
    u = (sx * px + sy * py + sz * pz) * inv_det
    qx = sy * e1z - sz * e1y                   # qvec = s x e1
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    valid = ((torch.abs(det) >= FLT_EPS)
             & (u >= -FLT_EPS) & (u <= 1.0 + FLT_EPS)
             & (v >= -FLT_EPS) & (u + v <= 1.0 + FLT_EPS)
             & (t > FLT_EPS) & (t < T_MAX))
    return t, valid


def _nearest_chunk(o, d, v0, e1, e2, exclude):
    """(t, idx) of one ray chunk ``o, d`` f32[C, 3] against all triangles."""
    t, valid = mt_hit(tuple(c[:, None] for c in _components(o)),
                      tuple(c[:, None] for c in _components(d)),
                      *(tuple(c[None] for c in _components(x))
                        for x in (v0, e1, e2)))
    if exclude is not None:
        tri = torch.arange(v0.shape[0], device=o.device)
        valid &= tri[None, :] != exclude[:, None]
    t_masked = torch.where(valid, t, torch.inf)
    tmin, arg = torch.min(t_masked, dim=1)   # first occurrence of the minimum
    hit = torch.isfinite(tmin)
    idx = torch.where(hit, arg.to(torch.int32), MISS)
    return torch.where(hit, tmin, torch.inf), idx


def intersect_torch(o: torch.Tensor, d: torch.Tensor, tris,
                    chunk_size: int = 4096,
                    exclude: Optional[torch.Tensor] = None,
                    t_max=None,
                    live: Optional[torch.Tensor] = None,
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest hit of rays ``(o, d)`` f32[R, 3] against ``tris``.

    Returns ``(t, idx)``: ``t`` f32[R] in units of ``|d|`` (+inf on a miss)
    and ``idx`` i32[R] (-1 on a miss).  ``exclude`` (i32[R]) suppresses one
    triangle per ray (-1: none); ``t_max`` (scalar or f32[R]) turns hits with
    ``t > t_max`` into misses; ``live`` (bool[R]) turns dead rays into misses.
    Hit decisions carry no gradient.
    """
    with torch.no_grad():
        o = o.detach().to(torch.float32)
        d = d.detach().to(torch.float32)
        R = o.shape[0]
        if exclude is not None:
            exclude = exclude.to(torch.int64)
        ts, idxs = [], []
        for a in range(0, R, chunk_size):
            b = min(a + chunk_size, R)
            t_c, i_c = _nearest_chunk(
                o[a:b], d[a:b], tris.v0, tris.e1, tris.e2,
                None if exclude is None else exclude[a:b])
            ts.append(t_c)
            idxs.append(i_c)
        t = torch.cat(ts) if ts else o.new_zeros((0,))
        idx = (torch.cat(idxs) if idxs
               else torch.zeros((0,), dtype=torch.int32, device=o.device))
        keep = None
        if t_max is not None:
            keep = t <= torch.as_tensor(t_max, dtype=torch.float32,
                                        device=o.device)
        if live is not None:
            keep = live if keep is None else keep & live
        if keep is not None:
            t = torch.where(keep, t, torch.inf)
            idx = torch.where(keep, idx, MISS)
        return t, idx


def recompute_hit_t(o, d, hit_idx, tris):
    """Differentiable parametric distance of an already-decided hit:
    ``t = (e2 . (s x e1)) / (e1 . (d x e2))`` of the gathered triangle,
    +inf where ``hit_idx < 0``."""
    safe = torch.clamp(hit_idx, min=0).long()
    v0, e1, e2 = tris.v0[safe], tris.e1[safe], tris.e2[safe]
    pvec = cross3(d, e2)
    det = dot3(e1, pvec)
    qvec = cross3(o - v0, e1)
    inv_det = 1.0 / torch.where(det == 0, 1.0, det)
    t = dot3(e2, qvec) * inv_det
    return torch.where(hit_idx >= 0, t, torch.inf)
