"""The plain reference tracer that decides ``correct``.

A frozen copy, in plain torch, of the op path of ``hermespy_rt_tpu_torch``
(``tracer.py``: the launch directions, the LoS pass and ``bounce_step``
without the transmission modes; ``ops/intersect.py``, ``ops/shade.py``,
``ops/fresnel.py``, ``ops/scattering.py``, ``ops/geometry.py`` and
``scene/model.py::_morton_order``), copied at commit 4304014e.  It imports
nothing of the port and takes nothing the port made: the scene arrays, the
material rows, the positions and the launch directions are worked out here
from what the benchmark generated.

Every ray is traced on its own, so a sample of path indices gives the same
per-path outputs as the whole launch set.  The nearest hit is the brute
scan over every triangle (Möller–Trumbore with the C reference's
``FLT_EPSILON`` bounds, ties to the lowest triangle index); large scenes
run the same pair tests tile by tile, on the tiles a ray's slab test
reaches, with the same answers.  One TX.  The
whole chain runs in ``dtype``: float32 is the configuration's precision,
bfloat16 the control's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

FLT_EPS = 1.1920928955078125e-07
T_MAX = 1e9
SPEED_OF_LIGHT = float(np.float32(299792458.0))
PI = float(np.float32(np.pi))
_CLIP = float(np.float32(1.0) - np.float32(FLT_EPS))
_PI32 = np.float32(3.14159265358979323846)
_ASIN_POLY = tuple(float(np.float32(v)) for v in (
    0.999999996, 0.166667869, 0.074945353, 0.0455389549, 0.0239094263,
    0.0425537353))
_HALF_PI = float(np.float32(np.pi / 2))
# the brute scan's [rays, triangles] temporaries hold this many elements
PAIRS_PER_BLOCK = 1 << 24
# scenes of this many triangles and more are scanned tile by tile: each ray
# tests the triangles of the tiles whose box it reaches (the same pair
# tests as the brute scan, so the same answers)
CULL_FROM = 4096
TILE = 64
BOX_PAD = 1e-2           # m, around every tile's box
RAYS_PER_SLAB_BLOCK = 4096
PAIRS_PER_TEST_BLOCK = 1 << 16


# ---------------------------------------------------------------- scene
@dataclasses.dataclass(frozen=True)
class RefScene:
    """Triangles on one device: Möller–Trumbore basis, unit normal,
    material id and velocity, in the order the configuration states."""

    v0: torch.Tensor
    e1: torch.Tensor
    e2: torch.Tensor
    normal: torch.Tensor
    material: torch.Tensor   # int64[T]
    velocity: torch.Tensor
    tile_lo: Optional[torch.Tensor] = None   # [T / TILE, 3] tile boxes,
    tile_hi: Optional[torch.Tensor] = None   # padded; None: brute scan

    @property
    def num_triangles(self) -> int:
        return self.v0.shape[0]

    def to(self, dtype) -> "RefScene":
        return RefScene(*(x.to(dtype) if x is not None
                          and x.is_floating_point() else x
                          for x in dataclasses.astuple(self)))


def tile_boxes(v0, e1, e2):
    """The boxes of consecutive runs of :data:`TILE` triangles, float64
    corners grown by :data:`BOX_PAD` and a millionth of their size."""
    T = v0.shape[0]
    n = -(-T // TILE)
    pts = np.stack([v0, v0 + e1, v0 + e2], axis=1).astype(np.float64)
    pad = np.full((n * TILE - T, 3, 3), np.nan)
    pts = np.concatenate([pts, pad]).reshape(n, TILE * 3, 3)
    lo, hi = np.nanmin(pts, axis=1), np.nanmax(pts, axis=1)
    grow = BOX_PAD + 1e-6 * np.abs(np.concatenate([lo, hi])).max()
    return (lo - grow).astype(np.float32), (hi + grow).astype(np.float32)


def morton_order(points: np.ndarray) -> np.ndarray:
    """Stable sort permutation along 3x10-bit Morton codes of ``points``."""
    lo = points.min(axis=0)
    span = np.maximum(points.max(axis=0) - lo, 1e-12)
    q = np.clip(((points - lo) / span * 1023.0), 0, 1023).astype(np.uint64)

    def spread(x):
        x = (x | (x << 16)) & np.uint64(0x030000FF)
        x = (x | (x << 8)) & np.uint64(0x0300F00F)
        x = (x | (x << 4)) & np.uint64(0x030C30C3)
        x = (x | (x << 2)) & np.uint64(0x09249249)
        return x

    code = spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1)) \
        | (spread(q[:, 2]) << np.uint64(2))
    return np.argsort(code, kind="stable")


def scene_from_meshes(meshes, sort_triangles: bool, device) -> RefScene:
    """``meshes``: ``(vertices f32[V, 3], faces int[F, 3], material id)``
    tuples.  Normals ``normalize(cross(v2 - v1, v3 - v1))`` in float32;
    with ``sort_triangles`` the triangles in Morton order of their
    centroids.  No padding: padding triangles never hit."""
    v0s, e1s, e2s, mats = [], [], [], []
    for verts, faces, mat in meshes:
        tri = np.asarray(verts, np.float32)[np.asarray(faces, np.int64)]
        v0s.append(tri[:, 0])
        e1s.append(tri[:, 1] - tri[:, 0])
        e2s.append(tri[:, 2] - tri[:, 0])
        mats.append(np.full(len(faces), mat, np.int64))
    v0, e1, e2 = (np.concatenate(x).astype(np.float32)
                  for x in (v0s, e1s, e2s))
    n_un = np.cross(e1, e2)
    normal = (n_un / np.sqrt(np.sum(n_un * n_un, axis=-1, keepdims=True))
              ).astype(np.float32)
    material = np.concatenate(mats)
    if sort_triangles:
        perm = morton_order(v0 + (e1 + e2) / 3.0)
        v0, e1, e2, normal, material = (x[perm] for x in
                                        (v0, e1, e2, normal, material))
    t = lambda x: torch.as_tensor(x, device=device)
    lo = hi = None
    if len(v0) >= CULL_FROM:
        lo, hi = (t(x) for x in tile_boxes(v0, e1, e2))
    return RefScene(t(v0), t(e1), t(e2), t(normal), t(material),
                    torch.zeros_like(t(v0)), lo, hi)


# ------------------------------------------------------------- geometry
def fibonacci_sphere(num_paths: int) -> np.ndarray:
    """The reference's launch directions, f32[num_paths, 3], with its mixed
    float/double rounding chain."""
    k = np.arange(num_paths, dtype=np.float32) + np.float32(0.5)
    arg = np.float32(1.0) - (np.float32(2.0) * k) / np.float32(num_paths)
    phi = np.arccos(arg.astype(np.float64)).astype(np.float32)
    sqrt5 = np.sqrt(np.float32(5.0), dtype=np.float32)
    theta = ((_PI32 * (np.float32(1.0) + sqrt5)) * k).astype(np.float64)
    phi = phi.astype(np.float64)
    return np.stack([np.cos(theta) * np.sin(phi),
                     np.sin(theta) * np.sin(phi),
                     np.cos(phi)], axis=-1).astype(np.float32)


def launch_directions(num_paths: int, order: str) -> np.ndarray:
    """Fibonacci directions in path order (``"fibonacci"``) or in their own
    Morton order (``"coherent"``)."""
    dirs = fibonacci_sphere(num_paths)
    return dirs[morton_order(dirs)] if order == "coherent" else dirs


def dot3(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross3(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def _asin_core(x, x2):
    c0, c1, c2, c3, c4, c5 = _ASIN_POLY
    p = c5
    for c in (c4, c3, c2, c1, c0):
        p = p * x2 + c
    return x * p


def fast_acos(x):
    ax = torch.abs(x)
    small = ax <= 0.5
    asin_inner = _asin_core(x, x * x)
    s = torch.clamp(0.5 * (1.0 - ax), min=0.0)
    acos_pos = 2.0 * _asin_core(torch.sqrt(s), s)
    acos_outer = torch.where(x >= 0, acos_pos, PI - acos_pos)
    return torch.where(small, _HALF_PI - asin_inner, acos_outer)


def _safe_norm(v):
    n2 = dot3(v, v)
    pos = n2 > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, n2, 1.0)), 0.0)


# ---------------------------------------------------------- nearest hit
def _mt(o, d, v0, e1, e2):
    """Möller–Trumbore ``(t, valid)`` of broadcasting ``(x, y, z)``
    component tuples, in the C reference's order of operations."""
    ox, oy, oz = o
    dx, dy, dz = d
    v0x, v0y, v0z = v0
    e1x, e1y, e1z = e1
    e2x, e2y, e2z = e2
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
    inv_det = 1.0 / torch.where(det == 0, 1.0, det)
    u = (sx * px + sy * py + sz * pz) * inv_det
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    valid = ((torch.abs(det) >= FLT_EPS)
             & (u >= -FLT_EPS) & (u <= 1.0 + FLT_EPS)
             & (v >= -FLT_EPS) & (u + v <= 1.0 + FLT_EPS)
             & (t > FLT_EPS) & (t < T_MAX))
    return t, valid


def _comps(x):
    return x[..., 0], x[..., 1], x[..., 2]


def _nearest_culled(scene: RefScene, o, d, exclude, t_max, live):
    """The nearest hit over the tiles each ray's slab test reaches within
    its ``t_max``: per (ray, reached tile) the brute scan's pair tests on
    the tile's triangles, then per ray the least ``t``, ties to the lowest
    triangle index, as the brute scan decides."""
    T, dev, R = scene.num_triangles, o.device, o.shape[0]
    lim = (torch.full((R,), torch.inf, dtype=o.dtype, device=dev)
           if t_max is None else
           torch.as_tensor(t_max, device=dev).to(o.dtype).expand(R))
    ok = (torch.ones(R, dtype=torch.bool, device=dev) if live is None
          else live)
    lo, hi = scene.tile_lo.to(o.dtype)[None], scene.tile_hi.to(o.dtype)[None]
    lane = torch.arange(TILE, device=dev)
    out_t = torch.full((R,), torch.inf, dtype=o.dtype, device=dev)
    out_i = torch.full((R,), -1, dtype=torch.int64, device=dev)
    for a in range(0, R, RAYS_PER_SLAB_BLOCK):
        b = min(a + RAYS_PER_SLAB_BLOCK, R)
        ob, db = o[a:b, None], d[a:b, None]
        zero = db == 0
        inside = (ob >= lo) & (ob <= hi)
        inv = 1.0 / torch.where(zero, 1.0, db)
        t1, t2 = (lo - ob) * inv, (hi - ob) * inv
        t_in = torch.where(zero, torch.where(inside, -torch.inf, torch.inf),
                           torch.minimum(t1, t2)).amax(-1).clamp(min=0.0)
        t_out = torch.where(zero, torch.where(inside, torch.inf, -torch.inf),
                            torch.maximum(t1, t2)).amin(-1)
        reach = ((t_in <= t_out * (1 + 1e-5) + 1e-5)
                 & (t_in <= lim[a:b, None] * (1 + 1e-5) + 1e-5)
                 & ok[a:b, None])
        ray, tile = reach.nonzero(as_tuple=True)
        rs, ts, cs = [], [], []
        for p in range(0, ray.shape[0], PAIRS_PER_TEST_BLOCK):
            r = ray[p:p + PAIRS_PER_TEST_BLOCK] + a
            idx = (tile[p:p + PAIRS_PER_TEST_BLOCK, None] * TILE
                   + lane[None])                              # [K, TILE]
            safe = idx.clamp(max=T - 1)
            t, valid = _mt(tuple(c[r, None] for c in _comps(o)),
                           tuple(c[r, None] for c in _comps(d)),
                           _comps(scene.v0[safe]), _comps(scene.e1[safe]),
                           _comps(scene.e2[safe]))
            valid &= idx < T
            if exclude is not None:
                valid &= idx != exclude[r, None]
            tmin, arg = torch.min(torch.where(valid, t, torch.inf), dim=1)
            rs.append(r)
            ts.append(tmin)
            cs.append(idx.gather(1, arg[:, None])[:, 0])
        if not rs:
            continue
        r, tmin, cand = torch.cat(rs), torch.cat(ts), torch.cat(cs)
        out_t.scatter_reduce_(0, r, tmin, "amin")
        win = torch.isfinite(tmin) & (tmin == out_t[r])
        best = torch.full((R,), T, dtype=torch.int64, device=dev)
        best.scatter_reduce_(0, r[win], cand[win], "amin")
        out_i[a:b] = torch.where(best[a:b] < T, best[a:b], -1)
    return out_t, out_i


def nearest_hit(scene: RefScene, o, d, exclude=None, t_max=None, live=None):
    """``(t, idx)`` of the nearest valid hit of each ray ``(o, d)`` over
    every triangle (+inf / -1 on a miss); ``exclude`` one triangle a ray,
    ``t_max`` turns farther hits into misses, ``live`` False a miss.  Large
    scenes go tile by tile (:func:`_nearest_culled`), with the same
    answers."""
    with torch.no_grad():
        if scene.tile_lo is not None:
            t, idx = _nearest_culled(scene, o, d, exclude, t_max, live)
        else:
            t, idx = _nearest_brute(scene, o, d, exclude)
        keep = torch.ones_like(idx, dtype=torch.bool)
        if t_max is not None:
            keep &= t <= t_max
        if live is not None:
            keep &= live
        return torch.where(keep, t, torch.inf), torch.where(keep, idx, -1)


def _nearest_brute(scene: RefScene, o, d, exclude):
    """Every ray against every triangle, in blocks of rays."""
    T = scene.num_triangles
    block = max(1, PAIRS_PER_BLOCK // max(T, 1))
    tri = torch.arange(T, device=o.device)
    ts, idxs = [], []
    v0, e1, e2 = (tuple(c[None] for c in _comps(x))
                  for x in (scene.v0, scene.e1, scene.e2))
    for a in range(0, o.shape[0], block):
        t, valid = _mt(tuple(c[:, None] for c in _comps(o[a:a + block])),
                       tuple(c[:, None] for c in _comps(d[a:a + block])),
                       v0, e1, e2)
        if exclude is not None:
            valid &= tri[None, :] != exclude[a:a + block, None]
        tmin, arg = torch.min(torch.where(valid, t, torch.inf), dim=1)
        hit = torch.isfinite(tmin)
        ts.append(torch.where(hit, tmin, torch.inf))
        idxs.append(torch.where(hit, arg, -1))
    return torch.cat(ts), torch.cat(idxs)


# ------------------------------------------------------------ materials
ETA_FIELDS = ("eta_re", "eta_im", "eta_abs", "eta_abs_pow2",
              "eta_abs_inv_sqrt", "eta_sqrt_re", "eta_sqrt_im", "eta_inv_re",
              "eta_inv_im", "r", "s", "s1_alpha")


def _safe_sqrt(x):
    pos = x > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def precompute_eta(mats: Dict[str, torch.Tensor], f_ghz: float
                   ) -> Dict[str, torch.Tensor]:
    """ITU-R P.2040-3 ``eta = a f^b - j (c f^d) / (0.0556325027 f)`` and
    its derived rows, per material."""
    a = mats["a"]
    f = torch.as_tensor(f_ghz, dtype=a.dtype, device=a.device)
    eta_re = a * torch.pow(f, mats["b"])
    eta_im = (mats["c"] * torch.pow(f, mats["d"])) / (
        f.new_tensor(0.0556325027352135) * f)
    eta_abs_pow2 = eta_re * eta_re + eta_im * eta_im
    eta_abs = _safe_sqrt(eta_abs_pow2)
    s_re = _safe_sqrt((eta_re + eta_abs) * 0.5)
    zero_im = (torch.abs(eta_im) < FLT_EPS) & (eta_re >= -FLT_EPS)
    s_im_mag = _safe_sqrt((eta_abs - eta_re) * 0.5)
    s_im = torch.where(zero_im, 0.0,
                       torch.where(eta_im < 0, -s_im_mag, s_im_mag))
    return dict(eta_re=eta_re, eta_im=eta_im, eta_abs=eta_abs,
                eta_abs_pow2=eta_abs_pow2,
                eta_abs_inv_sqrt=1.0 / _safe_sqrt(eta_abs),
                eta_sqrt_re=s_re, eta_sqrt_im=s_im,
                eta_inv_re=eta_re / eta_abs_pow2,
                eta_inv_im=-eta_im / eta_abs_pow2,
                r=1.0 - mats["s"], s=mats["s"], s1_alpha=mats["s1_alpha"])


def _cdiv(a_re, a_im, b_re, b_im):
    den = b_re * b_re + b_im * b_im
    pos = den > 0
    safe = torch.where(pos, den, 1.0)
    c_re = (a_re * b_re + a_im * b_im) / safe
    c_im = (a_im * b_re - a_re * b_im) / safe
    return torch.where(pos, c_re, 0.0), torch.where(pos, c_im, 0.0)


def refl_coefs(eta, cos_t1, sin_t1):
    """Complex (R_TE, R_TM), eqs. 31a/31b with the C reference's
    approximation of eq. 33, its TIR guard and the ``1 - s`` reduction."""
    tir = eta["eta_abs_inv_sqrt"] * sin_t1 > 1.0 - FLT_EPS
    sin2 = sin_t1 * sin_t1
    c2_re = _safe_sqrt(1.0 + eta["eta_inv_re"] / eta["eta_abs_pow2"] * sin2)
    c2_im = _safe_sqrt(1.0 - eta["eta_inv_im"] / eta["eta_abs_pow2"] * sin2)
    sec_re = eta["eta_sqrt_re"] * c2_re - eta["eta_sqrt_im"] * c2_im
    sec_im = eta["eta_sqrt_re"] * c2_im + eta["eta_sqrt_im"] * c2_re
    te_re, te_im = _cdiv(cos_t1 - sec_re, -sec_im, cos_t1 + sec_re, sec_im)
    sc1_re = eta["eta_sqrt_re"] * cos_t1
    sc1_im = eta["eta_sqrt_im"] * cos_t1
    tm_re, tm_im = _cdiv(sc1_re - c2_re, sc1_im - c2_im, sc1_re + c2_re,
                         sc1_im + c2_im)
    r = eta["r"]
    return (torch.where(tir, 1.0, te_re * r), torch.where(tir, 0.0, te_im * r),
            torch.where(tir, 1.0, tm_re * r), torch.where(tir, 0.0, tm_im * r))


def scat_coefs(theta_s, theta_i, s, s1_alpha, cos_ts, cos_ti, sin_ti):
    """Directive rough-surface scattering coefficients (S_TE, S_TM)."""
    f = s * torch.exp(-s1_alpha * torch.abs(theta_s - theta_i))
    rough = 1.0 / (1.0 + s1_alpha)
    specular = rough * cos_ts
    diffuse = (1.0 - rough) * cos_ts
    te_re = f * (specular + diffuse)
    tm_re = f * (specular * cos_ti + diffuse)
    sin_phase = torch.sin(s1_alpha * sin_ti * 0.1)
    te_im = te_re * sin_phase
    tm_im = tm_re * sin_phase
    norm2 = te_re * te_re + te_im * te_im + tm_re * tm_re + tm_im * tm_im
    norm = torch.sqrt(torch.where(norm2 > 0, norm2, 1.0))
    do = norm > 1e-6
    inv = torch.where(do, 1.0 / torch.where(do, norm, 1.0), 1.0)
    return te_re * inv, te_im * inv, tm_re * inv, tm_im * inv


# ---------------------------------------------------------------- trace
@dataclasses.dataclass
class Setup:
    """What one trace needs besides the rays: scene, RX/TX, frequency,
    parity and the occlusion offset, all in the trace's dtype."""

    scene: RefScene
    rx: torch.Tensor          # [nrx, 3]
    tx: torch.Tensor          # [3]
    f_ghz: float
    parity: str
    eps_o: float = 1e-4

    @property
    def f_hz(self):
        return torch.as_tensor(self.f_ghz, dtype=self.rx.dtype,
                               device=self.rx.device) * 1e9


def los_pass(su: Setup):
    """LoS per RX: ``(a f32[nrx] real gain, tau, freq, dir_rx [nrx, 3],
    dir_tx)``, zero gain where blocked (no transmission mode)."""
    nrx = su.rx.shape[0]
    o = su.tx[None].expand(nrx, 3)
    dvec = su.rx - su.tx[None]
    d2 = dot3(dvec, dvec)
    coincident = d2 < FLT_EPS
    t_hit, idx = nearest_hit(su.scene, o, dvec, t_max=1.0)
    blocked = (idx >= 0) & (t_hit <= 1.0) & ~coincident
    dist = torch.sqrt(torch.where(coincident, 1.0, d2))
    dn = dvec / torch.where(coincident, 1.0, dist)[:, None]
    fslm = 4.0 * PI * su.f_hz / SPEED_OF_LIGHT
    fsl = fslm * dist
    big = fsl > 1.0
    amp = torch.where(big, 1.0 / torch.where(big, fsl, 1.0), 1.0)
    a = torch.where(coincident, 1.0, torch.where(blocked, 0.0, amp))
    tau = torch.where(coincident | blocked, 0.0, dist / SPEED_OF_LIGHT)
    freq = torch.zeros_like(tau)    # static TX and RX
    x_hat = dn.new_tensor([1.0, 0.0, 0.0])
    dir_tx = torch.where(coincident[:, None], x_hat, dn)
    dir_rx = torch.where(coincident[:, None], -x_hat, -dn)
    return a, tau, freq, dir_rx, dir_tx


def _bounce(su: Setup, eta_tab, state, hits: Optional[dict]):
    """One bounce of every ray in ``state`` (the port's ``bounce_step``
    without transmission).  ``hits`` holds this bounce's query answers
    (``idx``, ``t_o``, ``idx_o``) from an earlier pass over the same rays,
    or None to query; returns ``(state, outputs, hits)``."""
    o, d, ate_re, ate_im, atm_re, atm_im, tau, act, freq, pidx = state
    scene, rx, nrx = su.scene, su.rx, su.rx.shape[0]
    fslm = 4.0 * PI * su.f_hz / SPEED_OF_LIGHT
    k_dop = su.f_hz / SPEED_OF_LIGHT
    if hits is None:
        _, idx = nearest_hit(scene, o.detach(), d.detach(), exclude=pidx,
                             live=act)
    else:
        idx = hits["idx"]
    live = act & (idx >= 0)
    safe = torch.clamp(idx, min=0)
    v0, e1, e2 = scene.v0[safe], scene.e1[safe], scene.e2[safe]
    n, vel = scene.normal[safe], scene.velocity[safe]
    mat = scene.material[safe]
    eta = {k: v[mat] for k, v in eta_tab.items()}

    # shading: the hit distance, incidence, Fresnel reflection, free-space
    # loss, the amplitude update, the specular continuation and Doppler
    pvec = cross3(d, e2)
    det = dot3(e1, pvec)
    qvec = cross3(o - v0, e1)
    inv_det = 1.0 / torch.where(det == 0, 1.0, det)
    t = torch.where(live, dot3(e2, qvec) * inv_det, 0.0)
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
    n_ate_re = ate_re * r_te_re - ate_im * r_te_im
    n_ate_im = ate_re * r_te_im + ate_im * r_te_re
    n_atm_re = atm_re * r_tm_re - atm_im * r_tm_im
    n_atm_im = atm_re * r_tm_im + atm_im * r_tm_re
    ate_re = torch.where(live, n_ate_re, ate_re)
    ate_im = torch.where(live, n_ate_im, ate_im)
    atm_re = torch.where(live, n_atm_re, atm_re)
    atm_im = torch.where(live, n_atm_im, atm_im)
    tau = tau + torch.where(live, t / SPEED_OF_LIGHT, 0.0)
    hitp = o + t[:, None] * d
    d_ref = d - 2.0 * dot3(d, n)[..., None] * n
    lv = live[:, None]
    o2 = torch.where(lv, hitp + 1e-4 * d_ref, o)
    d2 = torch.where(lv, d_ref, d)
    freq = freq + torch.where(live, dot3(d_ref - d, vel) * k_dop, 0.0)
    o, d = o2, d2

    # scatter to every RX with the shadow test
    so = o[None].expand(nrx, -1, -1)
    ds_un = rx[:, None, :] - so
    d2rx = _safe_norm(ds_un)
    ds = ds_un / torch.where(d2rx > 0, d2rx, 1.0)[..., None]
    live_b = live[None].expand_as(d2rx)
    ds_dot_n = dot3(ds, n[None])
    dint_n = dot3(d, n)
    t_self = -1e-4 * dint_n[None, :] / torch.where(ds_dot_n == 0.0, 1.0,
                                                    ds_dot_n)
    crossing = (ds_dot_n * dint_n[None, :] < 0.0) & live_b
    excl = torch.where(live, idx, -1)[None].expand_as(d2rx).reshape(-1)
    lv = live_b.reshape(-1)
    if su.parity == "reference":
        if hits is None:
            t_o, idx_o = nearest_hit(scene, so.reshape(-1, 3).detach(),
                                     ds.reshape(-1, 3).detach(),
                                     exclude=excl, live=lv)
        else:
            t_o, idx_o = hits["t_o"], hits["idx_o"]
        new_hits = dict(idx=idx, t_o=t_o, idx_o=idx_o)
        self_hit = (crossing & (t_self > FLT_EPS)).reshape(-1)
        closer = self_hit & (t_self.reshape(-1) < t_o)
        t_o = torch.where(closer, t_self.reshape(-1), t_o)
        idx_o = torch.where(closer, excl, idx_o)
        blocked = (idx_o >= 0) & (t_o <= 1.0)
    else:
        eps_o = su.eps_o
        limit = d2rx.reshape(-1) - 2.0 * eps_o
        if hits is None:
            t_o, idx_o = nearest_hit(
                scene, (so + eps_o * ds).reshape(-1, 3).detach(),
                ds.reshape(-1, 3).detach(), exclude=excl,
                t_max=limit.detach(), live=lv)
        else:
            t_o, idx_o = hits["t_o"], hits["idx_o"]
        new_hits = dict(idx=idx, t_o=t_o, idx_o=idx_o)
        t_self_q = t_self.reshape(-1) - eps_o
        self_hit = (crossing.reshape(-1) & (t_self_q > FLT_EPS)
                    & (t_self_q <= limit))
        closer = self_hit & (t_self_q < t_o)
        t_o = torch.where(closer, t_self_q, t_o)
        idx_o = torch.where(closer, excl, idx_o)
        blocked = (idx_o >= 0) & (t_o <= limit)
    blocked = blocked.reshape(nrx, -1)
    cos_ts = torch.clamp(ds_dot_n, -_CLIP, _CLIP)
    theta_s = fast_acos(cos_ts)
    if su.parity == "reference":
        # the C reference's theta clobber: a shadow hit writes its angle
        # into the incidence angle, and it persists into later RX
        idx_o2 = idx_o.reshape(nrx, -1)
        occl_hit = idx_o2 >= 0
        n_o = scene.normal[torch.clamp(idx_o2, min=0)]
        cos_o = torch.clamp(torch.abs(dot3(n_o, ds)), 0.0, _CLIP)
        th_o = fast_acos(cos_o)
        th_c, cos_c, th_used, cos_used = theta, cos_t1, [], []
        for k in range(nrx):
            th_c = torch.where(occl_hit[k], th_o[k], th_c)
            cos_c = torch.where(occl_hit[k], cos_o[k], cos_c)
            th_used.append(th_c)
            cos_used.append(cos_c)
        theta_i, cos_ti = torch.stack(th_used), torch.stack(cos_used)
        hemi = None
    else:
        theta_i = theta[None].expand_as(theta_s)
        cos_ti = cos_t1[None].expand_as(theta_s)
        hemi = ds_dot_n * ndot[None] < 0.0
    sin_ti = torch.sqrt(1.0 - cos_ti * cos_ti)
    s_te_re, s_te_im, s_tm_re, s_tm_im = scat_coefs(
        theta_s, theta_i, eta["s"][None], eta["s1_alpha"][None], cos_ts,
        cos_ti, sin_ti)
    te_re = ate_re[None] * s_te_re - ate_im[None] * s_te_im
    te_im = ate_re[None] * s_te_im + ate_im[None] * s_te_re
    tm_re = atm_re[None] * s_tm_re - atm_im[None] * s_tm_im
    tm_im = atm_re[None] * s_tm_im + atm_im[None] * s_tm_re
    fsl_s = fslm * d2rx
    fsl_s2 = fsl_s * fsl_s
    big = fsl_s2 > 1.0
    sscale = torch.where(big, 1.0 / torch.where(big, fsl_s2, 1.0), 1.0)
    write = live[None] & ~blocked
    if hemi is not None:
        write = write & hemi
    wf = write.to(sscale.dtype) * sscale
    out = dict(te_re=te_re * wf, te_im=te_im * wf, tm_re=tm_re * wf,
               tm_im=tm_im * wf,
               tau=torch.where(write, tau[None] + d2rx / SPEED_OF_LIGHT, 0.0),
               freq=freq[None] - torch.where(
                   live[None], dot3(ds - d[None], vel[None]) * k_dop, 0.0),
               dir_rx=torch.where(write[..., None], -ds, 0.0), live=live)
    state = (o, d, ate_re, ate_im, atm_re, atm_im, tau, live, freq,
             torch.where(live, idx, -1))
    return state, out, new_hits


def trace_rays(su: Setup, eta_tab, dirs: torch.Tensor, num_bounces: int,
               hits: Optional[List[dict]] = None):
    """Trace the launch directions ``dirs`` [K, 3] from the TX through
    ``num_bounces`` bounces.  Returns ``(outs, hits)``: per bounce the
    outputs (``te_re`` ... ``dir_rx`` [nrx, K(, 3)], ``live`` [K]) and the
    query answers, which a later call on the same rays may pass back as
    ``hits`` to skip the queries (they do not depend on the materials)."""
    K = dirs.shape[0]
    dt = dirs.dtype
    ones = torch.ones(K, dtype=dt, device=dirs.device)
    zeros = torch.zeros_like(ones)
    state = (su.tx[None].expand(K, 3), dirs, ones, zeros, ones, zeros, zeros,
             torch.ones(K, dtype=torch.bool, device=dirs.device), zeros,
             torch.full((K,), -1, dtype=torch.int64, device=dirs.device))
    outs, new_hits = [], []
    for b in range(num_bounces):
        state, out, h = _bounce(su, eta_tab, state,
                                None if hits is None else hits[b])
        outs.append(out)
        new_hits.append(h)
    return outs, new_hits
