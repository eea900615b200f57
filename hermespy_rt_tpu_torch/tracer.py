"""The differentiable multipath tracer: LoS pass + specular-bounce/scatter loop.

The counterpart of :mod:`hermespy_rt_tpu.tracer` in PyTorch: Fibonacci-sphere
ray launch per TX, a LoS occlusion pass per (RX, TX) pair, then
``num_bounces`` rounds of nearest-hit query, ITU Fresnel reflection with
per-segment free-space loss, specular ray update, mesh-velocity Doppler and a
scatter-to-RX shadow-ray pass with directive scattering coefficients.  Both
parity modes are kept, with the reference's 1-metre shadow window, its
theta-clobber chain and its LoS Doppler from velocity row 0.

Hit indices are decisions without gradient; every differentiable quantity is
re-derived from the gathered triangle row, so ``loss.backward()`` reaches the
material table (and, with ``grad_geometry``, the triangle payload) through
plain autograd.  The bounce scan of the JAX package is a Python loop here.

With ``shade="fused"`` the bounce loop runs per bounce two fused kernels
around the shadow query (``ops/bounce_fused_cuda.py``).  With
``grad_positions=False`` (and ``unroll_bounces``) the loop is one autograd
node, :class:`FusedLoopSlim`, whose material backward is one kernel, as the
JAX package's ``fused_loop_slim``; otherwise each stage is an autograd node
whose backward is a kernel (:func:`run_fused_loop_stages`), as JAX's
per-stage ``bounce_pre`` / ``bounce_post``.

Scenes of 4096 padded triangles and more (``walk="auto"``) answer every
query through the visit-list walk (``ops/walk_cuda.py``) instead of the brute
scan; physical-parity shadow queries then stop each ray at its first blocker
within range (``shadow_any_hit``).  Otherwise ``cull`` sends every query
(LoS, bounce, shadow) to the culled brute kernel, which skips the triangle
tiles no ray of a block reaches.

On the op path every payload fetch is the row-gather kernel, whose backward
is the scatter-add kernel (``ops/fetch_cuda.py``), and ``shade="pallas"``
runs each bounce's reflection half as one kernel (``ops/shade_cuda.py``).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Dict, Optional

import numpy as np
import torch

from .config import TracerConfig
from .ops import bounce_fused_cuda as fused_ops
from .ops.bounce_fused import NORMAL_COL, FusedSpec
from .ops.fetch_cuda import gather_rows
from .ops.fresnel import ETA_FIELDS, EtaPrecomputed, precompute_eta
from .ops.geometry import dot3, fast_acos, fibonacci_sphere
from .ops.intersect import FLT_EPS, intersect_torch
from .ops.intersect_cuda import nearest_hit, nearest_hit_culled
from .ops.scattering import scat_coefs
from .ops.shade import _CLIP, GEOM_COLS, SPEED_OF_LIGHT, shade_a, split_payload
from .ops.shade_cuda import shade_a_rows
from .ops.walk import cull_boxes, prepare_walk, triangle_records
from .ops.walk_cuda import walk_query
from .scene.model import TriangleSoA, _morton_order

__all__ = ["ChannelInfo", "RaysInfo", "PathsResult", "trace_paths",
           "LocalSceneAccess", "SPEED_OF_LIGHT", "PI"]

PI = float(np.float32(np.pi))


@dataclasses.dataclass(frozen=True)
class ChannelInfo:
    """Per-path channel parameters in the reference layout: ``num_rays`` is 1
    for LoS and ``num_bounces * num_paths`` for scatter, bounce-major."""

    directions_rx: torch.Tensor  # f32[NRx, NTx, K, 3]
    directions_tx: torch.Tensor  # f32[NRx, NTx, K, 3]
    a_te: torch.Tensor           # complex64[NRx, NTx, K]
    a_tm: torch.Tensor           # complex64[NRx, NTx, K]
    tau: torch.Tensor            # f32[NRx, NTx, K]  (seconds)
    freq_shift: torch.Tensor     # f32[NRx, NTx, K]  (Hz)

    @property
    def num_rays(self) -> int:
        return self.tau.shape[-1]


@dataclasses.dataclass(frozen=True)
class RaysInfo:
    """Ray segments per bounce: slot 0 holds the launch rays, slot ``b+1``
    the state after bounce ``b``."""

    origins: torch.Tensor     # f32[NTx, B+1, P, 3]
    directions: torch.Tensor  # f32[NTx, B+1, P, 3]
    active: torch.Tensor      # bool[NTx, B+1, P]


@dataclasses.dataclass(frozen=True)
class PathsResult:
    los: ChannelInfo
    scatter: ChannelInfo
    rays_los: Optional[RaysInfo] = None
    rays_scatter: Optional[RaysInfo] = None
    los_blocked: Optional[torch.Tensor] = None  # bool[NRx, NTx]


def _select_intersect(cfg: TracerConfig, tris: TriangleSoA):
    """The nearest-hit function for ``cfg.backend``: the plain twin for
    ``"torch"``, else the kernel's wrapper (the culled kernel's with
    ``cfg.cull``, on the scene's tile boxes), which alone decides by the
    rays' device (twin on CPU tensors, kernel or raise on CUDA ones).  The
    kernels' triangle records are built here, once per scene."""
    if cfg.backend == "torch":
        fn = intersect_torch
    else:
        records = triangle_records(tris.v0.detach(), tris.e1.detach(),
                                   tris.e2.detach())
        fn = (partial(nearest_hit_culled, aabbs=cull_boxes(tris),
                      records=records) if cfg.cull
              else partial(nearest_hit, records=records))
    return lambda o, d, tris, exclude=None, t_max=None, live=None: fn(
        o, d, tris, chunk_size=cfg.ray_chunk, exclude=exclude, t_max=t_max,
        live=live)


def _walks(cfg: TracerConfig, tris: TriangleSoA) -> bool:
    """Whether the queries walk: ``walk`` True, or "auto" from 4096 padded
    triangles up (the JAX package's measured crossover); never on the
    "torch" backend, which scans every triangle."""
    if cfg.backend == "torch":
        return False
    if cfg.walk == "auto":
        return tris.pad_triangles >= 4096
    return bool(cfg.walk)


class LocalSceneAccess:
    """The whole triangle SoA on this device, with the per-hit payload
    (triangle basis, normal, velocity, material eta row) in ONE ``[T, 27]``
    table so that a hit fetch is a single row gather, the per-material eta
    rows ``[M, 12]`` and the int32 triangle materials (the fused path's).
    When the queries walk, the scene is cut for the walk once, here."""

    def __init__(self, tris: TriangleSoA, cfg: TracerConfig,
                 eta: EtaPrecomputed):
        self.tris = tris
        self.walk = prepare_walk(tris) if _walks(cfg, tris) else None
        self._intersect = (None if self.walk is not None
                           else _select_intersect(cfg, tris))
        self._grad_geometry = cfg.grad_geometry
        self._eta_tab = torch.stack([getattr(eta, f) for f in ETA_FIELDS],
                                    dim=-1)                           # [M, 12]
        self._material = tris.material.to(torch.int32)
        # each triangle's eta row; the backward sums them per material with
        # the scatter-add kernel (131,072 triangles of 2 materials would
        # serialise in PyTorch's indexing backward)
        eta_cols = gather_rows(self._eta_tab, self._material)         # [T, 12]
        self._table = torch.cat(
            [tris.v0, tris.e1, tris.e2, tris.normal, tris.velocity, eta_cols],
            dim=-1)                                                   # [T, 27]

    def intersect(self, o, d, t_max=None, exclude=None, live=None,
                  any_hit=False):
        """Nearest hit ``(t f32[R] (+inf miss), idx i32[R] (-1 miss))``;
        hits beyond ``t_max`` and dead rays (``live`` False) report misses.
        ``any_hit`` declares that the caller reads only whether a hit within
        ``t_max`` exists: the walk may then return any such hit; the brute
        scan ignores it (the nearest hit is a valid answer).  Decisions
        only: no gradient flows through them."""
        o, d = o.detach().contiguous(), d.detach().contiguous()
        if self.walk is not None:
            return walk_query(o, d, self.walk, exclude=exclude, t_max=t_max,
                              live=live, any_hit=any_hit)
        return self._intersect(o, d, self.tris, exclude=exclude, t_max=t_max,
                               live=live)

    def _geo(self, x):
        return x if self._grad_geometry else x.detach()

    def fetch_row(self, idx_safe):
        """The ``[R, 27]`` payload rows of already-clamped indices, through
        the row-gather kernel; under ``grad_geometry=False`` its backward
        sums only the eta columns (the geometry is detached downstream)."""
        return gather_rows(self._table, idx_safe, grad_cols=(
            None if self._grad_geometry else (GEOM_COLS, self._table.shape[1])))

    def split_row(self, row) -> Dict[str, object]:
        """The fetch dict of payload rows: v0/e1/e2/normal/velocity (behind
        ``detach`` unless ``grad_geometry``) and the eta rows."""
        hit, eta = split_payload(row, self._geo(row[..., :GEOM_COLS]))
        return dict(hit, eta=eta)

    def fetch(self, idx_safe) -> Dict[str, object]:
        """Per-hit payload for already-clamped indices."""
        return self.split_row(self.fetch_row(idx_safe))

    def normal_at(self, idx_safe):
        return self._geo(gather_rows(self._table, idx_safe,
                                     cols=(NORMAL_COL, NORMAL_COL + 3)))


def _safe_norm(v):
    n2 = dot3(v, v)
    pos = n2 > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, n2, 1.0)), 0.0)


def _los_pass(access: LocalSceneAccess, rx_pos, tx_pos, rx_vel, tx_vel, fslm,
              k_dop, cfg: TracerConfig):
    """LoS occlusion pass per (rx, tx) pair."""
    nrx, ntx = rx_pos.shape[0], tx_pos.shape[0]
    o = tx_pos[None, :, :].expand(nrx, ntx, 3).reshape(-1, 3)
    dvec = (rx_pos[:, None, :] - tx_pos[None, :, :]).reshape(-1, 3)

    d2 = dot3(dvec, dvec)
    coincident = d2 < FLT_EPS

    # occlusion only (t in units of |d|)
    t_hit, idx = access.intersect(o, dvec, t_max=1.0)
    blocked = (idx >= 0) & (t_hit <= 1.0) & ~coincident

    dist = torch.sqrt(torch.where(coincident, 1.0, d2))
    dn = dvec / torch.where(coincident, 1.0, dist)[:, None]

    fsl = fslm * dist
    big = fsl > 1.0
    amp = torch.where(big, 1.0 / torch.where(big, fsl, 1.0), 1.0)
    a_re = torch.where(coincident, 1.0, torch.where(blocked, 0.0, amp))
    a_im = torch.zeros_like(a_re)
    tau = torch.where(coincident | blocked, 0.0, dist / SPEED_OF_LIGHT)

    if cfg.parity == "reference":
        # reference quirk kept for parity: velocity row 0 for every pair
        txv = tx_vel[0].expand(nrx * ntx, 3)
        rxv = rx_vel[0].expand(nrx * ntx, 3)
    else:
        txv = tx_vel[None, :, :].expand(nrx, ntx, 3).reshape(-1, 3)
        rxv = rx_vel[:, None, :].expand(nrx, ntx, 3).reshape(-1, 3)
    freq = (dot3(txv, dn) - dot3(rxv, dn)) * k_dop
    freq = torch.where(coincident | blocked, 0.0, freq)

    x_hat = dn.new_tensor([1.0, 0.0, 0.0])
    dir_tx = torch.where(coincident[:, None], x_hat, dn)
    dir_rx = torch.where(coincident[:, None], -x_hat, -dn)

    a = torch.complex(a_re, a_im).reshape(nrx, ntx, 1)
    los = ChannelInfo(
        directions_rx=dir_rx.reshape(nrx, ntx, 1, 3),
        directions_tx=dir_tx.reshape(nrx, ntx, 1, 3),
        a_te=a, a_tm=a,
        tau=tau.reshape(nrx, ntx, 1),
        freq_shift=freq.reshape(nrx, ntx, 1),
    )
    rays = RaysInfo(
        origins=o.reshape(nrx, ntx, 1, 3).permute(1, 2, 0, 3),
        directions=dvec.reshape(nrx, ntx, 1, 3).permute(1, 2, 0, 3),
        active=(~blocked).reshape(nrx, ntx, 1).permute(1, 2, 0),
    ) if cfg.keep_rays else None
    return los, rays, blocked.reshape(nrx, ntx)


def _shadow_intersect(access, so, ds, t_max, excl, cfg: TracerConfig,
                      live=None, any_hit=False):
    """Shadow-ray nearest hit over the flattened ``[NRx * R]`` axis, in RX
    groups of at most ``cfg.rx_query_rays`` rays (the largest divisor of NRx
    that fits), one query per group.  ``so``/``ds`` are [NRx, R, 3];
    ``t_max``/``excl``/``live`` flat [NRx * R] or None; ``any_hit`` as in
    :meth:`LocalSceneAccess.intersect`."""
    nrx, R = so.shape[0], so.shape[1]
    c = max(1, cfg.rx_query_rays // R)          # rx rows per query
    while nrx % c:
        c -= 1
    if c >= nrx:
        return access.intersect(so.reshape(-1, 3), ds.reshape(-1, 3),
                                t_max=t_max, exclude=excl, live=live,
                                any_hit=any_hit)
    n = c * R
    part = lambda x, g: None if x is None else x[g * n:(g + 1) * n]
    ts, idxs = [], []
    for g in range(nrx // c):
        t, i = access.intersect(
            so[g * c:(g + 1) * c].reshape(-1, 3),
            ds[g * c:(g + 1) * c].reshape(-1, 3),
            t_max=part(t_max, g), exclude=part(excl, g), live=part(live, g),
            any_hit=any_hit)
        ts.append(t)
        idxs.append(i)
    return torch.cat(ts), torch.cat(idxs)


def bounce_step(state, *, access: LocalSceneAccess, rx_pos, fslm, k_dop,
                cfg: TracerConfig):
    """One bounce: reflect every active ray off its nearest triangle, then
    scatter a shadow ray from the hit point to every RX.  Returns the new
    state and this bounce's outputs."""
    o, d, ate_re, ate_im, atm_re, atm_im, tau, act, freq, pidx = state
    nrx = rx_pos.shape[0]

    # nearest hit, excluding the triangle each ray originates on
    _, idx = access.intersect(o, d, exclude=pidx,
                              live=act if cfg.compact_rays else None)
    live = act & (idx >= 0)
    safe = torch.clamp(idx, min=0)

    row = access.fetch_row(safe)
    hit = access.split_row(row)
    mat_rows = hit["eta"]
    shade_args = (o, d, ate_re, ate_im, atm_re, atm_im, tau, freq, live)
    if cfg.shade == "pallas":
        shaded = shade_a_rows(*shade_args, row, fslm, k_dop,
                              grad_geometry=cfg.grad_geometry)
    else:
        shaded = shade_a(*shade_args, hit, mat_rows, fslm, k_dop)
    (o, d, ate_re, ate_im, atm_re, atm_im, tau, freq, theta, cos_t1,
     ndot, _, _) = shaded
    n = hit["normal"]
    vel = hit["velocity"]
    s_row, s1_row = mat_rows.s, mat_rows.s1_alpha

    # scatter-to-RX shadow rays, all RX batched into one query
    so = o[None].expand(nrx, -1, -1)                           # [NRx, R, 3]
    ds_un = rx_pos[:, None, :] - so                            # [NRx, R, 3]
    d2rx = _safe_norm(ds_un)                                   # [NRx, R]
    ds = ds_un / torch.where(d2rx > 0, d2rx, 1.0)[..., None]

    live_b = live[None].expand_as(d2rx)
    ds_dot_n = dot3(ds, n[None])                               # [NRx, R]

    # the shadow ray's own triangle is excluded from the query; whether it
    # crosses its own plane is decided analytically: the origin sits 1e-4
    # (d.n) off the plane, so it crosses at t0 = -1e-4 (d.n) / (ds.n)
    dint_n = dot3(d, n)
    t_self = -1e-4 * dint_n[None, :] / torch.where(ds_dot_n == 0.0, 1.0,
                                                    ds_dot_n)
    crossing = (ds_dot_n * dint_n[None, :] < 0.0) & live_b
    excl = torch.where(live, idx, -1)[None].expand_as(d2rx).reshape(-1)
    lv = live_b.reshape(-1) if cfg.compact_rays else None
    if cfg.parity == "reference":
        # reference quirk: with a normalised direction the occlusion test
        # still uses t <= 1, so only blockers within 1 metre count
        t_o, idx_o = _shadow_intersect(access, so, ds, None, excl, cfg,
                                       live=lv)
        self_hit = (crossing & (t_self > FLT_EPS)).reshape(-1)
        closer = self_hit & (t_self.reshape(-1) < t_o)
        t_o = torch.where(closer, t_self.reshape(-1), t_o)
        idx_o = torch.where(closer, excl, idx_o)
        blocked = (idx_o >= 0) & (t_o <= 1.0)
    else:
        eps_o = cfg.occlusion_offset
        limit = d2rx.reshape(-1) - 2.0 * eps_o
        # only `blocked` is read from this query, so the walk may stop each
        # shadow ray at its first blocker within the limit
        t_o, idx_o = _shadow_intersect(access, so + eps_o * ds, ds,
                                       limit.detach(), excl, cfg, live=lv,
                                       any_hit=cfg.shadow_any_hit)
        # in query coordinates the origin is a further eps_o along ds
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

    if cfg.parity == "reference":
        # reference quirk: the shadow query writes its hit angle into the
        # incidence angle scat_coefs reads; any shadow hit clobbers it and
        # the clobber persists into the following RX iterations
        idx_o2 = idx_o.reshape(nrx, -1)
        occl_hit = idx_o2 >= 0
        n_o = access.normal_at(torch.clamp(idx_o2, min=0))     # [NRx, R, 3]
        cos_o = torch.clamp(torch.abs(dot3(n_o, ds)), 0.0, _CLIP)
        th_o = fast_acos(cos_o)
        th_c, cos_c = theta, cos_t1
        th_used, cos_used = [], []
        for k in range(nrx):
            th_c = torch.where(occl_hit[k], th_o[k], th_c)
            cos_c = torch.where(occl_hit[k], cos_o[k], cos_c)
            th_used.append(th_c)
            cos_used.append(cos_c)
        theta_i_scat = torch.stack(th_used)                    # [NRx, R]
        cos_ti = torch.stack(cos_used)
        write = live[None] & ~blocked
    else:
        theta_i_scat = theta[None].expand_as(theta_s)
        cos_ti = cos_t1[None].expand_as(theta_s)
        # a reflection re-radiates into the incidence-side hemisphere
        write = live[None] & ~blocked & (ds_dot_n * ndot[None] < 0.0)
    sin_ti = torch.sqrt(1.0 - cos_ti * cos_ti)

    s_te_re, s_te_im, s_tm_re, s_tm_im = scat_coefs(
        theta_s, theta_i_scat, s_row[None], s1_row[None],
        cos_ts=cos_ts, cos_ti=cos_ti, sin_ti=sin_ti)

    out_te_re = ate_re[None] * s_te_re - ate_im[None] * s_te_im
    out_te_im = ate_re[None] * s_te_im + ate_im[None] * s_te_re
    out_tm_re = atm_re[None] * s_tm_re - atm_im[None] * s_tm_im
    out_tm_im = atm_re[None] * s_tm_im + atm_im[None] * s_tm_re

    fsl_s = fslm * d2rx
    fsl_s2 = fsl_s * fsl_s
    big = fsl_s2 > 1.0
    sscale = torch.where(big, 1.0 / torch.where(big, fsl_s2, 1.0), 1.0)
    wf = write.to(torch.float32) * sscale

    out_te_re, out_te_im = out_te_re * wf, out_te_im * wf
    out_tm_re, out_tm_im = out_tm_re * wf, out_tm_im * wf
    out_tau = torch.where(write, tau[None] + d2rx / SPEED_OF_LIGHT, 0.0)
    # Doppler of the scattered leg; rays that died earlier keep their value
    scat_dop = dot3(ds - d[None], vel[None]) * k_dop
    out_freq = freq[None] - torch.where(live[None], scat_dop, 0.0)
    out_dir_rx = torch.where(write[..., None], -ds, 0.0)

    state = (o, d, ate_re, ate_im, atm_re, atm_im, tau, live, freq,
             torch.where(live, idx, -1))
    ys = (out_te_re, out_te_im, out_tm_re, out_tm_im, out_tau, out_freq,
          out_dir_rx, o, d, live)
    return state, ys


def launch_state(tx_pos, tx_vel, launch_dirs, k_dop):
    """Initial per-ray state over the flattened tx-major ray axis."""
    ntx = tx_pos.shape[0]
    P = launch_dirs.shape[0]
    d0 = launch_dirs.repeat(ntx, 1)                             # [R, 3]
    o0 = tx_pos.repeat_interleave(P, dim=0)                     # [R, 3]
    txv0 = tx_vel.repeat_interleave(P, dim=0)
    R = ntx * P
    ones = torch.ones((R,), dtype=torch.float32, device=tx_pos.device)
    zeros = torch.zeros_like(ones)
    freq0 = dot3(txv0, d0) * k_dop
    act = torch.ones((R,), dtype=torch.bool, device=tx_pos.device)
    pidx0 = torch.full((R,), -1, dtype=torch.int32, device=tx_pos.device)
    return (o0, d0, ones, zeros, ones, zeros, zeros, act, freq0, pidx0)


def _fused_spec(cfg: TracerConfig, nrx: int) -> FusedSpec:
    return FusedSpec(nrx=nrx, parity=cfg.parity,
                     grad_geometry=cfg.grad_geometry,
                     grad_positions=cfg.grad_positions,
                     eps_o=cfg.occlusion_offset)


def _fused_bounces(access: LocalSceneAccess, spec: FusedSpec,
                   cfg: TracerConfig, rx_pos, sc, table, st, o, d, act, pidx,
                   pre_fn, post_fn):
    """The fused bounce loop: per bounce the nearest hit, the pre stage
    ``pre_fn``, one all-RX shadow query and the post stage ``post_fn``
    (each called as its kernel wrapper, ``bounce_pre`` / ``bounce_post``).
    Yields ``(pre, post)`` per bounce."""
    nrx, R = spec.nrx, o.shape[0]
    for _ in range(cfg.num_bounces):
        _, idx = access.intersect(o, d, exclude=pidx,
                                  live=act if cfg.compact_rays else None)
        pre = pre_fn(spec, o, d, st, act, idx, table, access._material,
                     rx_pos, sc)
        t_max = (None if spec.parity == "reference"
                 else (pre.d2rx - 2.0 * spec.eps_o).detach().reshape(-1))
        excl_q = pre.excl[None].expand(nrx, R).reshape(-1)
        live_q = (pre.live[None].expand(nrx, R).reshape(-1)
                  if cfg.compact_rays else None)
        t_o, idx_o = _shadow_intersect(
            access, pre.sh_o, pre.sh_d, t_max, excl_q, cfg, live=live_q,
            any_hit=cfg.shadow_any_hit and spec.parity != "reference")
        post = post_fn(
            spec, pre.d2, pre.st2, pre.ex, pre.sh_d, pre.d2rx, pre.t_self,
            pre.crossing, pre.excl, pre.live, t_o.reshape(nrx, R),
            idx_o.reshape(nrx, R), table, sc)
        yield pre, post
        o, d, st, act, pidx = pre.o2, pre.d2, pre.st2, pre.live, pre.excl


def _bounce_ys(out, write, sh_d, cfg: TracerConfig, o2, d2, live):
    """One bounce's outputs in the ``ys`` layout of :func:`assemble_scatter`
    from the post stage's ``out`` [nrx, 6, R] and ``write``."""
    return ((out[:, 0], out[:, 1], out[:, 2], out[:, 3], out[:, 4],
             out[:, 5], torch.where(write[..., None], -sh_d, 0.0))
            + ((o2, d2, live) if cfg.keep_rays else ()))


def _fused_forward(access: LocalSceneAccess, spec: FusedSpec,
                   cfg: TracerConfig, rx_pos, sc, st0, o, d, act, pidx,
                   save: bool):
    """The fused bounce loop's forward through the kernel wrappers, on
    detached operands.  Returns the stacked per-bounce outputs ``(out [B,
    nrx, 6, R], write bool[B, nrx, R], sh_d [B, nrx, R, 3], live bool[B, R],
    o2 [B, R, 3] | None, d2 ...)`` and, with ``save``, the residuals of the
    material backward ``(st_all [B+1, 6, R], live, mat i32[B, R], res_pre
    [B, 3, R], res_post [B, nrx, 6, R])``, else None."""
    st = st0.detach()
    outs, writes, sh_ds, lives, o2s, d2s = ([] for _ in range(6))
    sts, mats, res_pre, res_post = [st], [], [], []
    # the wrappers are looked up at each call: a recorder may stand in
    for pre, post in _fused_bounces(
            access, spec, cfg, rx_pos, sc, access._table.detach(), st, o, d,
            act, pidx, lambda *a: fused_ops.bounce_pre(*a),
            lambda *a: fused_ops.bounce_post(*a)):
        outs.append(post.out)
        writes.append(post.write)
        sh_ds.append(pre.sh_d)
        lives.append(pre.live)
        if cfg.keep_rays:
            o2s.append(pre.o2)
            d2s.append(pre.d2)
        if save:
            sts.append(pre.st2)
            mats.append(pre.mat)
            res_pre.append(pre.res)
            res_post.append(post.res)
    primal = tuple(torch.stack(xs) if xs else None
                   for xs in (outs, writes, sh_ds, lives, o2s, d2s))
    if not save:
        return primal, None
    resid = (torch.stack(sts), primal[3], torch.stack(mats),
             torch.stack(res_pre), torch.stack(res_post))
    return primal, resid


class FusedLoopSlim(torch.autograd.Function):
    """The whole fused bounce loop as one autograd node, as the JAX
    package's ``fused_loop_slim``: the forward runs :func:`_fused_forward`
    and keeps its residuals; the backward is ONE ``loop_bwd_slim`` launch,
    which returns the cotangents of the per-material eta table ``eta_tab``
    [M, 12] and of the launch state ``st0`` [6, R].  Autograd carries the
    former on through ``precompute_eta`` to the material parameters.  The
    payload table enters detached and the queries are decisions, so nothing
    else receives a gradient (``grad_positions=False``)."""

    @staticmethod
    def forward(ctx, eta_tab, st0, spec, run):
        primal, resid = run(save=True)
        ctx.spec = spec
        ctx.save_for_backward(eta_tab, *resid)
        ctx.mark_non_differentiable(*(x for x in primal[1:]
                                      if x is not None))
        return primal

    @staticmethod
    def backward(ctx, d_out, *_):
        eta_tab, st_all, live_all, mat_all, res_pre, res_post = (
            ctx.saved_tensors)
        d_st0, d_eta_tab = fused_ops.loop_bwd_slim(
            ctx.spec, eta_tab.detach(), st_all, live_all, mat_all, res_pre,
            res_post, d_out.contiguous())
        return d_eta_tab, d_st0, None, None


def _launch_rows(state0):
    """The :func:`launch_state` tuple as the fused loop's operands
    ``(o, d, st [6, R], act, pidx)``."""
    o, d, ate_re, ate_im, atm_re, atm_im, tau, act, freq, pidx = state0
    return o, d, torch.stack([ate_re, ate_im, atm_re, atm_im, tau, freq]), \
        act, pidx


def run_fused_loop_slim(access: LocalSceneAccess, rx_pos, state0, fslm,
                        k_dop, cfg: TracerConfig):
    """The fused bounce loop from the :func:`launch_state` tuple as one
    :class:`FusedLoopSlim` node, its outputs in the per-bounce ``ys`` layout
    of :func:`assemble_scatter`.  Residuals are kept only when a gradient
    can be asked for."""
    o, d, st0, act, pidx = _launch_rows(state0)
    spec = _fused_spec(cfg, rx_pos.shape[0])
    sc = torch.stack([fslm, k_dop]).detach()
    run = partial(_fused_forward, access, spec=spec, cfg=cfg, rx_pos=rx_pos,
                  sc=sc, st0=st0, o=o, d=d, act=act, pidx=pidx)
    eta_tab = access._eta_tab
    if torch.is_grad_enabled() and (eta_tab.requires_grad
                                    or st0.requires_grad):
        out, write, sh_d, live, o2, d2 = FusedLoopSlim.apply(eta_tab, st0,
                                                             spec, run)
    else:
        (out, write, sh_d, live, o2, d2), _ = run(save=False)
    return [_bounce_ys(out[b], write[b], sh_d[b], cfg,
                       *((o2[b], d2[b], live[b]) if cfg.keep_rays
                         else (None,) * 3))
            for b in range(cfg.num_bounces)]


def run_fused_loop_stages(access: LocalSceneAccess, rx_pos, state0, fslm,
                          k_dop, cfg: TracerConfig):
    """The fused bounce loop from the :func:`launch_state` tuple with each
    stage an autograd node (``ops/bounce_fused_cuda.py``: ``BouncePreFn``,
    ``BouncePostFn``), the JAX package's per-stage custom_vjps: with
    ``grad_positions`` their backwards are the full per-stage kernels, so
    gradients reach positions, velocities, the frequency and (with
    ``grad_geometry``) the triangles through the live payload table;
    without, the slim ones.  Outputs in the ``ys`` layout of
    :func:`assemble_scatter`."""
    o, d, st0, act, pidx = _launch_rows(state0)
    spec = _fused_spec(cfg, rx_pos.shape[0])
    sc = torch.stack([fslm, k_dop])
    return [_bounce_ys(post.out, post.write, pre.sh_d, cfg, pre.o2, pre.d2,
                       pre.live)
            for pre, post in _fused_bounces(
                access, spec, cfg, rx_pos.contiguous(), sc, access._table,
                st0, o, d, act, pidx, fused_ops.bounce_pre_stage,
                fused_ops.bounce_post_stage)]


def assemble_scatter(ys, d0, o0, nrx, ntx, P, B, keep_rays: bool):
    """Stack the per-bounce outputs into the reference ChannelInfo layout
    ``(rx, tx, bounce*path)`` plus the per-bounce RaysInfo."""
    cols = list(zip(*ys))
    te_re, te_im, tm_re, tm_im, tau_s, freq_s, dir_rx = (
        torch.stack(c) for c in cols[:7])                   # each [B, ...]
    R = ntx * P

    def to_chan(x):  # [B, NRx, R] -> [NRx, NTx, B*P]
        return x.reshape(B, nrx, ntx, P).permute(1, 2, 0, 3).reshape(
            nrx, ntx, B * P)

    def to_chan3(x):  # [B, NRx, R, 3] -> [NRx, NTx, B*P, 3]
        return x.reshape(B, nrx, ntx, P, 3).permute(1, 2, 0, 3, 4).reshape(
            nrx, ntx, B * P, 3)

    a_te = torch.complex(to_chan(te_re), to_chan(te_im))
    a_tm = torch.complex(to_chan(tm_re), to_chan(tm_im))
    dir_tx = d0.reshape(1, ntx, 1, P, 3).expand(nrx, ntx, B, P, 3).reshape(
        nrx, ntx, B * P, 3)
    scatter = ChannelInfo(
        directions_rx=to_chan3(dir_rx), directions_tx=dir_tx,
        a_te=a_te, a_tm=a_tm, tau=to_chan(tau_s), freq_shift=to_chan(freq_s))

    rays_scatter = None
    if keep_rays:
        ro, rd, ract = (torch.stack(c) for c in cols[7:])

        def to_rays(x0, xs):  # [R, 3] + [B, R, 3] -> [NTx, B+1, P, 3]
            allx = torch.cat([x0[None], xs], dim=0)
            return allx.reshape(B + 1, ntx, P, 3).permute(1, 0, 2, 3)
        act_all = torch.cat([torch.ones((1, R), dtype=torch.bool,
                                        device=ract.device), ract], dim=0)
        rays_scatter = RaysInfo(
            origins=to_rays(o0, ro), directions=to_rays(d0, rd),
            active=act_all.reshape(B + 1, ntx, P).permute(1, 0, 2))
    return scatter, rays_scatter


def launch_directions(num_paths: int, order: str, device) -> torch.Tensor:
    """Fibonacci launch directions, in reference or direction-Morton order."""
    dirs = fibonacci_sphere(num_paths)
    if order == "coherent":
        dirs = dirs[_morton_order(dirs)]
    return torch.as_tensor(dirs, device=device)


def trace_paths(tris: TriangleSoA, materials, rx_pos, tx_pos, rx_vel, tx_vel,
                carrier_frequency_ghz, cfg: TracerConfig,
                launch_dirs: Optional[torch.Tensor] = None) -> PathsResult:
    """Trace LoS + scatter paths on the device that holds ``tris``.
    Differentiable with respect to ``materials`` (and, with
    ``cfg.grad_geometry``, the triangle payload) through autograd."""
    dev = tris.device
    f32 = dict(dtype=torch.float32, device=dev)
    rx_pos = torch.as_tensor(rx_pos, **f32).reshape(-1, 3)
    tx_pos = torch.as_tensor(tx_pos, **f32).reshape(-1, 3)
    rx_vel = torch.as_tensor(rx_vel, **f32).reshape(-1, 3)
    tx_vel = torch.as_tensor(tx_vel, **f32).reshape(-1, 3)
    nrx, ntx = rx_pos.shape[0], tx_pos.shape[0]
    P, B = cfg.num_paths, cfg.num_bounces

    f_hz = torch.as_tensor(carrier_frequency_ghz, **f32) * 1e9
    fslm = 4.0 * PI * f_hz / SPEED_OF_LIGHT
    k_dop = f_hz / SPEED_OF_LIGHT

    if launch_dirs is None:
        launch_dirs = launch_directions(P, cfg.resolved_launch_order, dev)
    eta = precompute_eta(materials, carrier_frequency_ghz)
    access = LocalSceneAccess(tris, cfg, eta)

    los, rays_los, los_blocked = _los_pass(access, rx_pos, tx_pos, rx_vel,
                                           tx_vel, fslm, k_dop, cfg)

    state = launch_state(tx_pos, tx_vel, launch_dirs, k_dop)
    o0, d0 = state[0], state[1]
    if cfg.shade == "fused":
        run = (run_fused_loop_stages
               if cfg.grad_positions or not cfg.unroll_bounces
               else run_fused_loop_slim)
        ys = run(access, rx_pos, state, fslm, k_dop, cfg)
    else:
        ys = []
        for _ in range(B):
            state, y = bounce_step(state, access=access, rx_pos=rx_pos,
                                   fslm=fslm, k_dop=k_dop, cfg=cfg)
            ys.append(y)
    scatter, rays_scatter = assemble_scatter(ys, d0, o0, nrx, ntx, P, B,
                                             cfg.keep_rays)
    return PathsResult(los=los, scatter=scatter, rays_los=rays_los,
                       rays_scatter=rays_scatter, los_blocked=los_blocked)
