"""The fused bounce stages and the whole-loop material backward, as plain
torch: the counterparts of :mod:`hermespy_rt_tpu.ops.bounce_fused`.

Per bounce the fused path runs two per-ray maps around the batched shadow
query, and one per-ray map over the whole loop for the material backward:

* :func:`bounce_pre_plain` — after the bounce nearest hit: the hit payload
  and material id, the reflection-half shading (hit distance, Fresnel with
  the free-space loss, amplitude update, specular step, delay and Doppler:
  :func:`~hermespy_rt_tpu_torch.ops.shade.shade_a`), then the per-RX shadow
  setup and self-plane crossing of ``tracer.bounce_step``;
* :func:`bounce_post_plain` — after the shadow query: the self-hit merge,
  occlusion decisions, the reference theta-clobber, the hemisphere test,
  ``scat_coefs`` and the six output rows per RX;
* :func:`loop_bwd_slim_plain` — the materials-only backward of the whole
  loop: bounces in reverse, the vjp of :func:`_post_light` then
  :func:`_pre_light` at the saved residuals, the state cotangent carried
  between bounces, and the eta cotangent summed per material;
* the per-stage backwards of the two stages (``torch.func.vjp``):
  :func:`bounce_pre_bwd_plain` / :func:`bounce_post_bwd_plain` with
  ``grad_positions`` (the vjp of the stage's differentiable core, JAX's
  ``_pre_diff`` / ``_post_diff``), :func:`bounce_pre_bwd_slim_plain` /
  :func:`bounce_post_bwd_slim_plain` without (the vjp of
  :func:`_pre_light` / :func:`_post_light`).  Each returns per-ray payload
  cotangent rows; :func:`~.fetch.scatter_add_plain` sums them into table
  rows.

The two forward stages also run the transmission modes that
:class:`FusedSpec` sets, as ``tracer.bounce_step`` does under straight
refraction: under ``spawn_transmission`` a ray whose pattern word ``pat``
has bit ``k`` set at bounce ``k`` takes the transmission coefficients and
keeps its direction, and writes into the exit side's hemisphere; under
``transmission`` a blocked (ray, RX) is written with its gains times its
nearest blocker's transmission coefficients.  No backward takes them.

These are the plain versions of the CUDA kernels in ``csrc/bounce_fused.cu``
and ``csrc/bounce_bwd.cu`` (wrappers in :mod:`.bounce_fused_cuda`): the same
formulas in the same operation order as the op path
(``tracer.bounce_step``), so every decision equals the op path's.  Layout:
per-ray rows with rays on the last axis (``[k, R]``), 3-vectors as
``[R, 3]`` (``[nrx, R, 3]`` per RX), the form the nearest-hit query reads,
so the loop makes no transposes.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import torch

from .fresnel import ETA_FIELDS, EtaPrecomputed, refl_coefs
from .geometry import dot3, fast_acos
from .intersect import FLT_EPS
from .scattering import scat_coefs
from .shade import (_CLIP, GEOM_COLS, SPEED_OF_LIGHT, shade_a,
                    split_payload, through_blocker)

__all__ = ["FusedSpec", "PreOut", "PostOut", "bounce_pre_plain",
           "bounce_post_plain", "loop_bwd_slim_plain", "bounce_pre_bwd_plain",
           "bounce_post_bwd_plain", "bounce_pre_bwd_slim_plain",
           "bounce_post_bwd_slim_plain", "payload_cols", "GEOM_COLS",
           "TABLE_COLS", "NORMAL_COL"]

TABLE_COLS = GEOM_COLS + len(ETA_FIELDS)  # + the 12 eta columns = 27
NORMAL_COL = 9                         # the normal's first column
_S, _S1A = ETA_FIELDS.index("s"), ETA_FIELDS.index("s1_alpha")


@dataclasses.dataclass(frozen=True)
class FusedSpec:
    """Static configuration of the fused stages: the RX count, the parity
    mode, which cotangents the backward gives and the physical-mode
    occlusion offset.

    ``grad_geometry`` False stops the payload's geometry columns (and the
    occluder normals): only the eta columns get a table cotangent.
    ``grad_positions`` False makes positions, launch geometry and the
    carrier scalars constants of the backward: the stages' backwards are
    then the slim ones, which re-evaluate only the Fresnel and scattering
    chains at the saved residuals; that needs ``grad_geometry`` False.

    ``transmission`` and ``spawn_transmission`` are ``TracerConfig``'s
    modes under straight refraction, for the forward stages alone; like
    them they need physical parity."""

    nrx: int
    parity: str = "reference"          # "reference" | "physical"
    grad_geometry: bool = True
    grad_positions: bool = True
    eps_o: float = 1e-4
    transmission: bool = False
    spawn_transmission: bool = False

    def __post_init__(self):
        if self.nrx < 1:
            raise ValueError(f"FusedSpec: nrx must be >= 1, got {self.nrx}")
        if self.parity not in ("reference", "physical"):
            raise ValueError(f"FusedSpec: unknown parity {self.parity!r}")
        if ((self.transmission or self.spawn_transmission)
                and self.parity != "physical"):
            raise ValueError("FusedSpec: the transmission modes need "
                             "parity='physical'")
        if not self.grad_positions and self.grad_geometry:
            raise ValueError(
                "FusedSpec(grad_positions=False) requires grad_geometry="
                "False: the slim backward drops geometry cotangents "
                "(tau/Doppler/hit-distance chains) by construction")


class PreOut(NamedTuple):
    """Outputs of the pre stage for R rays and nrx receivers."""

    o2: torch.Tensor        # f32[R, 3]  ray origins after the bounce
    d2: torch.Tensor        # f32[R, 3]  ray directions after the bounce
    st2: torch.Tensor       # f32[6, R]  ate re/im, atm re/im, tau, freq
    ex: torch.Tensor        # f32[3, R]  theta, cos_t1, ndot
    sh_o: torch.Tensor      # f32[nrx, R, 3] shadow-query origins
    sh_d: torch.Tensor      # f32[nrx, R, 3] shadow directions (unit)
    d2rx: torch.Tensor      # f32[nrx, R] hit point to RX distance
    t_self: torch.Tensor    # f32[nrx, R] own-plane crossing distance
    crossing: torch.Tensor  # bool[nrx, R]
    excl: torch.Tensor      # i32[R]  hit triangle, -1 for dead rays
    live: torch.Tensor      # bool[R]
    mat: torch.Tensor       # i32[R]  material of the (clamped) hit
    res: torch.Tensor       # f32[3, R] cos_t1, sin_t1, fscale (backward)


class PostOut(NamedTuple):
    """Outputs of the post stage."""

    out: torch.Tensor       # f32[nrx, 6, R] te re/im, tm re/im, tau, freq
    write: torch.Tensor     # bool[nrx, R]
    res: torch.Tensor       # f32[nrx, 6, R] theta_s, theta_i, cos_ts,
    #                         cos_ti, sin_ti, wf (backward)


def _eta_cols(rows) -> EtaPrecomputed:
    """EtaPrecomputed from the 12 eta columns of ``[..., 12]`` rows."""
    return EtaPrecomputed(**{f: rows[..., i]
                             for i, f in enumerate(ETA_FIELDS)})


def payload_cols(spec: FusedSpec, stage: str) -> int:
    """Columns of the per-ray payload cotangent rows a stage's backward
    returns: the last ``n`` of the 27 table columns.  Full backwards return
    all 27 with ``grad_geometry``, else the columns that carry a material
    cotangent: the 12 eta columns (pre) or (s, s1_alpha) (post)."""
    if spec.grad_geometry:
        return TABLE_COLS
    return len(ETA_FIELDS) if stage == "pre" else 2


def _stop_geometry(spec: FusedSpec, row):
    """Payload rows with the geometry columns detached unless
    ``spec.grad_geometry`` (JAX ``_pre_diff``/``_post_diff``'s cut)."""
    if spec.grad_geometry:
        return row
    return torch.cat([row[..., :GEOM_COLS].detach(), row[..., GEOM_COLS:]],
                     dim=-1)


def _transmit(spec: FusedSpec, pat, k):
    """Which rays transmit at bounce ``k`` (bool[R], bit ``k`` of their
    pattern words) under ``spawn_transmission``, else None."""
    if not spec.spawn_transmission:
        return None
    return ((pat >> k) & 1) != 0


def _pre_core(spec: FusedSpec, o, d, st, row, rx, sc, live, transmit=None):
    """The pre stage after the payload fetch, JAX ``_pre_diff`` and
    ``_pre_nondiff``: ``row`` f32[R, 27] hit payload rows, ``rx`` the RX
    positions as f32[nrx, 1 | R, 3] and ``sc`` (fslm, k_dop) as f32[2] or
    f32[2, R]; ``transmit`` as :func:`_transmit` gives it.  Returns the
    differentiable outputs ``(o2, d2, st2, ex, sh_d, d2rx)`` and the rest
    ``(sh_o, t_self, crossing, res)``, which carry no gradient: the
    shadow-query origins and the residuals are detached, the crossing
    decisions are comparisons."""
    fslm, k_dop = sc[0], sc[1]
    hit = dict(v0=row[:, 0:3], e1=row[:, 3:6], e2=row[:, 6:9],
               normal=row[:, 9:12], velocity=row[:, 12:15])
    (o2, d2, ate_re, ate_im, atm_re, atm_im, tau, freq, theta, cos_t1, ndot,
     sin_t1, fscale) = shade_a(o, d, st[0], st[1], st[2], st[3], st[4],
                               st[5], live, hit, _eta_cols(row[:, GEOM_COLS:]),
                               fslm, k_dop, transmit=transmit)
    n = hit["normal"]

    # the scatter-pre lines of tracer.bounce_step
    so = o2[None].expand(spec.nrx, -1, -1)                     # [nrx, R, 3]
    ds_un = rx - so
    n2 = dot3(ds_un, ds_un)
    pos = n2 > 0
    d2rx = torch.where(pos, torch.sqrt(torch.where(pos, n2, 1.0)), 0.0)
    ds = ds_un / torch.where(d2rx > 0, d2rx, 1.0)[..., None]
    ds_dot_n = dot3(ds, n[None]).detach()
    dint_n = dot3(d2, n).detach()
    t_self = -1e-4 * dint_n[None, :] / torch.where(ds_dot_n == 0.0, 1.0,
                                                    ds_dot_n)
    crossing = (ds_dot_n * dint_n[None, :] < 0.0) & live[None]
    sh_o = (so.contiguous() if spec.parity == "reference"
            else so + spec.eps_o * ds).detach()
    diff = (o2, d2, torch.stack([ate_re, ate_im, atm_re, atm_im, tau, freq]),
            torch.stack([theta, cos_t1, ndot]), ds, d2rx)
    rest = (sh_o, t_self, crossing,
            torch.stack([cos_t1, sin_t1, fscale]).detach())
    return diff, rest


def bounce_pre_plain(spec: FusedSpec, o, d, st, act, idx, table, material,
                     rx_pos, sc, pat=None, k=0) -> PreOut:
    """Pre stage.  ``o``/``d`` f32[R, 3] rays, ``st`` f32[6, R] state,
    ``act`` bool[R], ``idx`` i32[R] bounce hits (-1 miss), ``table``
    f32[T, 27] payload (v0, e1, e2, normal, velocity, eta), ``material``
    i32[T], ``rx_pos`` f32[nrx, 3], ``sc`` f32[2] = (fslm, k_dop); under
    ``spec.spawn_transmission`` ``pat`` i32[R] the rays' pattern words and
    ``k`` the bounce."""
    live = act & (idx >= 0)
    safe = torch.clamp(idx, min=0).long()
    (o2, d2, st2, ex, sh_d, d2rx), (sh_o, t_self, crossing, res) = _pre_core(
        spec, o, d, st, table[safe], rx_pos[:, None, :], sc, live,
        _transmit(spec, pat, k))
    return PreOut(
        o2=o2, d2=d2, st2=st2, ex=ex, sh_o=sh_o, sh_d=sh_d, d2rx=d2rx,
        t_self=t_self, crossing=crossing, excl=torch.where(live, idx, -1),
        live=live, mat=material[safe].to(torch.int32), res=res)


def _post_decisions(spec: FusedSpec, t_self, crossing, excl, d2rx, t_o,
                    idx_o):
    """Self-hit merge and occlusion (tracer.bounce_step's decisions): the
    merged occluder ``idx_m`` i32[nrx, R] (-1: none) and ``blocked``."""
    if spec.parity == "reference":
        self_hit = crossing & (t_self > FLT_EPS)
        closer = self_hit & (t_self < t_o)
        t_m = torch.where(closer, t_self, t_o)
        idx_m = torch.where(closer, excl[None], idx_o)
        blocked = (idx_m >= 0) & (t_m <= 1.0)
    else:
        limit = d2rx - 2.0 * spec.eps_o
        t_self_q = t_self - spec.eps_o
        self_hit = crossing & (t_self_q > FLT_EPS) & (t_self_q <= limit)
        closer = self_hit & (t_self_q < t_o)
        t_m = torch.where(closer, t_self_q, t_o)
        idx_m = torch.where(closer, excl[None], idx_o)
        blocked = (idx_m >= 0) & (t_m <= limit)
    return idx_m, blocked


def _post_core(spec: FusedSpec, d2, st2, ex, sh_d, d2rx, row, n_o, sc, live,
               blocked, occl_hit, transmit=None, blockers=None):
    """The post stage after its decisions, JAX ``_post_diff``: ``row``
    f32[R, 27] payload rows of the hit, ``n_o`` f32[nrx, R, 3] the merged
    occluders' normals (read under reference parity only), ``sc`` as in
    :func:`_pre_core`; ``transmit`` as :func:`_transmit` gives it, and under
    ``spec.transmission`` ``blockers`` f32[nrx, R, 27] the merged
    occluders' payload rows.  Returns ``(out, write, res)``; ``res`` is
    detached."""
    fslm, k_dop = sc[0], sc[1]
    n, vel = row[:, 9:12], row[:, 12:15]
    s_row, s1_row = row[:, GEOM_COLS + _S], row[:, GEOM_COLS + _S1A]
    theta, cos_t1, ndot = ex[0], ex[1], ex[2]
    ate_re, ate_im, atm_re, atm_im, tau, freq = st2.unbind(0)
    ds = sh_d

    ds_dot_n = dot3(ds, n[None])                               # [nrx, R]
    cos_ts = torch.clamp(ds_dot_n, -_CLIP, _CLIP)
    theta_s = fast_acos(cos_ts)
    if spec.parity == "reference":
        # the shadow hit's angle clobbers the incidence angle, and the
        # clobber persists into the following RX
        cos_o = torch.clamp(torch.abs(dot3(n_o, ds)), 0.0, _CLIP)
        th_o = fast_acos(cos_o)
        th_c, cos_c = theta, cos_t1
        th_used, cos_used = [], []
        for k in range(spec.nrx):
            th_c = torch.where(occl_hit[k], th_o[k], th_c)
            cos_c = torch.where(occl_hit[k], cos_o[k], cos_c)
            th_used.append(th_c)
            cos_used.append(cos_c)
        theta_i = torch.stack(th_used)
        cos_ti = torch.stack(cos_used)
        write = live[None] & ~blocked
    else:
        theta_i = theta[None].expand_as(theta_s)
        cos_ti = cos_t1[None].expand_as(theta_s)
        # a reflection re-radiates into the incidence-side hemisphere, a
        # transmission into the exit side; a blocked pair is written under
        # transmission
        hemi = ds_dot_n * ndot[None] < 0.0
        if transmit is not None:
            hemi = torch.where(transmit[None], ds_dot_n * ndot[None] > 0.0,
                               hemi)
        write = live[None] & hemi
        if not spec.transmission:
            write = write & ~blocked
    sin_ti = torch.sqrt(1.0 - cos_ti * cos_ti)

    s_te_re, s_te_im, s_tm_re, s_tm_im = scat_coefs(
        theta_s, theta_i, s_row[None], s1_row[None],
        cos_ts=cos_ts, cos_ti=cos_ti, sin_ti=sin_ti)
    out_te_re = ate_re[None] * s_te_re - ate_im[None] * s_te_im
    out_te_im = ate_re[None] * s_te_im + ate_im[None] * s_te_re
    out_tm_re = atm_re[None] * s_tm_re - atm_im[None] * s_tm_im
    out_tm_im = atm_re[None] * s_tm_im + atm_im[None] * s_tm_re
    if spec.transmission:
        hit_b, eta_b = split_payload(blockers)
        out_te_re, out_te_im, out_tm_re, out_tm_im = through_blocker(
            (out_te_re, out_te_im, out_tm_re, out_tm_im), hit_b["normal"],
            eta_b, ds, blocked)

    fsl_s = fslm * d2rx
    fsl_s2 = fsl_s * fsl_s
    big = fsl_s2 > 1.0
    sscale = torch.where(big, 1.0 / torch.where(big, fsl_s2, 1.0), 1.0)
    wf = write.to(torch.float32) * sscale
    out_tau = torch.where(write, tau[None] + d2rx / SPEED_OF_LIGHT, 0.0)
    scat_dop = dot3(ds - d2[None], vel[None]) * k_dop
    out_freq = freq[None] - torch.where(live[None], scat_dop, 0.0)
    out = torch.stack([out_te_re * wf, out_te_im * wf, out_tm_re * wf,
                       out_tm_im * wf, out_tau, out_freq], dim=1)
    res = torch.stack([theta_s, theta_i, cos_ts, cos_ti, sin_ti, wf], dim=1)
    return out, write, res.detach()


def _post_operands(spec: FusedSpec, t_self, crossing, excl, d2rx, t_o, idx_o,
                   table):
    """The post stage's decisions and fetched rows: ``(idx_m, blocked,
    row, n_o)``."""
    idx_m, blocked = _post_decisions(spec, t_self, crossing, excl, d2rx, t_o,
                                     idx_o)
    row = table[torch.clamp(excl, min=0).long()]               # [R, 27]
    if spec.parity == "reference":
        n_o = table[torch.clamp(idx_m, min=0).long(), 9:12]    # [nrx, R, 3]
    else:
        n_o = row.new_zeros((spec.nrx, row.shape[0], 3))
    return idx_m, blocked, row, n_o


def bounce_post_plain(spec: FusedSpec, d2, st2, ex, sh_d, d2rx, t_self,
                      crossing, excl, live, t_o, idx_o, table, sc, pat=None,
                      k=0) -> PostOut:
    """Post stage.  The pre stage's outputs plus the shadow query's
    ``t_o`` f32[nrx, R] and ``idx_o`` i32[nrx, R] (under ``transmission``
    the nearest blocker, not any); ``pat`` and ``k`` as in
    :func:`bounce_pre_plain`."""
    idx_m, blocked, row, n_o = _post_operands(spec, t_self, crossing, excl,
                                              d2rx, t_o, idx_o, table)
    blockers = (table[torch.clamp(idx_m, min=0).long()] if spec.transmission
                else None)
    out, write, res = _post_core(spec, d2, st2, ex, sh_d, d2rx, row, n_o, sc,
                                 live, blocked, idx_m >= 0,
                                 _transmit(spec, pat, k), blockers)
    return PostOut(out=out, write=write, res=res)


# ---------------------------------------------------------------------------
# the materials-only backward

def _pre_light(eta_rows, st, *, live, cos_t1, sin_t1, fscale):
    """The part of the pre stage that carries a material cotangent: Fresnel
    at the saved incidence residuals, the free-space scale and the
    amplitude update; tau and freq pass through (their additive terms are
    constants of this backward).  ``eta_rows`` f32[12, R], ``st`` f32[6, R].
    """
    r_te_re, r_te_im, r_tm_re, r_tm_im = refl_coefs(
        EtaPrecomputed(**{f: eta_rows[i] for i, f in enumerate(ETA_FIELDS)}),
        cos_t1, sin_t1)
    r_te_re, r_te_im = r_te_re * fscale, r_te_im * fscale
    r_tm_re, r_tm_im = r_tm_re * fscale, r_tm_im * fscale
    ate_re, ate_im, atm_re, atm_im = st[0], st[1], st[2], st[3]
    new_ate_re = ate_re * r_te_re - ate_im * r_te_im
    new_ate_im = ate_re * r_te_im + ate_im * r_te_re
    new_atm_re = atm_re * r_tm_re - atm_im * r_tm_im
    new_atm_im = atm_re * r_tm_im + atm_im * r_tm_re
    return torch.stack([
        torch.where(live, new_ate_re, ate_re),
        torch.where(live, new_ate_im, ate_im),
        torch.where(live, new_atm_re, atm_re),
        torch.where(live, new_atm_im, atm_im),
        st[4], st[5]])


def _post_light(ss_rows, st2, *, res):
    """The part of the post stage that carries a material cotangent:
    ``scat_coefs`` at the saved angle residuals ``res`` f32[nrx, 6, R]
    (theta_s, theta_i, cos_ts, cos_ti, sin_ti, wf), the amplitude multiply
    and the write scale; the masked tau and the freq pass through.
    ``ss_rows`` f32[2, R] = (s, s1_alpha).  Returns f32[nrx, 6, R]."""
    theta_s, theta_i, cos_ts, cos_ti, sin_ti, wf = res.unbind(1)
    s_te_re, s_te_im, s_tm_re, s_tm_im = scat_coefs(
        theta_s, theta_i, ss_rows[0][None], ss_rows[1][None],
        cos_ts=cos_ts, cos_ti=cos_ti, sin_ti=sin_ti)
    ate_re, ate_im, atm_re, atm_im, tau2, freq2 = (x[None] for x in st2)
    out_te_re = ate_re * s_te_re - ate_im * s_te_im
    out_te_im = ate_re * s_te_im + ate_im * s_te_re
    out_tm_re = atm_re * s_tm_re - atm_im * s_tm_im
    out_tm_im = atm_re * s_tm_im + atm_im * s_tm_re
    out_tau = torch.where(wf > 0, tau2, 0.0)
    return torch.stack([out_te_re * wf, out_te_im * wf, out_tm_re * wf,
                        out_tm_im * wf, out_tau, freq2.expand_as(wf)], dim=1)


def loop_bwd_slim_plain(spec: FusedSpec, eta_tab, st_all, live_all, mat_all,
                        res_pre, res_post, d_out):
    """Materials-only backward of the whole fused loop.

    ``eta_tab`` f32[M, 12] per-material eta rows; ``st_all`` f32[B+1, 6, R]
    (the state before each bounce and after the last); ``live_all``
    bool[B, R]; ``mat_all`` i32[B, R]; ``res_pre`` f32[B, 3, R];
    ``res_post`` and ``d_out`` f32[B, nrx, 6, R].  Returns ``(d_st0
    f32[6, R], d_eta_tab f32[M, 12])``."""
    B = st_all.shape[0] - 1
    d_carry = torch.zeros_like(st_all[0])
    d_tab = torch.zeros_like(eta_tab)
    for b in range(B - 1, -1, -1):
        m = mat_all[b].long()
        eta_rows = eta_tab[m].T                                 # [12, R]
        _, vjp_post = torch.func.vjp(partial(_post_light, res=res_post[b]),
                                     eta_rows[_S:_S1A + 1], st_all[b + 1])
        d_ss, d_st2 = vjp_post(d_out[b])
        d_st2 = d_st2 + d_carry
        rp = res_pre[b]
        _, vjp_pre = torch.func.vjp(
            partial(_pre_light, live=live_all[b], cos_t1=rp[0], sin_t1=rp[1],
                    fscale=rp[2]), eta_rows, st_all[b])
        d_eta, d_carry = vjp_pre(d_st2)
        # the post chain's (s, s1_alpha) cotangent joins eta rows 10 and 11
        d_eta = torch.cat([d_eta[:_S], d_eta[_S:] + d_ss])
        d_tab.index_add_(0, m, d_eta.T)
    return d_carry, d_tab


# ---------------------------------------------------------------------------
# the per-stage backwards

def _per_ray(rx_pos, sc, R):
    """The RX positions f32[nrx, R, 3] and carrier scalars f32[2, R] as
    per-ray inputs of a vjp, so that the backward gives each ray's share of
    their cotangents."""
    nrx = rx_pos.shape[0]
    return (rx_pos[:, None, :].expand(nrx, R, 3).contiguous(),
            sc[:, None].expand(2, R).contiguous())


def bounce_pre_bwd_plain(spec: FusedSpec, o, d, st, act, idx, table, rx_pos,
                         sc, d_o2, d_d2, d_st2, d_ex, d_sh_d, d_d2rx,
                         sum_rays=True):
    """Full backward of the pre stage (``spec.grad_positions``), JAX
    ``_pre_bwd_kernel``: the vjp of :func:`_pre_core` at the forward's
    inputs, from the cotangents of ``(o2, d2, st2, ex, sh_d, d2rx)``.
    Returns ``(d_o, d_d f32[R, 3], d_st f32[6, R], d_payload f32[R, n],
    d_rxp f32[nrx, 3], d_sc f32[2])``: the payload rows are the last ``n =
    payload_cols(spec, "pre")`` table columns, to be summed into the rows
    of the live rays' hits; with ``sum_rays`` False ``d_rxp`` f32[nrx, R,
    3] and ``d_sc`` f32[2, R] are each ray's share."""
    live = act & (idx >= 0)
    row = table[torch.clamp(idx, min=0).long()]
    rx, scr = _per_ray(rx_pos, sc, o.shape[0])

    def f(o, d, st, row, rx, scr):
        return _pre_core(spec, o, d, st, _stop_geometry(spec, row), rx, scr,
                         live)[0]

    _, vjp = torch.func.vjp(f, o, d, st, row, rx, scr)
    d_o, d_d, d_st, d_row, d_rx, d_sc = vjp((d_o2, d_d2, d_st2, d_ex, d_sh_d,
                                             d_d2rx))
    d_payload = d_row[:, TABLE_COLS - payload_cols(spec, "pre"):].contiguous()
    if sum_rays:
        d_rx, d_sc = d_rx.sum(1), d_sc.sum(1)
    return d_o, d_d, d_st, d_payload, d_rx, d_sc


def bounce_post_bwd_plain(spec: FusedSpec, d2, st2, ex, sh_d, d2rx, t_self,
                          crossing, excl, live, t_o, idx_o, table, sc, d_out,
                          sum_rays=True):
    """Full backward of the post stage (``spec.grad_positions``), JAX
    ``_post_bwd_kernel``: the decisions again, then the vjp of
    :func:`_post_core` from the cotangent ``d_out`` f32[nrx, 6, R].
    Returns ``(d_d2 f32[R, 3], d_st2 f32[6, R], d_ex f32[3, R], d_sh_d
    f32[nrx, R, 3], d_d2rx f32[nrx, R], d_payload f32[R, n], d_n_o, occ,
    d_sc f32[2])``: the payload rows are the last ``n = payload_cols(spec,
    "post")`` table columns, to be summed into the rows ``excl``; under
    reference parity with ``grad_geometry`` ``d_n_o`` f32[nrx, R, 3] are the
    cotangents of the occluder normals, to be summed into the normal
    columns of the rows ``occ`` i32[nrx, R] (-1: none), else both are
    None; with ``sum_rays`` False ``d_sc`` f32[2, R] per ray."""
    idx_m, blocked, row, n_o = _post_operands(spec, t_self, crossing, excl,
                                              d2rx, t_o, idx_o, table)
    scr = sc[:, None].expand(2, d2.shape[0]).contiguous()

    def f(d2, st2, ex, sh_d, d2rx, row, n_o, scr):
        if not spec.grad_geometry:
            n_o = n_o.detach()
        return _post_core(spec, d2, st2, ex, sh_d, d2rx,
                          _stop_geometry(spec, row), n_o, scr, live, blocked,
                          idx_m >= 0)[0]

    _, vjp = torch.func.vjp(f, d2, st2, ex, sh_d, d2rx, row, n_o, scr)
    d_d2, d_st2, d_ex, d_sh_d, d_d2rx, d_row, d_n_o, d_sc = vjp(d_out)
    d_payload = d_row[:, TABLE_COLS - payload_cols(spec, "post"):].contiguous()
    occ = idx_m.to(torch.int32)
    if not (spec.grad_geometry and spec.parity == "reference"):
        d_n_o = occ = None
    return (d_d2, d_st2, d_ex, d_sh_d, d_d2rx, d_payload, d_n_o, occ,
            d_sc.sum(1) if sum_rays else d_sc)


def bounce_pre_bwd_slim_plain(spec: FusedSpec, st, act, idx, table, res,
                              d_st2):
    """Slim backward of the pre stage (without ``grad_positions``), JAX
    ``_pre_bwd_slim_kernel``: the vjp of :func:`_pre_light` at the saved
    residuals ``res`` f32[3, R].  Returns ``(d_st f32[6, R], d_eta f32[R,
    12])``, the eta rows to be summed into the rows of the live rays'
    hits."""
    live = act & (idx >= 0)
    eta_rows = table[torch.clamp(idx, min=0).long(), GEOM_COLS:].T
    _, vjp = torch.func.vjp(
        partial(_pre_light, live=live, cos_t1=res[0], sin_t1=res[1],
                fscale=res[2]), eta_rows, st)
    d_eta, d_st = vjp(d_st2)
    return d_st, d_eta.T.contiguous()


def bounce_post_bwd_slim_plain(spec: FusedSpec, st2, excl, table, res,
                               d_out):
    """Slim backward of the post stage, JAX ``_post_bwd_slim_kernel``: the
    vjp of :func:`_post_light` at the saved residuals ``res`` f32[nrx, 6,
    R].  Returns ``(d_st2 f32[6, R], d_ss f32[R, 2])``, the (s, s1_alpha)
    rows to be summed into the rows ``excl``."""
    ss = table[torch.clamp(excl, min=0).long(),
               GEOM_COLS + _S:GEOM_COLS + _S1A + 1].T
    _, vjp = torch.func.vjp(partial(_post_light, res=res), ss, st2)
    d_ss, d_st2 = vjp(d_out)
    return d_st2, d_ss.T.contiguous()
