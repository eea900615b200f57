"""Checks of the port's kernels against their plain versions.

Shared by ``chip_smoke.py`` (on the card) and the tests
(``tests/test_torch_fused.py``, ``tests/test_torch_stages.py`` and
``tests/test_torch_shade.py`` on the CPU against the JAX package,
``tests/test_torch_cuda.py`` on the card): the tolerances with their
reasons, the comparisons, a recorder of the kernels' calls inside the tracer
(the fused stages, the row gather, the shading, the culled query and the
scatter-add), and the material-calibration step of the JAX package's
``bench.py`` (re-exported from :mod:`.bench`, which ``hrt-torch-bench``
times).  Imports no JAX.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from . import tracer as tracer_module
from .bench import calibration_config, calibration_step
from .materials import MATERIAL_FIELDS, MaterialTable, default_materials
from .ops import bounce_fused_cuda as fused_ops
from .ops import fetch_cuda, shade_cuda
from .ops.bounce_fused import (GEOM_COLS, TABLE_COLS, bounce_post_bwd_plain,
                               bounce_post_bwd_slim_plain, bounce_post_plain,
                               bounce_pre_bwd_plain,
                               bounce_pre_bwd_slim_plain, bounce_pre_plain,
                               loop_bwd_slim_plain)
from .ops.fetch import (gather_plain, scatter_add_ordered_plain,
                        scatter_add_plain)
from .ops.fresnel import ETA_FIELDS, precompute_eta
from .ops.intersect_cuda import nearest_hit
from .ops.shade import shade_a_plain
from .ops.walk import CULL_BLOCK_RAYS, culled_reach_plain, query_limits

__all__ = ["ROW_RTOL", "LEAF_RTOL", "LEAF_ATOL", "PATH_GRAD_RTOL",
           "SUM_RTOL", "FAR_RAY_SHARE", "AMP_GROUPS", "VEC_GROUPS", "FUSED",
           "STAGE_BWD", "KERNELS", "PLAIN", "OUTPUT_FIELDS",
           "CheckFailure", "check", "ulp_gap", "rows_close", "leaves_close",
           "slots_agree", "recording_fused", "material_grads", "grads_of",
           "hold_pre", "hold_post", "hold_bwd", "hold_pre_bwd",
           "hold_post_bwd", "hold_pre_bwd_slim", "hold_post_bwd_slim",
           "hold_scatter_add", "hold_gather", "hold_shade", "hold_culled",
           "material_table", "calibration_config", "calibration_step",
           "calibration_launches", "grad_loss", "TRANSMISSION_MODES",
           "transmission_config", "transmission_launches"]

# Tier of the fused kernels against their plain versions: decisions equal;
# value rows within 3e-5 of their row's largest magnitude
# (tests/test_bounce_fused.py::_assert_close_rows), a complex value's
# (re, im) rows and a vector's components taken together; the backward's
# material gradients, pushed through precompute_eta to the material
# parameters, within 3e-5 of each leaf's largest magnitude plus 1e-16
# (tests/test_bounce_fused.py:125), against the plain version in float64
# (the plain version's own index_add_ sums ~10^6 terms per material in f32
# atomics, which alone drift by ~1e-4 of the sum).
ROW_RTOL = 3e-5
LEAF_RTOL, LEAF_ATOL = 3e-5, 1e-16
AMP_GROUPS = ((0, 1), (2, 3), (4,), (5,))   # state and output rows
VEC_GROUPS = ((0, 1, 2),)                    # a vector's components
# fused vs op-path material gradients at 2^16 paths: ~10^5 f32 terms per
# material summed in different orders on the two paths (random-walk
# rounding ~sqrt(N) 2^-24 ~ 2e-5 of the sum), the tier of
# tests/test_torch_tracer.py's gradient test
PATH_GRAD_RTOL = 1e-4
# A sum across rays taken on the card (the RX-position and carrier-scalar
# cotangents: per-block butterflies, then the blocks; a table row of the
# scatter-add: on its dense route each warp's range of rows in row order,
# then the warps of a block in order, then the blocks in order; on its
# sorted route ray order in chunks of 128, then the chunks in order)
# against the plain version's in float64: a sum of f32 terms rounded in
# sequence is within (number of roundings) 2^-24 of the exact sum, relative
# to the sum of the terms' magnitudes; below 1e-4 of it up to ~10^5
# roundings on any path of the sum, whatever cancels.
SUM_RTOL = 1e-4

FUSED = ("bounce_pre", "bounce_post", "loop_bwd_slim")
STAGE_BWD = ("bounce_pre_bwd", "bounce_post_bwd", "bounce_pre_bwd_slim",
             "bounce_post_bwd_slim")
# the module whose attribute each recorded wrapper is, as the tracer calls it
_MODULES = {**{name: fused_ops for name in FUSED + STAGE_BWD},
            "scatter_add": fetch_cuda, "gather": fetch_cuda,
            "shade_a": shade_cuda, "nearest_hit_culled": tracer_module}
KERNELS = {"nearest_hit": nearest_hit,
           **{name: getattr(mod, name) for name, mod in _MODULES.items()}}
PLAIN = {"bounce_pre": bounce_pre_plain, "bounce_post": bounce_post_plain,
         "loop_bwd_slim": loop_bwd_slim_plain,
         "bounce_pre_bwd": bounce_pre_bwd_plain,
         "bounce_post_bwd": bounce_post_bwd_plain,
         "bounce_pre_bwd_slim": bounce_pre_bwd_slim_plain,
         "bounce_post_bwd_slim": bounce_post_bwd_slim_plain,
         "scatter_add": scatter_add_plain, "gather": gather_plain,
         "shade_a": shade_a_plain}
OUTPUT_FIELDS = ("a_te", "a_tm", "tau", "freq_shift", "directions_rx")


class CheckFailure(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailure(msg)


def ulp_gap(a, b):
    """Largest distance in f32 units in the last place between ``a``, ``b``."""
    def ordered(x):
        i = x.contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((ordered(a) - ordered(b)).abs().max()) if a.numel() else 0


def _beyond(k, p, rtol, groups=None, atol=0.0):
    """``(|k - p|, where it exceeds rtol x the row's (or row group's)
    largest |p| plus atol)``, rays on the last axis."""
    k2, p2 = k.detach().double(), p.detach().double()
    scale = p2.abs().amax(dim=-1, keepdim=True)
    for g in groups or ():
        scale[..., list(g), :] = scale[..., list(g), :].amax(dim=-2,
                                                             keepdim=True)
    err = (k2 - p2).abs()
    return err, err > rtol * scale + atol


def rows_close(k, p, rtol, label, groups=None, atol=0.0):
    """|k - p| within ``rtol`` of the largest |p| of its row (rays on the
    last axis), or of its group of rows: a complex value's (re, im) pair, a
    vector's three components, whose small parts come from cancellation of
    the large ones; plus ``atol``.  Returns the max abs error; a failure
    names the worst values (index, kernel, plain, the row's max)."""
    err, bad = _beyond(k, p, rtol, groups, atol)
    if bool(bad.any()):
        where = bad.nonzero()
        worst = err[bad].argsort(descending=True)[:4]
        rows = [(tuple(where[w].tolist()), float(k[tuple(where[w])]),
                 float(p[tuple(where[w])]),
                 float(p.detach().abs().amax(-1)[tuple(where[w][:-1])]))
                for w in worst.tolist()]
        check(False, f"{label}: {int(bad.sum())} values beyond {rtol} of "
              f"their row's max (+ {atol}); worst (index, kernel, plain, "
              f"row max): {rows}")
    return float(err.max()) if err.numel() else 0.0


def leaves_close(g_k, g_p, rtol, atol, label):
    """Each leaf within ``rtol`` of its largest |g_p| plus ``atol``.
    Returns the largest error as a share of its leaf's max."""
    worst = 0.0
    for f in g_p:
        a, b = g_p[f].double(), g_k[f].double()
        scale = float(a.abs().max())
        err = float((a - b).abs().max())
        check(err <= rtol * max(scale, 1e-30) + atol,
              f"{label}: leaf {f} err {err} > {rtol} x {scale} + {atol}")
        worst = max(worst, err / scale if scale > 0 else 0.0)
    return worst


def slots_agree(ref, ours, label):
    """The written scatter slots of two traces: > 99.5% written alike, the
    slots both wrote within rtol 1e-4 (plus 1e-5 of the largest).  Returns
    the share written alike."""
    ref, ours = ref.detach().cpu().numpy(), ours.detach().cpu().numpy()
    w_r, w_o = np.abs(ref) > 0, np.abs(ours) > 0
    if ref.ndim == 4:
        w_r, w_o = w_r.any(-1), w_o.any(-1)
    agree = float((w_r == w_o).mean())
    check(agree > 0.995, f"{label}: slot agreement {agree}")
    m = w_r & w_o
    if m.any():
        a, b = ref[m], ours[m]
        tol = 1e-4 * np.abs(a) + 1e-5 * np.abs(a).max()
        check(bool((np.abs(a - b) <= tol).all()),
              f"{label}: agreeing slots differ beyond rtol 1e-4")
    return agree


@contextlib.contextmanager
def recording_fused():
    """Stands in for the fused, gather, shading, culled-query and
    scatter-add wrappers inside the tracer: forwards each call to the
    wrapper (which counts the launch) and keeps its inputs and the kernel's
    outputs, ``{name: [(args, out), ...]}`` (the scatter-add's as ``((idx,
    g, T), out)``: its ``out`` is the table it added into; the culled
    query's as ``((o, d, tris, kw), (t, idx))``)."""
    calls = {name: [] for name in _MODULES}

    def recorder(name):
        def call(*args, **kw):
            out = KERNELS[name](*args, **kw)
            if name == "nearest_hit_culled":
                kw = {k: v for k, v in kw.items() if k != "chunk_size"}
                calls[name].append((args + (kw,), out))
            else:
                calls[name].append((args, out))
            return out
        return call

    for name, mod in _MODULES.items():
        setattr(mod, name, recorder(name))
    try:
        yield calls
    finally:
        for name, mod in _MODULES.items():
            setattr(mod, name, KERNELS[name])


def material_grads(mats, d_eta_tab, freq_ghz):
    """The material parameters' gradients from a cotangent of the
    per-material eta table, through precompute_eta (autograd)."""
    eta = precompute_eta(mats, freq_ghz)
    tab = torch.stack([getattr(eta, f) for f in ETA_FIELDS], dim=-1)
    params = [getattr(mats, f) for f in MATERIAL_FIELDS]
    gs = torch.autograd.grad(tab, params, grad_outputs=d_eta_tab.float(),
                             allow_unused=True)
    return {f: torch.zeros_like(p) if g is None else g
            for f, p, g in zip(MATERIAL_FIELDS, params, gs)}


def grads_of(mats):
    """The material table's accumulated gradients, zeros where none."""
    return {f: (torch.zeros_like(getattr(mats, f)) if getattr(mats, f).grad
                is None else getattr(mats, f).grad.clone())
            for f in MATERIAL_FIELDS}


def _as_rows(x, vector):
    """Rays on the last axis: ``[..., R, 3]`` vectors become ``[..., 3, R]``."""
    return x.movedim(-1, -2) if vector else x


def hold_pre(spec, args, k, label):
    """The pre kernel's outputs ``k`` against its plain version on ``args``:
    decisions equal, values within :data:`ROW_RTOL`.  Returns the max abs
    error and the ulp gaps per output (per row for ``st2``)."""
    p = bounce_pre_plain(spec, *args)
    for f in ("crossing", "excl", "live", "mat"):
        check(torch.equal(getattr(k, f), getattr(p, f)),
              f"{label}: decision {f} differs")
    vectors = ("o2", "d2", "sh_o", "sh_d")
    fields = vectors + ("d2rx", "t_self", "ex", "res", "st2")
    groups = {f: VEC_GROUPS for f in vectors}
    groups["st2"] = AMP_GROUPS
    ulps = {f: ulp_gap(getattr(k, f), getattr(p, f)) for f in fields}
    ulps["st2"] = [ulp_gap(k.st2[j], p.st2[j]) for j in range(k.st2.shape[0])]
    err = max(rows_close(_as_rows(getattr(k, f), f in vectors),
                         _as_rows(getattr(p, f), f in vectors), ROW_RTOL,
                         f"{label}: {f}", groups.get(f)) for f in fields)
    return err, ulps


def hold_post(spec, args, k, label):
    """The post kernel's outputs ``k`` against its plain version on
    ``args``.  Returns the max abs error and the ulp gaps per row of
    ``out`` and ``res`` (over every RX)."""
    p = bounce_post_plain(spec, *args)
    check(torch.equal(k.write, p.write), f"{label}: decision write differs")
    err = max(rows_close(k.out, p.out, ROW_RTOL, f"{label}: out",
                         AMP_GROUPS),
              rows_close(k.res, p.res, ROW_RTOL, f"{label}: res"))
    return err, {f: [ulp_gap(getattr(k, f)[:, j], getattr(p, f)[:, j])
                     for j in range(6)] for f in ("out", "res")}


def hold_bwd(spec, args, k, mats, freq_ghz, label):
    """The backward kernel's ``(d_st0, d_eta_tab)`` against the plain
    version in float64 (and, for the record, in float32) on the same inputs.
    Returns the table's max abs error, the gradients' largest error as a
    share of their leaf's max, and the float32 plain version's max abs
    error."""
    eta_tab, st_all, live_all, mat_all, res_pre, res_post, d_out = args
    up = lambda x: x.double()  # noqa: E731
    d_st0_p, d_tab_p = loop_bwd_slim_plain(
        spec, up(eta_tab), up(st_all), live_all, mat_all, up(res_pre),
        up(res_post), up(d_out))
    d_st0_k, d_tab_k = k
    rows_close(d_st0_k, d_st0_p, ROW_RTOL, f"{label}: d_st0", AMP_GROUPS)
    share = leaves_close(material_grads(mats, d_tab_k, freq_ghz),
                         material_grads(mats, d_tab_p, freq_ghz), LEAF_RTOL,
                         LEAF_ATOL, f"{label}: material gradients")
    _, d_tab_p32 = loop_bwd_slim_plain(spec, *args)
    return (float((d_tab_k.double() - d_tab_p).abs().max()), share,
            float((d_tab_p32.double() - d_tab_p).abs().max()))


_PAY_GROUPS = tuple((c, c + 1, c + 2) for c in range(0, GEOM_COLS, 3))
# Rays that f32 arithmetic cannot reach: where the f32 plain version
# differs from the float64 one beyond the tier.  Either the float64
# recompute took another branch at a branch's edge (fsl2 = 1 in the
# free-space scale, |n.d| at the incidence clamp) and so another branch's
# derivative, or the cotangent is a small difference of large terms (a
# grazing hit's 1/det^2 makes a vertex cotangent of ~1e-4 out of terms ~1,
# which any f32 evaluation misses by its own size).  On those rays the kernel
# must be as close to the f32 plain version as that is to the float64 one;
# they are counted, and at most this share of the rays.
FAR_RAY_SHARE = 1e-4


def _up(args):
    return [x.double() if isinstance(x, torch.Tensor) and x.is_floating_point()
            else x for x in args]


def _hold_rows(fields, k, p64, p32, label):
    """The kernel's per-ray outputs ``k`` against the plain version's in
    float64 (``p64``) and f32 (``p32``); ``fields`` lists ``(name, index,
    vector, groups)`` of the outputs that are per-ray rows and ``("sum",
    name, index, terms_index)`` of the sums across rays.  Within
    :data:`ROW_RTOL` plus :data:`LEAF_ATOL` of the float64 rows (some
    cotangents are zero but for rounding: the scattering normalisation
    cancels the directivity ``s exp(-s1_alpha |theta_s - theta_i|)``, so the
    incidence angle's and ``s``'s cotangents are noise ~1e-23, and compare
    at that floor); the sums within :data:`SUM_RTOL`; on the rays f32 cannot
    reach (:data:`FAR_RAY_SHARE`) within the f32 plain version's own distance
    from float64.  Returns the max abs error, the ulp gaps by output and the
    number of rays f32 cannot reach."""
    rows = [f for f in fields if f[0] != "sum"]
    R = k[rows[0][1]].shape[0 if rows[0][2] else -1]
    far = torch.zeros(R, dtype=torch.bool, device=k[rows[0][1]].device)
    for name, i, vector, groups in rows:
        _, bad = _beyond(_as_rows(p32[i], vector), _as_rows(p64[i], vector),
                         ROW_RTOL, groups, LEAF_ATOL)
        far |= bad.reshape(-1, R).any(0)
    n_far = int(far.sum())
    check(n_far <= FAR_RAY_SHARE * R, f"{label}: f32 misses the float64 "
          f"value on {n_far} of {R} rays")
    err, ulps = 0.0, {}
    for name, i, vector, groups in rows:
        kr, q64, q32 = (_as_rows(x[i], vector).detach().double()
                        for x in (k, p64, p32))
        e, bad = _beyond(kr, q64, ROW_RTOL, groups, LEAF_ATOL)
        # the rays f32 cannot reach: within the tier of the f32 plain
        # version, or as close to it as it is to float64
        _, bad32 = _beyond(kr, q32, ROW_RTOL, groups, LEAF_ATOL)
        bad = torch.where(far, bad32 & ((kr - q32).abs()
                                        > (q32 - q64).abs() + LEAF_ATOL), bad)
        if bool(bad.any()):
            rows_close(kr[..., ~far], q64[..., ~far], ROW_RTOL,
                       f"{label}: {name}", atol=LEAF_ATOL)
            check(False, f"{label}: {name}: {int(bad.sum())} values on rays "
                  "f32 cannot reach further from the f32 plain version than "
                  "it is from float64")
        err = max(err, float(e[..., ~far].max()) if (~far).any() else 0.0)
        ulps[name] = ulp_gap(kr.float(), q64.float())
    for _, name, i, ti in (f for f in fields if f[0] == "sum"):
        t64, t32 = p64[ti].detach().double(), p32[ti].detach().double()
        # a ray f32 cannot reach may move the sum by its f32 plain term's
        # distance from float64
        slack = ((t32 - t64).abs() * far).sum(-1)
        err_s = (k[i].detach().double() - t64.sum(-1)).abs()
        check(bool((err_s <= SUM_RTOL * t64.abs().sum(-1) + slack
                    + 1e-30).all()),
              f"{label}: {name} beyond {SUM_RTOL} of the sum of its terms' "
              f"magnitudes (err {err_s.max().item()})")
        err = max(err, float(err_s.max()))
    return err, ulps, n_far


def hold_pre_bwd(spec, args, k, label):
    """The full pre backward's outputs ``k`` against its plain version in
    float64 on ``args`` (``_hold_rows``).  Returns the max abs error, the
    ulp gaps and the rays that took another branch in float64."""
    p64 = bounce_pre_bwd_plain(spec, *_up(args), sum_rays=False)
    p32 = bounce_pre_bwd_plain(spec, *args, sum_rays=False)
    groups = _PAY_GROUPS if k[3].shape[-1] == TABLE_COLS else None
    k, p64, p32 = ([x[0], x[1], x[2], x[3].T, x[4], x[5],
                    x[4].movedim(1, -1) if x[4].dim() == 3 else None]
                   for x in (k, p64, p32))
    return _hold_rows([("d_o", 0, True, VEC_GROUPS),
                       ("d_d", 1, True, VEC_GROUPS),
                       ("d_st", 2, False, AMP_GROUPS),
                       ("d_payload", 3, False, groups),
                       ("sum", "d_rxp", 4, 6), ("sum", "d_sc", 5, 5)],
                      k, p64, p32, label)


def hold_post_bwd(spec, args, k, label):
    """The full post backward's outputs ``k`` against its plain version in
    float64 on ``args``: the occluder rows equal, the rest as
    :func:`hold_pre_bwd`."""
    p64 = bounce_post_bwd_plain(spec, *_up(args), sum_rays=False)
    p32 = bounce_post_bwd_plain(spec, *args, sum_rays=False)
    check((k[7] is None) == (p64[7] is None), f"{label}: occluder rows")
    fields = [("d_d2", 0, True, VEC_GROUPS), ("d_st2", 1, False, AMP_GROUPS),
              ("d_ex", 2, False, None), ("d_sh_d", 3, True, VEC_GROUPS),
              ("d_d2rx", 4, False, None), ("d_payload", 5, False,
                                           _PAY_GROUPS if k[5].shape[-1]
                                           == TABLE_COLS else None),
              ("sum", "d_sc", 8, 8)]
    if p64[7] is not None:
        check(torch.equal(k[7], p64[7]), f"{label}: occluder rows differ")
        fields.append(("d_n_o", 6, True, VEC_GROUPS))
    k, p64, p32 = ([*x[:5], x[5].T, *x[6:]]
                   for x in (k, p64, p32))
    return _hold_rows(fields, k, p64, p32, label)


def hold_pre_bwd_slim(spec, args, k, label):
    """The slim pre backward's ``(d_st, d_eta)`` against its plain version
    in float64 (``_hold_rows``)."""
    p64 = bounce_pre_bwd_slim_plain(spec, *_up(args))
    p32 = bounce_pre_bwd_slim_plain(spec, *args)
    k, p64, p32 = ([x[0], x[1].T] for x in (k, p64, p32))
    return _hold_rows([("d_st", 0, False, AMP_GROUPS),
                       ("d_eta", 1, False, None)], k, p64, p32, label)


def hold_post_bwd_slim(spec, args, k, label):
    """The slim post backward's ``(d_st2, d_ss)`` against its plain version
    in float64 (``_hold_rows``)."""
    p64 = bounce_post_bwd_slim_plain(spec, *_up(args))
    p32 = bounce_post_bwd_slim_plain(spec, *args)
    k, p64, p32 = ([x[0], x[1].T] for x in (k, p64, p32))
    return _hold_rows([("d_st2", 0, False, AMP_GROUPS),
                       ("d_ss", 1, False, None)], k, p64, p32, label)


def hold_scatter_add(idx, g, T, label):
    """The scatter-add of ``g`` at ``idx`` into ``T`` rows, run twice on
    the card, against its plain version in float64: the same bits twice,
    each table entry within :data:`SUM_RTOL` of the sum of its terms'
    magnitudes; on the dense route also the bits of
    :func:`~.ops.fetch.scatter_add_ordered_plain` (the same adds in the
    same grouping).  Returns the max abs error and the rows summed."""
    k = KERNELS["scatter_add"](idx, g, T)
    again = KERNELS["scatter_add"](idx, g, T)
    check(torch.equal(k, again), f"{label}: two runs differ")
    if KERNELS["scatter_add"].route(T, g.shape[1], g.device) == "dense":
        ordered = scatter_add_ordered_plain(idx, g, T)
        check(torch.equal(k, ordered), f"{label}: dense route differs from "
              f"scatter_add_ordered_plain ({int((k != ordered).sum())} "
              f"values)")
    p = scatter_add_plain(idx, g.double(), T)
    scale = scatter_add_plain(idx, g.double().abs(), T)
    err = (k.double() - p).abs()
    check(bool((err <= SUM_RTOL * scale + 1e-30).all()),
          f"{label}: {int((err > SUM_RTOL * scale + 1e-30).sum())} sums "
          f"beyond {SUM_RTOL} of their terms' magnitudes")
    return float(err.max()) if err.numel() else 0.0, int(
        ((idx >= 0) & (idx < T)).sum())


def hold_gather(args, out, label):
    """The row gather's output ``out`` against its plain version on its
    arguments ``args`` ``(table, idx[, col, width])``: the same bits (an
    exact copy)."""
    p = gather_plain(*args)
    check(torch.equal(out, p), f"{label}: gather differs from table[idx] "
          f"({int((out != p).sum())} values)")


def hold_shade(args, k, label):
    """The shading kernel's ``(o2, d2, st2, ex)`` against its plain version
    on ``args = (o, d, st, live, row, sc)``: a dead ray keeps its inputs bit
    for bit (the live-dependent selects), every value within
    :data:`ROW_RTOL` of its row's (or row group's) largest magnitude.
    Returns the max abs error and the ulp gaps per output row."""
    p = shade_a_plain(*args)
    o, d, st, live = args[:4]
    dead = ~live
    check(torch.equal(k[0][dead], o[dead]) and torch.equal(k[1][dead], d[dead])
          and torch.equal(k[2][:4, dead], st[:4, dead])
          and torch.equal(k[2][4:, dead], p[2][4:, dead]),
          f"{label}: a dead ray's state differs")
    err = max(rows_close(k[0].T, p[0].T, ROW_RTOL, f"{label}: o2",
                         VEC_GROUPS),
              rows_close(k[1].T, p[1].T, ROW_RTOL, f"{label}: d2",
                         VEC_GROUPS),
              rows_close(k[2], p[2], ROW_RTOL, f"{label}: st2", AMP_GROUPS),
              rows_close(k[3], p[3], ROW_RTOL, f"{label}: ex"))
    ulps = {"o2": ulp_gap(k[0], p[0]), "d2": ulp_gap(k[1], p[1]),
            "st2": [ulp_gap(k[2][j], p[2][j]) for j in range(6)],
            "ex": [ulp_gap(k[3][j], p[3][j]) for j in range(5)]}
    return err, ulps


def hold_culled(o, d, tris, kw, t, idx, skipped, label):
    """The culled query's answer ``(t, idx)`` and its count of skipped
    (block, tile) pairs against :func:`culled_reach_plain` on the same
    query: the same bits, the same count.  Returns the plain version's reach
    ``bool[blocks, tiles]``."""
    lim = query_limits(o.shape[0], CULL_BLOCK_RAYS, t_max=kw.get("t_max"),
                       live=kw.get("live"), device=o.device)
    reach, t_p, i_p = culled_reach_plain(o, d, tris, lim,
                                         exclude=kw.get("exclude"))
    flips = int((i_p != idx).sum())
    check(flips == 0 and torch.equal(t_p, t),
          f"{label}: {flips} flips against the plain culled scan")
    n_skip = int((~reach).sum())
    check(n_skip == skipped, f"{label}: {skipped} tiles skipped, the plain "
          f"version skips {n_skip}")
    return reach


def grad_loss(res):
    """``tests/test_bounce_fused.py``'s gradient loss: (sum |a_te|^2 +
    |a_tm|^2) 1e9 + sum tau 1e3 + sum freq_shift 1e-3 over the scatter
    paths."""
    sc = res.scatter
    return ((sc.a_te.abs().square().sum() + sc.a_tm.abs().square().sum())
            * 1e9 + sc.tau.sum() * 1e3 + sc.freq_shift.sum() * 1e-3)


def material_table(n, rng, device):
    """An ``n``-row material table: the 17 ITU rows repeated, with s and
    s1_alpha drawn from ``rng`` so that the rows differ."""
    base = default_materials("cpu")
    cols = {f: np.resize(getattr(base, f).detach().numpy(), n)
            for f in MATERIAL_FIELDS}
    cols["s"] = rng.uniform(0.1, 0.6, n).astype(np.float32)
    cols["s1_alpha"] = rng.uniform(1.0, 4.0, n).astype(np.float32)
    return MaterialTable(cols, device=device)


def calibration_launches(cfg, nrx):
    """The launches of one :func:`calibration_step` of ``cfg`` at ``nrx``
    receivers (the bench flags, one TX, one material table, loss of the
    scatter gains only): one nearest-hit query for the LoS, one a bounce
    for the bounce rays and one a bounce per group of RX rows of its shadow
    rays (``tracer.rx_rows_per_query``); on the ``"fused_slim"`` route the
    two fused stages a bounce, the whole-loop material backward once and
    the gather of the payload table's eta rows; on the op path that
    gather, a bounce's payload rows and hit normals, one gather each, and
    each but the normals' summed back by one scatter-add.  The route is
    the one ``tracer.plan_bounce_loop`` gives a step on the card that asks
    for a gradient; any other raises ValueError."""
    B = cfg.num_bounces
    groups = nrx // tracer_module.rx_rows_per_query(nrx, cfg.num_paths,
                                                    cfg.rx_query_rays)
    out = {**{n: 0 for n in KERNELS}, "nearest_hit": 1 + B * (1 + groups)}
    route = tracer_module.plan_bounce_loop(
        cfg, grad=True, device="cuda", tri_sharded=False,
        rays=cfg.num_paths, nrx=nrx, n_materials=1).route
    if route == "fused_slim":
        out.update(bounce_pre=B, bounce_post=B, loop_bwd_slim=1, gather=1)
    elif route == "op":
        out.update(gather=1 + 2 * B, scatter_add=1 + B)
    else:
        raise ValueError(f"no launch count for the {route!r} route")
    return out


# the transmission modes as TracerConfig flags
TRANSMISSION_MODES = {
    "transmission": dict(transmission=True),
    "spawn_straight": dict(spawn_transmission=True),
    "spawn_snell": dict(spawn_transmission=True, refraction="snell")}


def transmission_config(paths, bounces, mode, **kw):
    """The calibration flags of :func:`calibration_config` (op path) under
    physical parity with the transmission mode ``mode`` (a key of
    :data:`TRANSMISSION_MODES`)."""
    return calibration_config(paths, bounces, False,
                              **{"parity": "physical",
                                 **TRANSMISSION_MODES[mode], **kw})


def transmission_launches(cfg, walk=False):
    """The launches of one :func:`calibration_step` of ``cfg`` (physical
    parity, op path, loss of the scatter gains only) on a scene of one
    material table: one query for the LoS and two a bounce (the walk's
    prepass and walk each, or the culled or the brute scan); the payload
    table's eta rows, the LoS blocker's row under ``transmission``, and a
    bounce's payload rows and (``transmission``) its shadow blockers' rows,
    one gather each, each but the LoS's summed back by one scatter-add; a
    shading node a bounce with ``shade="pallas"`` unless rays spawn."""
    B = cfg.num_bounces
    queries = 1 + 2 * B
    per_bounce = 1 + cfg.transmission
    out = {**{n: 0 for n in KERNELS}, "walk_prepass": 0, "walk": 0,
           "gather": 1 + cfg.transmission + B * per_bounce,
           "scatter_add": 1 + B * per_bounce,
           "shade_a": (B if cfg.shade == "pallas"
                       and not cfg.spawn_transmission else 0)}
    if walk:
        out.update(walk_prepass=queries, walk=queries)
    else:
        out["nearest_hit_culled" if cfg.cull else "nearest_hit"] = queries
    return out
