"""Checks of the port's kernels against their plain versions.

Shared by ``chip_smoke.py`` (on the card) and the tests
(``tests/test_torch_fused.py`` on the CPU against the JAX package,
``tests/test_torch_cuda.py`` on the card): the tolerances with their
reasons, the comparisons, a recorder of the fused kernels' calls inside the
tracer, and the material-calibration step of the JAX package's
``bench.py``.  Imports no JAX.
"""
from __future__ import annotations

import contextlib
import warnings

import numpy as np
import torch

from .api import trace
from .config import TracerConfig
from .materials import MATERIAL_FIELDS, MaterialTable, default_materials
from .ops import bounce_fused_cuda as fused_ops
from .ops.bounce_fused import (bounce_post_plain, bounce_pre_plain,
                               loop_bwd_slim_plain)
from .ops.fresnel import ETA_FIELDS, precompute_eta
from .ops.intersect_cuda import nearest_hit

__all__ = ["ROW_RTOL", "LEAF_RTOL", "LEAF_ATOL", "PATH_GRAD_RTOL",
           "AMP_GROUPS", "VEC_GROUPS", "FUSED", "KERNELS", "PLAIN",
           "OUTPUT_FIELDS",
           "CheckFailure", "check", "ulp_gap", "rows_close", "leaves_close",
           "slots_agree", "recording_fused", "material_grads", "grads_of",
           "hold_pre", "hold_post", "hold_bwd", "material_table",
           "calibration_config", "calibration_step"]

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

FUSED = ("bounce_pre", "bounce_post", "loop_bwd_slim")
KERNELS = {"nearest_hit": nearest_hit,
           **{name: getattr(fused_ops, name) for name in FUSED}}
PLAIN = {"bounce_pre": bounce_pre_plain, "bounce_post": bounce_post_plain,
         "loop_bwd_slim": loop_bwd_slim_plain}
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


def rows_close(k, p, rtol, label, groups=None):
    """|k - p| within ``rtol`` of the largest |p| of its row (rays on the
    last axis), or of its group of rows: a complex value's (re, im) pair, a
    vector's three components, whose small parts come from cancellation of
    the large ones.  Returns the max abs error."""
    k2, p2 = k.double(), p.double()
    scale = p2.abs().amax(dim=-1, keepdim=True)
    for g in groups or ():
        scale[..., list(g), :] = scale[..., list(g), :].amax(dim=-2,
                                                             keepdim=True)
    err = (k2 - p2).abs()
    check(bool((err <= rtol * scale).all()),
          f"{label}: {int((err > rtol * scale).sum())} values beyond "
          f"{rtol} of their row's max")
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
    """Stands in for the three fused wrappers inside the tracer: forwards each
    call to the wrapper (which counts the launch) and keeps its inputs and the
    kernel's outputs, ``{name: [(args, out), ...]}``."""
    calls = {name: [] for name in FUSED}

    def recorder(name):
        def call(*args):
            out = KERNELS[name](*args)
            calls[name].append((args, out))
            return out
        return call

    for name in FUSED:
        setattr(fused_ops, name, recorder(name))
    try:
        yield calls
    finally:
        for name in FUSED:
            setattr(fused_ops, name, KERNELS[name])


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


def material_table(n, rng, device):
    """An ``n``-row material table: the 17 ITU rows repeated, with s and
    s1_alpha drawn from ``rng`` so that the rows differ."""
    base = default_materials("cpu")
    cols = {f: np.resize(getattr(base, f).detach().numpy(), n)
            for f in MATERIAL_FIELDS}
    cols["s"] = rng.uniform(0.1, 0.6, n).astype(np.float32)
    cols["s1_alpha"] = rng.uniform(1.0, 4.0, n).astype(np.float32)
    return MaterialTable(cols, device=device)


def calibration_config(paths, bounces, fused, **kw):
    """``bench.py``'s material-calibration flags on the port: reference
    parity, compact and coherent rays, no rays kept, no geometry gradient;
    with ``fused`` the fused path (``shade="fused", grad_positions=False``),
    else the op path."""
    base = dict(num_paths=paths, num_bounces=bounces, parity="reference",
                compact_rays=True, launch_order="coherent", keep_rays=False,
                grad_geometry=False)
    if fused:
        base.update(shade="fused", grad_positions=False)
    with warnings.catch_warnings():   # coherent order under reference parity
        warnings.simplefilter("ignore")
        return TracerConfig(**{**base, **kw})


def calibration_step(tris, rx, tx, freq_ghz, mats, cfg, backward=True):
    """One step: trace, loss (sum |a_te|^2 + |a_tm|^2) 1e9 as ``bench.py``,
    backward to the material table, on the device that holds the prepared
    scene ``tris``.  Returns ``(result, loss)``."""
    mats.zero_grad(set_to_none=True)
    with torch.set_grad_enabled(backward):
        res = trace(tris, rx, tx, carrier_frequency=freq_ghz, config=cfg,
                    materials=mats)
        loss = (res.scatter.a_te.abs().square().sum()
                + res.scatter.a_tm.abs().square().sum()) * 1e9
        if backward:
            loss.backward()
    if torch.device(tris.device).type == "cuda":
        torch.cuda.synchronize()
    return res, loss
