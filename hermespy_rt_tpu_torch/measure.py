"""The yardstick of the port's kernels on an NVIDIA H100, shared by
``chip_smoke.py`` and ``scripts/profile_op_steps.py``: the card's peak
rates, the f32 operations the kernels do, the bytes and operations of a
call on its data, the bound they give, the registers and spills of a
build, and the profiler window that times device operations.

A kernel's bound is the larger of its bytes (each input read once, each
output written once) over the device memory rate and its f32 operations
over the f32 rate, counting what the call's data needs.

Stands alone: ``profile_op_steps.py`` loads this file from its own checkout
whichever tree it measures, so it imports nothing else of the package.
"""
from __future__ import annotations

import re
import time
from typing import NamedTuple

# H100 SXM peaks (NVIDIA's data sheet, dense, at 700 W): device memory rate
# and f32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# f32 operations counted in the kernels' sources (mul, add, sub, div, sqrt,
# min, max, compare and each libm call as one): nearest hit per (live ray,
# triangle) pair (csrc/intersect.cu: 46 mul/add/sub and one division); the
# pre stage per ray plus per (ray, RX); the post stage per (ray, RX); the
# backward per live ray and bounce (pre vjp) plus per written (ray, RX) and
# bounce (post vjp) (csrc/bounce_fused.cu), each rounded up
NEAREST_HIT_OPS_PER_PAIR = 47
PRE_OPS_PER_RAY, PRE_OPS_PER_RX = 180, 30
POST_OPS_PER_RX = 150
BWD_PRE_OPS, BWD_POST_OPS = 120, 100
# the per-stage backwards (csrc/bounce_bwd.cu), each the forward it
# recomputes plus its vjp: the full pre per ray (forward, Fresnel vjp,
# geometry vjp) plus per (ray, RX) (shadow set-up and its vjp); the full post
# per (ray, RX) (forward, Doppler, scattering and amplitude vjps); the slim
# ones as the whole-loop backward's per-bounce parts (BWD_PRE_OPS per live
# ray, BWD_POST_OPS per written (ray, RX))
PRE_BWD_OPS_PER_RAY, PRE_BWD_OPS_PER_RX = 460, 60
POST_BWD_OPS_PER_RX = 360
# csrc/slab.cuh and csrc/walk.cu: one slab test of a ray against a box (3
# axes of 2 sub, 2 mul, min, max; the 4 min/max joining them; 4 compares);
# the prepass's per (live ray, box) pair: the slab test and its key (max
# with 0, min); its prune per (ray tile with a live ray, box)
# (walk.cu::box_pruned): per axis and face 2 sub, 4 mul, 3 min, 3 max, per
# axis the faces' min and max, the axes' 4 min/max and 3 compares
SLAB_OPS = 26
PREPASS_OPS_PER_PAIR = SLAB_OPS + 2
PRUNE_OPS_PER_BOX = 3 * (2 * (2 + 4 + 3 + 3) + 2) + 4 + 3


def nbytes(*xs) -> int:
    """Bytes of the tensors among ``xs``, each counted once."""
    return sum(x.numel() * x.element_size() for x in xs
               if hasattr(x, "element_size"))


def bound(n_bytes, n_ops):
    """(least time in ms on an H100 SXM, "bytes" or "operations")."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def prepass_bounds(n_bytes, live_per_tile, n_boxes, kept=None):
    """The walk prepass's bounds on one query: ``n_bytes`` its rays, limits
    and boxes read once and its visit rows written once;
    ``live_per_tile`` the live rays of each ray tile (a tensor); ``kept``
    ``bool[nRT, C]``, the boxes each ray tile keeps for exact tests
    (``ops/walk.py::prepass_kept_plain``), or None.

    ``kept``: over the work the kernel does, 28 operations a (live ray,
    kept box) pair and the prune's a (ray tile with a live ray, box) — the
    prepass's bound (with ``kept_pairs``); ``all_pairs`` and
    ``all_pairs_half_rate``: over every (live ray, box) pair at the f32
    rate and at half of it, which operations without FMA reach."""
    n_live = int(live_per_tile.sum())
    live_tiles = int((live_per_tile > 0).sum())
    all_ops = PREPASS_OPS_PER_PAIR * n_live * n_boxes
    out = dict(pairs=n_live * n_boxes, live_tiles=live_tiles,
               all_pairs=bound(n_bytes, all_ops),
               all_pairs_half_rate=bound(n_bytes, 2 * all_ops))
    if kept is not None:
        kept_pairs = int((live_per_tile[:, None] * kept).sum())
        out.update(kept_pairs=kept_pairs, kept=bound(
            n_bytes, PREPASS_OPS_PER_PAIR * kept_pairs
            + PRUNE_OPS_PER_BOX * live_tiles * n_boxes))
    return out


def bwd_work(name, spec, args, outs):
    """(bytes, f32 operations) that one call of backward kernel ``name``
    must move and do on this run's data: each input it needs read once
    (the payload table once), each output written once."""
    nrx = spec.nrx
    if name == "bounce_pre_bwd":
        R = args[0].shape[0]
        return (nbytes(*args, *outs),
                R * (PRE_BWD_OPS_PER_RAY + PRE_BWD_OPS_PER_RX * nrx))
    if name == "bounce_post_bwd":
        R = args[0].shape[0]
        ex = args[2]
        unused = 0 if spec.parity == "physical" else nbytes(ex[2])
        return (nbytes(*args, *(x for x in outs if x is not None)) - unused,
                R * nrx * POST_BWD_OPS_PER_RX)
    if name == "bounce_pre_bwd_slim":
        # every ray: act, idx, its state cotangent in and out, its eta rows
        # out; a live ray: state rows 0-3 and the residuals; the eta columns
        # of the table once
        st, act, idx, table, _, d_st2 = args
        n_live = int((act & (idx >= 0)).sum())
        return (nbytes(act, idx, d_st2, *outs) + n_live * (16 + 12)
                + table.shape[0] * 48, n_live * BWD_PRE_OPS)
    # bounce_post_bwd_slim: every ray its id, the freq cotangents and the
    # write scales per RX, its outputs; a written (ray, RX) the residual and
    # cotangent rows 0-4, a ray written anywhere its state rows 0-3; the
    # table's (s, s1_alpha) once
    st2, excl, table, res, d_out = args
    written = res[:, 5] > 0                                   # [nrx, R]
    n_write = int(written.sum())
    return (nbytes(excl, *outs) + 8 * excl.numel() * nrx + 40 * n_write
            + 16 * int(written.any(dim=0).sum()) + table.shape[0] * 8,
            n_write * BWD_POST_OPS)


def kernel_ptxas(build_log, name):
    """Registers, spills and shared memory of the kernel ``name`` from a
    build's ``-Xptxas -v`` lines (None when it has none)."""
    out, lines = None, build_log.splitlines()
    for i, ln in enumerate(lines):
        if "Compiling entry function" in ln and f"{name}E" in ln:
            out = {}
            for nxt in lines[i + 1:i + 5]:
                for key, pat in (("registers", r"Used (\d+) registers"),
                                 ("spill_stores", r"(\d+) bytes spill stores"),
                                 ("spill_loads", r"(\d+) bytes spill loads"),
                                 ("smem_bytes", r"(\d+) bytes smem")):
                    m = re.search(pat, nxt)
                    if m:
                        out[key] = int(m.group(1))
    return out


def event_ms(e) -> float:
    """A profiler row's own device time in ms."""
    us = getattr(e, "self_device_time_total", None)
    return (e.self_cuda_time_total if us is None else us) / 1e3


class Window(NamedTuple):
    device: list      # the profiler's device rows (key_averages)
    host: list        # ... and its host rows
    wall_ms: float    # host clock per call, the closing synchronise in
    missed: int       # launches the window did not record (see profiled)
    odd: list         # [key, count] of the rows that show them
    tries: int        # windows taken


TRIES = 3   # windows a measurement may take while they miss launches


def profiled(fn, reps, launches=None):
    """``reps`` calls of ``fn`` in one torch.profiler window, after one
    unprofiled warm-up call.  The window opens on a warm-up cycle of
    ``reps`` calls in which the profiler traces the device and drops the
    events, so that the recorded cycle starts with the device tracing up:
    a window opened cold can miss its first launches.  The schedule's own
    ``ProfilerStep`` rows (a span over the cycle, not a device operation)
    are left out.

    ``missed`` is the larger of two counts of what the recorded cycle
    lost: per device operation, the calls short of a whole multiple of
    ``reps`` (every call makes the same launches), or ``reps`` when it
    recorded no device row at all; and where ``launches`` (a callable
    giving each kernel wrapper's launch count by name) is given, per
    wrapper the launches it counted in the cycle beyond the device rows
    named ``<name>_kernel``.
    A window that missed any is taken again, up to :data:`TRIES` windows;
    the last one is returned."""
    for n in range(1, TRIES + 1):
        w = _window(fn, reps, launches)._replace(tries=n)
        if not w.missed:
            break
    return w


def _window(fn, reps, launches):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        prof.step()
        before = launches() if launches else {}
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
        after = launches() if launches else {}
    rows = [e for e in prof.key_averages()
            if not e.key.startswith("ProfilerStep")]
    dev = [e for e in rows if e.device_type == DeviceType.CUDA]
    odd = [[e.key[:60], e.count] for e in dev if e.count % reps]
    missed = sum(-e.count % reps for e in dev)
    if not dev:     # every call measured here runs on the device
        missed, odd = reps, [["no device rows", 0]]
    shorts = 0      # the same lost launches may show in both counts
    for name, n in after.items():
        recorded = sum(e.count for e in dev if f"{name}_kernel" in e.key)
        short = n - before.get(name, 0) - recorded
        if short > 0:
            shorts += short
            odd.append([f"{name}: {short} launches not recorded", recorded])
    missed = max(missed, shorts)
    return Window(dev, [e for e in rows if e.device_type != DeviceType.CUDA],
                  wall_ms, missed, odd, 1)
