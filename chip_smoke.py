#!/usr/bin/env python
"""Smoke run of the PyTorch port (``hermespy_rt_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero:

1. build    -- compile the kernel library (every ``hermespy_rt_tpu_torch/
               csrc/*.cu``) with one nvcc call.
2. kernel   -- the nearest-hit kernel against its plain torch twin on the
               card, on the street canyon (or its stand-in) and the box
               scene: 2^18 rays from the launch point and 2^18 from random
               origins, with exclude, scalar and per-ray t_max, and live
               masks.  Every hit decision that differs must be an f64
               edge/tie case (tests/utils.py::assert_flips_explained) and t
               must agree to rtol 2e-5 where the decision agrees.
3. trace    -- the op path (``shade="xla"``), forward only:
               ``compute_paths`` at 2^20 paths, 3 bounces, reference parity,
               nrx = 1 and 4, through the kernel: its launch count, finite
               outputs, a written scatter; at 2^16 paths the same trace with
               the plain twin must agree; forward queries/s of both.  Every
               kernel query of the two 2^20-path traces is recorded.
4. path     -- each recorded query re-run through the twin and held to the
               tier of phase 2; then the kernel's and the twin's time on the
               recorded nrx = 4 bounce and shadow queries.
5. profile  -- one torch.profiler window per nrx over a warm 2^20-path
               ``compute_paths`` (op path): device busy, device operations,
               host time.
6. grad     -- one op-path backward of sum |a_te|^2 + |a_tm|^2 to the
               material table.
7. train    -- this slice's main path, the material-calibration step of
               ``bench.py``: ``trace(shade="fused", grad_positions=False,
               grad_geometry=False)`` at 2^20 paths, B = 3, reference
               parity, compact and coherent rays, loss (sum |a_te|^2 +
               |a_tm|^2) 1e9, backward to the ``MaterialTable``, at nrx = 1
               and 4.  Launch counts are zeroed just before one step and
               read just after (nearest_hit 7, bounce_pre 3, bounce_post 3,
               loop_bwd_slim 1), and that step's kernel calls are recorded.
               Forward and forward+backward queries/s of the fused path and
               of the op path, in turns.  At 2^16 paths the fused gradients
               agree with the op path's and the scatter slots agree.
8. fused_kernel -- every recorded fused kernel call of the 2^20-path steps
               held against its plain version on the same inputs: equal
               decisions, geometric rows equal, values within their tier
               (ulp gaps per row); the backward on a 300-row material table,
               within its tier and twice to the same bits; then each
               kernel's and its plain version's device time (profiler) and
               time between CUDA events, and its bound (the bytes and
               operations this run's data needs).
9. profile_step -- one profiler window over one forward+backward step at
               nrx = 1, of the fused path and of the op path.

Then the kernel summary, the card's name and power limit, and the result
line.  Without a CUDA device it exits non-zero and prints no result.
"""
import contextlib
import importlib.util
import json
import os
import subprocess
import sys
import time
import types

import numpy as np
import torch

from hermespy_rt_tpu_torch import (TracerConfig, compute_paths,
                                   default_materials, trace)
from hermespy_rt_tpu_torch import tracer as tracer_module
from hermespy_rt_tpu_torch.materials import MATERIAL_FIELDS
from hermespy_rt_tpu_torch.ops import bounce_fused_cuda as fused_ops
from hermespy_rt_tpu_torch.ops._cuda_build import LIBRARY
from hermespy_rt_tpu_torch.ops.fresnel import ETA_FIELDS, precompute_eta
from hermespy_rt_tpu_torch.ops.geometry import fibonacci_sphere
from hermespy_rt_tpu_torch.ops.intersect import intersect_torch
from hermespy_rt_tpu_torch.ops.intersect_cuda import SOURCE, nearest_hit
from hermespy_rt_tpu_torch.scene import (box_scene, flatten_scene, load_hrt,
                                         random_soup_scene)
from hermespy_rt_tpu_torch.testing import (
    FUSED, KERNELS, LEAF_ATOL, OUTPUT_FIELDS, PATH_GRAD_RTOL, PLAIN, check,
    calibration_config, calibration_step, grads_of, hold_bwd, hold_post,
    hold_pre, leaves_close, material_table, recording_fused, slots_agree)

REPO = os.path.dirname(os.path.abspath(__file__))
CANYON = os.path.join(REPO, "scenes", "simple_street_canyon_with_cars.hrt")
TX = [[-20.0, -10.0, 10.0]]
FREQ_GHZ = 3.0
BOUNCES = 3
PATHS = 1 << 20          # main-path paths per trace
SMALL_PATHS = 1 << 16    # paths of the kernel-vs-twin trace and the backward
KERNEL_RAYS = 1 << 18    # rays per kernel-vs-twin query
TWIN_CHUNK = 1 << 15     # ray chunk of the plain twin on the card

# H100 SXM peaks (NVIDIA's data sheet, dense, at 700 W): device memory rate
# and f32 rate outside the tensor cores.  The bound of a kernel is the larger
# of its bytes (each input read once, each output written once) over the
# first and its f32 operations over the second.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# f32 operations counted in the kernels' sources (mul, add, sub, div, sqrt
# and each libm call as one): nearest hit per (live ray, triangle) pair
# (csrc/intersect.cu: 46 mul/add/sub and one division); the pre stage per
# ray plus per (ray, RX); the post stage per (ray, RX); the backward per live
# ray and bounce (pre vjp) plus per written (ray, RX) and bounce (post vjp)
# (csrc/bounce_fused.cu), each rounded up.
NEAREST_HIT_OPS_PER_PAIR = 47
PRE_OPS_PER_RAY, PRE_OPS_PER_RX = 180, 30
POST_OPS_PER_RX = 150
BWD_PRE_OPS, BWD_POST_OPS = 120, 100
# The tolerances of the kernels against their plain versions, with their
# reasons, are in hermespy_rt_tpu_torch/testing.py.
REPLACES = {"nearest_hit": "hermespy_rt_tpu/ops/intersect_pallas.py:369",
            "bounce_pre": "hermespy_rt_tpu/ops/bounce_fused.py:344",
            "bounce_post": "hermespy_rt_tpu/ops/bounce_fused.py:684",
            "loop_bwd_slim": "hermespy_rt_tpu/ops/bounce_fused.py:1170"}


def emit(**kw):
    print(json.dumps(kw), flush=True)


def rx_positions(nrx):
    k = np.arange(nrx, dtype=np.float32)[:, None]
    return (np.array([[10.0, 5.0, 2.0]], np.float32)
            + k * np.array([[1.5, -2.0, 0.25]], np.float32))


def smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def cuda_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` runs (after one warm-up)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_pair(run_k, run_p, reps_k=20, reps_p=3):
    """Kernel and plain times in ms, in turns: plain, kernel, kernel, plain.
    CUDA events around back-to-back calls: this includes any gap the host
    leaves between launches."""
    p1 = cuda_ms(run_p, reps_p)
    k1 = cuda_ms(run_k, reps_k)
    k2 = cuda_ms(run_k, reps_k)
    p2 = cuda_ms(run_p, reps_p)
    return (k1 + k2) / 2, (p1 + p2) / 2


def device_ms(fn, reps, kernel=None):
    """Device time in ms per call of ``fn``: the device events' own times
    (torch.profiler) over ``reps`` calls after one warm-up, only those of
    ``kernel`` when it is named.  Unlike :func:`time_pair` it leaves out the
    host's gaps between launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
          and (kernel is None or f"{kernel}_kernel" in e.key)]
    return sum(_device_ms(e) for e in ev) / reps


def flips_check():
    """tests/utils.py::assert_flips_explained, loaded by file path: an
    installed package named `tests` would shadow the repo's tests/ directory,
    which has no __init__.py."""
    spec = importlib.util.spec_from_file_location(
        "_smoke_test_utils", os.path.join(REPO, "tests", "utils.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.assert_flips_explained


def hold_against_twin(tris, o, d, kw, t_k, i_k, label):
    """Hold the kernel's answer ``(t_k, i_k)`` to query ``(o, d, **kw)``
    against the plain twin on the same inputs: every decision flip an f64
    edge/tie case, ``t`` within rtol 2e-5 where the decisions agree, dead
    rays missing and no ray hitting its excluded triangle.  Returns
    ``(flips, max_abs_err, hits)``."""
    t_p, i_p = intersect_torch(o, d, tris, chunk_size=TWIN_CHUNK, **kw)
    ns = types.SimpleNamespace(**{f: getattr(tris, f).cpu().numpy()
                                  for f in ("v0", "e1", "e2")})
    t_k, i_k, t_p, i_p = (x.cpu().numpy() for x in (t_k, i_k, t_p, i_p))
    flips = flips_check()(ns, o.cpu().numpy(), d.cpu().numpy(), t_p, i_p,
                          t_k, i_k, t_rtol=2e-5, label=label)
    m = (i_k == i_p) & (i_k >= 0)
    err = float(np.abs(t_k[m] - t_p[m]).max()) if m.any() else 0.0
    rel = (float((np.abs(t_k[m] - t_p[m]) / np.abs(t_p[m])).max())
           if m.any() else 0.0)
    check(rel <= 2e-5, f"{label}: t rel err {rel}")
    if kw.get("live") is not None:
        dead = ~kw["live"].cpu().numpy()
        check(bool((i_k[dead] == -1).all()), f"{label}: a dead ray hit")
    if kw.get("exclude") is not None:
        ex = kw["exclude"].cpu().numpy()
        check(not bool(((ex >= 0) & (i_k == ex)).any()),
              f"{label}: a ray hit its excluded triangle")
    return int(flips), err, int((i_k >= 0).sum())


class QueryRecorder:
    """Stands in for the kernel's wrapper inside the tracer for one trace:
    forwards every query to :data:`nearest_hit` (which counts the launch)
    and keeps the query's inputs and the kernel's answer."""

    def __init__(self):
        self.queries = []

    def __call__(self, o, d, tris, chunk_size=None, **kw):
        t, idx = nearest_hit(o, d, tris, **kw)
        self.queries.append((o, d, tris, kw, t, idx))
        return t, idx


@contextlib.contextmanager
def recording():
    rec = QueryRecorder()
    saved = tracer_module.nearest_hit
    tracer_module.nearest_hit = rec
    try:
        yield rec
    finally:
        tracer_module.nearest_hit = saved


def phase_build():
    t0 = time.perf_counter()
    lib = LIBRARY.build()
    secs = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in LIBRARY.build_log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    emit(phase="build", ok=True, seconds=secs, nvcc_seconds=LIBRARY.build_seconds,
         library=os.path.relpath(str(lib), REPO),
         sources=[os.path.relpath(str(x), REPO) for x in LIBRARY.sources],
         ptxas=ptxas, gpu=smi())


def phase_kernel(scenes, dev):
    rng = np.random.default_rng(0)
    R = KERNEL_RAYS
    worst = 0.0
    total_flips = 0
    for name, (host, launch) in scenes.items():
        tris = flatten_scene(host, device=dev)
        T = tris.pad_triangles
        v0 = tris.v0[:tris.num_triangles].cpu().numpy()
        lo, hi = v0.min(0), v0.max(0)
        ray_sets = {
            "launch": (np.broadcast_to(np.asarray(launch, np.float32),
                                       (R, 3)).copy(), fibonacci_sphere(R)),
            "random": (rng.uniform(lo, hi, (R, 3)).astype(np.float32),
                       None),
        }
        for rays, (o, d) in ray_sets.items():
            if d is None:
                d = rng.normal(size=(R, 3)).astype(np.float32)
                d /= np.linalg.norm(d, axis=-1, keepdims=True)
            o_t = torch.as_tensor(o, device=dev)
            d_t = torch.as_tensor(d, device=dev)
            opts = {
                "plain": {},
                "exclude": dict(exclude=torch.as_tensor(
                    rng.integers(-1, T, R).astype(np.int32), device=dev)),
                "t_max": dict(t_max=20.0),
                "t_max_rays": dict(t_max=torch.as_tensor(
                    rng.uniform(0, 100, R).astype(np.float32), device=dev)),
                "live": dict(live=torch.as_tensor(rng.uniform(size=R) < 0.5,
                                                  device=dev)),
            }
            opts["all"] = {**opts["exclude"], **opts["t_max_rays"],
                           **opts["live"]}
            for opt, kw in opts.items():
                t_k, i_k = nearest_hit(o_t, d_t, tris, **kw)
                torch.cuda.synchronize()
                flips, err, hits = hold_against_twin(
                    tris, o_t, d_t, kw, t_k, i_k, f"{name}/{rays}/{opt}")
                worst = max(worst, err)
                total_flips += flips
                emit(phase="kernel", scene=name, rays=rays, option=opt, R=R,
                     T=T, hits=hits, flips=flips, max_abs_err=err)
    return worst, total_flips


def run_paths(host, nrx, dev, backend, paths, **kw):
    """The main path: ``compute_paths`` as bench.py drives it."""
    los, sc = compute_paths(host, rx_positions(nrx), TX, np.zeros((nrx, 3)),
                            np.zeros((1, 3)), FREQ_GHZ, nrx, 1, paths,
                            BOUNCES, device=dev, parity="reference",
                            backend=backend, keep_rays=False,
                            compact_rays=True, **kw)
    torch.cuda.synchronize()
    return los, sc


def phase_trace(host, scene_name, dev):
    """Returns the kernel launches of the two checked 2^20-path traces and
    the kernel queries they made, by nrx."""
    launches = 0
    recorded = {}
    for nrx in (1, 4):
        P = PATHS
        with recording() as rec:
            nearest_hit.launches = 0
            los, sc = run_paths(host, nrx, dev, "cuda", P)
            n_launch = nearest_hit.launches
        recorded[nrx] = rec.queries
        launches += n_launch
        check(n_launch >= 1 + 2 * BOUNCES,
              f"nrx={nrx}: {n_launch} kernel launches < {1 + 2 * BOUNCES}")
        check(len(rec.queries) == n_launch,
              f"nrx={nrx}: {len(rec.queries)} queries, {n_launch} launches")
        for f in OUTPUT_FIELDS:
            for part, info in (("los", los), ("scatter", sc)):
                x = getattr(info, f)
                x = torch.view_as_real(x) if x.is_complex() else x
                check(bool(torch.isfinite(x).all()),
                      f"nrx={nrx}: {part}.{f} has non-finite values")
        nonzero = int((sc.a_te.abs() > 0).sum())
        check(nonzero > 0, f"nrx={nrx}: empty scatter")
        check(tuple(sc.a_te.shape) == (nrx, 1, BOUNCES * P),
              f"nrx={nrx}: scatter shape {tuple(sc.a_te.shape)}")

        # the same trace through the plain twin, at 2^16 paths
        _, sc_k = run_paths(host, nrx, dev, "cuda", SMALL_PATHS)
        _, sc_p = run_paths(host, nrx, dev, "torch", SMALL_PATHS,
                            ray_chunk=TWIN_CHUNK)
        agree = {f: slots_agree(getattr(sc_p, f), getattr(sc_k, f), f)
                 for f in OUTPUT_FIELDS}

        queries = BOUNCES * P * (1 + nrx)
        times = {}
        for backend, kw in (("cuda", {}), ("torch",
                                           dict(ray_chunk=TWIN_CHUNK))):
            run_paths(host, nrx, dev, backend, P, **kw)        # warm-up
            t0 = time.perf_counter()
            for _ in range(3):
                run_paths(host, nrx, dev, backend, P, **kw)
            times[backend] = (time.perf_counter() - t0) / 3
        emit(phase="trace", scene=scene_name, nrx=nrx, paths=P,
             bounces=BOUNCES, ok=True, gpu=smi(), launches=n_launch,
             scatter_nonzero=nonzero, agreement=agree, fwd_s=times,
             fwd_queries_per_s={b: queries / s for b, s in times.items()})
    return launches, recorded


def phase_path(recorded):
    """The recorded main-path queries against the twin, then the kernel's
    and the twin's time on the nrx = 4 trace's first bounce query (2^20
    rays) and its shadow query (4 x 2^20 rays)."""
    worst, total_flips = 0.0, 0
    for nrx, queries in recorded.items():
        for i, (o, d, tris, kw, t_k, i_k) in enumerate(queries):
            label = f"path/nrx={nrx}/q{i}"
            flips, err, hits = hold_against_twin(tris, o, d, kw, t_k, i_k,
                                                 label)
            worst = max(worst, err)
            total_flips += flips
            live = kw.get("live")
            emit(phase="path", nrx=nrx, query=i, R=o.shape[0],
                 T=tris.pad_triangles, operands=sorted(
                     k for k, v in kw.items() if v is not None),
                 live=None if live is None else int(live.sum()),
                 hits=hits, flips=flips, max_abs_err=err)

    timing = {}
    queries = recorded[4]
    for label, q in (("bounce_2^20", queries[1]),
                     ("shadow_4x2^20", queries[2])):
        o, d, tris, kw, _, _ = q
        check(o.shape[0] == (PATHS if label.startswith("bounce")
                             else 4 * PATHS), f"{label}: {o.shape[0]} rays")
        run_k = lambda: nearest_hit(o, d, tris, **kw)  # noqa: E731
        run_p = lambda: intersect_torch(o, d, tris,  # noqa: E731
                                        chunk_size=TWIN_CHUNK, **kw)
        wall_ms, plain_wall_ms = time_pair(run_k, run_p)
        ms = device_ms(run_k, 20, "nearest_hit")
        plain_ms = device_ms(run_p, 3)
        live = kw.get("live")
        n_live = o.shape[0] if live is None else int(live.sum())
        t_k, i_k = q[4], q[5]
        bound_ms, bound_by = bound(
            nbytes(o, d, *kw.values(), tris.v0, tris.e1, tris.e2, t_k, i_k),
            NEAREST_HIT_OPS_PER_PAIR * n_live * tris.pad_triangles)
        timing[label] = dict(ms=ms, plain_ms=plain_ms, wall_ms=wall_ms,
                             plain_wall_ms=plain_wall_ms, bound_ms=bound_ms, bound_by=bound_by,
                             rays=o.shape[0], live=n_live,
                             T=tris.pad_triangles)
        emit(phase="kernel_time", query=label, **timing[label], gpu=smi())
    return worst, total_flips, timing


def _device_ms(evt):
    us = getattr(evt, "self_device_time_total", None)
    if us is None:
        us = evt.self_cuda_time_total
    return us / 1e3


def phase_profile(host, dev):
    """One profiler window per nrx over a warm 2^20-path ``compute_paths``
    (launch directions cached).  Device busy is the sum of the device
    events' own times (kernels and copies run one at a time on the one
    stream); the idle share is the rest of the profiled call's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for nrx in (1, 4):
        run_paths(host, nrx, dev, "cuda", PATHS)               # warm-up
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run_paths(host, nrx, dev, "cuda", PATHS)
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows = prof.key_averages()
        dev_rows = [e for e in rows if e.device_type == DeviceType.CUDA]
        host_ms = sum(e.self_cpu_time_total for e in rows
                      if e.device_type == DeviceType.CPU) / 1e3
        out = dict(phase="profile", nrx=nrx, paths=PATHS, wall_ms=wall_ms,
                   host_self_ms=host_ms, gpu=smi())
        if dev_rows:
            busy = sum(_device_ms(e) for e in dev_rows)
            nh = [e for e in dev_rows if "nearest_hit_kernel" in e.key]
            nh_ms = sum(_device_ms(e) for e in nh)
            top = sorted(dev_rows, key=_device_ms, reverse=True)[:5]
            out.update(device_busy_ms=busy, idle_share=1.0 - busy / wall_ms,
                       nearest_hit_ms=nh_ms,
                       nearest_hit_launches=sum(e.count for e in nh),
                       nearest_hit_share=nh_ms / busy,
                       device_ops=sum(e.count for e in dev_rows),
                       top_device=[[e.key[:60], _device_ms(e), e.count]
                                   for e in top])
        else:
            out.update(device_busy_ms=None,
                       note="the profiler recorded no device events")
        emit(**out)


def phase_grad(host, dev):
    mats = default_materials(dev)
    cfg = TracerConfig(num_paths=SMALL_PATHS, num_bounces=BOUNCES,
                       keep_rays=False, compact_rays=True)
    res = trace(host, rx_positions(1), TX, carrier_frequency=FREQ_GHZ,
                config=cfg, materials=mats, device=dev)
    loss = (res.scatter.a_te.abs().square().sum()
            + res.scatter.a_tm.abs().square().sum()) * 1e9   # as bench.py
    loss.backward()
    torch.cuda.synchronize()
    gmax = {}
    for f in MATERIAL_FIELDS:
        g = getattr(mats, f).grad
        if g is None:
            continue
        check(bool(torch.isfinite(g).all()), f"grad {f} not finite")
        gmax[f] = float(g.abs().max())
    check(any(v > 0 for v in gmax.values()), "all material gradients zero")
    emit(phase="grad", ok=True, loss=float(loss.detach()), grad_abs_max=gmax)


def nbytes(*xs):
    """Bytes of the tensors among ``xs``, each counted once."""
    return sum(x.numel() * x.element_size() for x in xs
               if isinstance(x, torch.Tensor))


def bound(n_bytes, n_ops):
    """(least time in ms on an H100 SXM, "bytes" or "operations")."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def calib_config(paths, nrx, fused):
    """bench.py's material-calibration flags on the port."""
    return calibration_config(paths, BOUNCES, fused)


def calib_step(tris, nrx, mats, cfg, backward=True):
    """One step of bench.py's workload at ``nrx`` receivers."""
    return calibration_step(tris, rx_positions(nrx), TX, FREQ_GHZ, mats, cfg,
                            backward=backward)


def phase_train(tris, dev):
    """This slice's main path.  Returns per nrx the launch counts of one
    step and its recorded fused kernel calls."""
    mats = default_materials(dev)
    expected = {"nearest_hit": 1 + 2 * BOUNCES, "bounce_pre": BOUNCES,
                "bounce_post": BOUNCES, "loop_bwd_slim": 1}
    counts, recorded = {}, {}
    for nrx in (1, 4):
        cfgs = {"fused": calib_config(PATHS, nrx, True),
                "xla": calib_config(PATHS, nrx, False)}
        calib_step(tris, nrx, mats, cfgs["fused"])             # warm-up
        with recording_fused() as calls:
            for kern in KERNELS.values():
                kern.launches = 0
            res, loss = calib_step(tris, nrx, mats, cfgs["fused"])
            counts[nrx] = {n: kern.launches for n, kern in KERNELS.items()}
        recorded[nrx] = calls
        check(counts[nrx] == expected,
              f"nrx={nrx}: launches {counts[nrx]}, expected {expected}")
        for f in OUTPUT_FIELDS:
            x = getattr(res.scatter, f)
            x = torch.view_as_real(x) if x.is_complex() else x
            check(bool(torch.isfinite(x).all()), f"nrx={nrx}: {f} not finite")
        check(tuple(res.scatter.a_te.shape) == (nrx, 1, BOUNCES * PATHS),
              f"nrx={nrx}: scatter shape {tuple(res.scatter.a_te.shape)}")
        g = grads_of(mats)
        check(all(bool(torch.isfinite(v).all()) for v in g.values())
              and any(float(v.abs().max()) > 0 for v in g.values()),
              f"nrx={nrx}: material gradients not finite or all zero")
        loss_value = float(loss.detach())
        del res, loss

        # in turns: op path, fused, fused, op path
        times = {}
        for bwd in (False, True):
            for shade in ("xla", "fused", "fused", "xla"):
                calib_step(tris, nrx, mats, cfgs[shade], backward=bwd)
                t0 = time.perf_counter()
                for _ in range(3):
                    calib_step(tris, nrx, mats, cfgs[shade], backward=bwd)
                times.setdefault((shade, bwd), []).append(
                    (time.perf_counter() - t0) / 3)
        queries = BOUNCES * PATHS * (1 + nrx)
        step_s = {f"{shade}_{'fwd_bwd' if bwd else 'fwd'}": sum(v) / len(v)
                  for (shade, bwd), v in times.items()}

        # fused against the op path at 2^16 paths: gradients and slots
        grads, scat = {}, {}
        for shade in ("xla", "fused"):
            m = default_materials(dev)
            res, _ = calib_step(tris, nrx, m,
                                calib_config(SMALL_PATHS, nrx,
                                             shade == "fused"))
            grads[shade], scat[shade] = grads_of(m), res.scatter
        grad_share = leaves_close(grads["fused"], grads["xla"],
                                  PATH_GRAD_RTOL, LEAF_ATOL,
                                  f"nrx={nrx}: fused vs op-path gradients")
        agree = {f: slots_agree(getattr(scat["xla"], f),
                                getattr(scat["fused"], f), f)
                 for f in OUTPUT_FIELDS}
        emit(phase="train", nrx=nrx, paths=PATHS, bounces=BOUNCES, ok=True,
             gpu=smi(), launches=counts[nrx], loss=loss_value,
             step_s=step_s, all_step_s={f"{k[0]}_{k[1]}": v
                                        for k, v in times.items()},
             queries_per_s={k: queries / v for k, v in step_s.items()},
             grad_vs_op_path_max_leaf_share=grad_share,
             slot_agreement_2_16=agree)
    return counts, recorded


def fused_work(name, spec, rest, outs):
    """(bytes, f32 operations) that one call of fused kernel ``name`` must
    move and do on this run's data: each input it needs read once, each
    output written once."""
    nrx = spec.nrx
    if name == "bounce_pre":
        R = rest[0].shape[0]
        return (nbytes(*rest, *outs),
                R * (PRE_OPS_PER_RAY + PRE_OPS_PER_RX * nrx))
    if name == "bounce_post":
        # ex row 2 (the incidence n.d) is read only under physical parity
        ex = rest[2]
        unused = 0 if spec.parity == "physical" else nbytes(ex[2])
        return (nbytes(*rest, *outs) - unused,
                rest[0].shape[0] * nrx * POST_OPS_PER_RX)
    # the backward: a (ray, RX) is written only where the ray is live, so a
    # dead ray needs its freq cotangents (d_out row 5) only; a live ray its
    # material, state rows 0-3, the 3 res_pre rows and res_post row 5 (wf)
    # per RX; a live ray written at that bounce its next state rows 0-3
    # once, and res_post and d_out rows 0-4 per written RX
    eta_tab, _, live_all, _, _, res_post, d_out = rest
    written = res_post[:, :, 5] > 0                     # [B, nrx, R]
    n_live = int(live_all.sum())
    n_write = int(written.sum())
    n_written_rays = int(written.any(dim=1).sum())
    n_bytes = (nbytes(eta_tab, live_all, *outs)
               + nbytes(d_out[:, :, 5])
               + n_live * (4 + 16 + 12 + 4 * nrx)
               + 16 * n_written_rays + 40 * n_write)
    return n_bytes, n_live * BWD_PRE_OPS + n_write * BWD_POST_OPS


def phase_fused_kernel(recorded, dev):
    """Every recorded fused kernel call against its plain version; the
    backward on a 300-row material table, run twice to the same bits; then
    the times and bounds of the first call of each kernel, per nrx."""
    mats = default_materials(dev)
    summary = {name: dict(max_abs_err=0.0) for name in FUSED}
    for nrx, calls in recorded.items():
        for name in FUSED:
            for i, (args, out) in enumerate(calls[name]):
                spec, rest = args[0], args[1:]
                label = f"{name}/nrx={nrx}/call{i}"
                if name == "bounce_pre":
                    err, ulps = hold_pre(spec, rest, out, label)
                    extra = dict(ulps=ulps)
                elif name == "bounce_post":
                    err, ulps = hold_post(spec, rest, out, label)
                    extra = dict(ulps=ulps)
                else:
                    err, share, err32 = hold_bwd(spec, rest, out, mats,
                                                 FREQ_GHZ, label)
                    extra = dict(grad_max_leaf_share=share,
                                 plain_f32_vs_f64_max_abs=err32)
                summary[name]["max_abs_err"] = max(
                    summary[name]["max_abs_err"], err)
                emit(phase="fused_kernel", kernel=name, nrx=nrx, call=i,
                     R=rest[1].shape[-1] if name == "loop_bwd_slim"
                     else rest[0].shape[0], max_abs_err=err, **extra)

        # a table of 300 materials, ids drawn over all of them (most >= 256):
        # the int32 ids and the warps of mixed materials, whose sums must
        # come out the same in every run
        args, _ = calls["loop_bwd_slim"][0]
        spec, rest = args[0], list(args[1:])
        rng = np.random.default_rng(nrx)
        m300 = material_table(300, rng, dev)
        eta = precompute_eta(m300, FREQ_GHZ)
        rest[0] = torch.stack([getattr(eta, f) for f in ETA_FIELDS],
                              dim=-1).detach()
        rest[3] = torch.as_tensor(rng.integers(0, 300, rest[3].shape),
                                  dtype=torch.int32, device=dev)
        k = KERNELS["loop_bwd_slim"](spec, *rest)
        label = f"loop_bwd_slim/nrx={nrx}/300 materials"
        err, share, _ = hold_bwd(spec, rest, k, m300, FREQ_GHZ, label)
        again = KERNELS["loop_bwd_slim"](spec, *rest)
        check(all(torch.equal(a, b) for a, b in zip(k, again)),
              f"{label}: two runs differ")
        run_300 = lambda: KERNELS["loop_bwd_slim"](spec, *rest)  # noqa: E731
        emit(phase="fused_kernel", kernel="loop_bwd_slim", nrx=nrx,
             materials=300, max_abs_err=err, grad_max_leaf_share=share,
             same_bits_twice=True,
             ms=device_ms(run_300, 20, "loop_bwd_slim"), gpu=smi())

        for name in FUSED:
            args, out = calls[name][0]
            spec, rest = args[0], args[1:]
            n_bytes, n_ops = fused_work(name, spec, rest, list(out))
            bound_ms, bound_by = bound(n_bytes, n_ops)
            run_k = lambda: KERNELS[name](spec, *rest)  # noqa: E731,B023
            run_p = lambda: PLAIN[name](spec, *rest)    # noqa: E731,B023
            wall_ms, plain_wall_ms = time_pair(run_k, run_p)
            timing = dict(ms=device_ms(run_k, 20, name),
                          plain_ms=device_ms(run_p, 3), wall_ms=wall_ms,
                          plain_wall_ms=plain_wall_ms, bound_ms=bound_ms,
                          bound_by=bound_by, bytes=n_bytes,
                          ops=n_ops)
            summary[name].setdefault("timing", {})[nrx] = timing
            emit(phase="fused_kernel_time", kernel=name, nrx=nrx, **timing,
                 gpu=smi())
    return summary


def phase_profile_step(tris, dev):
    """One profiler window over a warm forward+backward step at nrx = 1, of
    the fused path and of the op path: device busy, the four kernels' times
    and launches, device operations and the idle share of the step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    mats = default_materials(dev)
    for shade in ("fused", "xla"):
        cfg = calib_config(PATHS, 1, shade == "fused")
        calib_step(tris, 1, mats, cfg)                         # warm-up
        t0 = time.perf_counter()
        calib_step(tris, 1, mats, cfg)
        unprofiled_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            calib_step(tris, 1, mats, cfg)
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows = prof.key_averages()
        dev_rows = [e for e in rows if e.device_type == DeviceType.CUDA]
        host_ms = sum(e.self_cpu_time_total for e in rows
                      if e.device_type == DeviceType.CPU) / 1e3
        out = dict(phase="profile_step", shade=shade, nrx=1, paths=PATHS,
                   wall_ms=wall_ms, unprofiled_wall_ms=unprofiled_ms,
                   host_self_ms=host_ms, gpu=smi())
        if dev_rows:
            busy = sum(_device_ms(e) for e in dev_rows)
            per = {}
            for name in KERNELS:
                ev = [e for e in dev_rows if f"{name}_kernel" in e.key]
                per[name] = dict(ms=sum(_device_ms(e) for e in ev),
                                 launches=sum(e.count for e in ev))
            top = sorted(dev_rows, key=_device_ms, reverse=True)[:8]
            out.update(device_busy_ms=busy, idle_share=1.0 - busy / wall_ms,
                       idle_share_unprofiled=1.0 - busy / unprofiled_ms,
                       kernels=per, device_ops=sum(e.count for e in dev_rows),
                       top_device=[[e.key[:60], _device_ms(e), e.count]
                                   for e in top])
        else:
            out.update(device_busy_ms=None,
                       note="the profiler recorded no device events")
        emit(**out)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one NVIDIA GPU",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    emit(phase="env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0))

    phase_build()

    if os.path.exists(CANYON):
        scene_name, main_scene = "street_canyon", load_hrt(CANYON)
    else:
        scene_name = "stand-in random_soup_scene(234, seed=0, extent=90, tri_size=8)"
        main_scene = random_soup_scene(234, seed=0, extent=90.0, tri_size=8.0)
    emit(phase="scene", scene=scene_name,
         triangles=main_scene.num_triangles)

    scenes = {scene_name: (main_scene, TX[0]),
              "box": (box_scene(), [0.0, 0.0, 2.5])}
    max_err, flips = phase_kernel(scenes, dev)
    launches, recorded = phase_trace(main_scene, scene_name, dev)
    path_err, path_flips, timing = phase_path(recorded)
    del recorded
    phase_profile(main_scene, dev)
    phase_grad(main_scene, dev)

    tris = flatten_scene(main_scene, device=dev)
    counts, recorded = phase_train(tris, dev)
    fused = phase_fused_kernel(recorded, dev)
    del recorded
    phase_profile_step(tris, dev)

    t = timing["bounce_2^20"]
    rows = [{
        "name": "nearest_hit", "route": "cuda",
        "source": os.path.relpath(str(SOURCE), REPO),
        "replaces": REPLACES["nearest_hit"],
        "also_replaces": "hermespy_rt_tpu/ops/intersect_pallas.py:388",
        "launches": counts[1]["nearest_hit"] + counts[4]["nearest_hit"],
        "launches_per_step": {n: c["nearest_hit"] for n, c in counts.items()},
        "op_path_launches": launches,
        "max_abs_err": max(max_err, path_err), "flips": flips,
        "path_flips": path_flips, "path_max_abs_err": path_err,
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None,
        "wall_ms": t["wall_ms"], "plain_wall_ms": t["plain_wall_ms"],
        "shadow_ms": timing["shadow_4x2^20"]["ms"],
        "shadow_plain_ms": timing["shadow_4x2^20"]["plain_ms"],
        "shadow_bound_ms": timing["shadow_4x2^20"]["bound_ms"]}]
    for name in FUSED:
        t1 = fused[name]["timing"][1]
        rows.append({
            "name": name, "route": "cuda",
            "source": os.path.relpath(str(fused_ops.SOURCE), REPO),
            "replaces": REPLACES[name],
            "launches": counts[1][name] + counts[4][name],
            "launches_per_step": {n: c[name] for n, c in counts.items()},
            "max_abs_err": fused[name]["max_abs_err"],
            "ms": t1["ms"], "plain_ms": t1["plain_ms"],
            "bound_ms": t1["bound_ms"], "bound_by": t1["bound_by"],
            "library_ms": None, "wall_ms": t1["wall_ms"],
            "plain_wall_ms": t1["plain_wall_ms"],
            "nrx4": fused[name]["timing"][4]})
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
