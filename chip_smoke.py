#!/usr/bin/env python
"""Smoke run of the PyTorch port (``hermespy_rt_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero:

1. build    -- compile the nearest-hit kernel library from
               ``hermespy_rt_tpu_torch/csrc/intersect.cu`` with nvcc.
2. kernel   -- the kernel against its plain torch twin on the card, on the
               street canyon (or its stand-in) and the box scene: 2^18 rays
               from the launch point and 2^18 from random origins, with
               exclude, scalar and per-ray t_max, and live masks.  Every hit
               decision that differs must be an f64 edge/tie case
               (tests/utils.py::assert_flips_explained) and t must agree to
               rtol 2e-5 where the decision agrees.
3. trace    -- ``compute_paths`` at 2^20 paths, 3 bounces, reference parity,
               nrx = 1 and 4, through the kernel: its launch count, finite
               outputs, a written scatter; at 2^16 paths the same trace with
               the plain twin must agree; forward queries/s of both.  Every
               kernel query of the two 2^20-path traces is recorded.
4. path     -- each recorded query (LoS, 2^20-ray bounce, 2^20 x nrx shadow
               queries with their exclude and live operands) re-run through
               the twin and held to the tier of phase 2; dead rays miss and
               no ray hits its excluded triangle.  Then the kernel's and the
               twin's time per query on the recorded nrx = 4 bounce and
               shadow queries.
5. profile  -- one torch.profiler window per nrx over a warm 2^20-path
               ``compute_paths``: device busy time, the kernel's share,
               device operations, host time.
6. grad     -- one backward of sum |a_te|^2 + |a_tm|^2 to the material table.

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
from hermespy_rt_tpu_torch.ops.geometry import fibonacci_sphere
from hermespy_rt_tpu_torch.ops.intersect import intersect_torch
from hermespy_rt_tpu_torch.ops.intersect_cuda import SOURCE, nearest_hit
from hermespy_rt_tpu_torch.scene import (box_scene, flatten_scene, load_hrt,
                                         random_soup_scene)

REPO = os.path.dirname(os.path.abspath(__file__))
CANYON = os.path.join(REPO, "scenes", "simple_street_canyon_with_cars.hrt")
TX = [[-20.0, -10.0, 10.0]]
FREQ_GHZ = 3.0
BOUNCES = 3
PATHS = 1 << 20          # main-path paths per trace
SMALL_PATHS = 1 << 16    # paths of the kernel-vs-twin trace and the backward
KERNEL_RAYS = 1 << 18    # rays per kernel-vs-twin query
TWIN_CHUNK = 1 << 15     # ray chunk of the plain twin on the card


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


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
    lib = nearest_hit.build()
    secs = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in nearest_hit.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit(phase="build", ok=True, seconds=secs,
         library=os.path.relpath(str(lib), REPO), ptxas=ptxas, gpu=smi())


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


def slots_agree(ref, ours, label):
    ref, ours = ref.cpu().numpy(), ours.cpu().numpy()
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
        for f in ("a_te", "a_tm", "tau", "freq_shift", "directions_rx"):
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
                 for f in ("a_te", "a_tm", "tau", "freq_shift",
                           "directions_rx")}

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
        p1 = cuda_ms(run_p, 3)
        k1 = cuda_ms(run_k, 20)
        k2 = cuda_ms(run_k, 20)
        p2 = cuda_ms(run_p, 3)
        timing[label] = dict(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                             rays=o.shape[0], T=tris.pad_triangles)
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

    t = timing["bounce_2^20"]
    print(json.dumps({"kernels": [{
        "name": "nearest_hit", "route": "cuda",
        "source": os.path.relpath(str(SOURCE), REPO),
        "replaces": "hermespy_rt_tpu/ops/intersect_pallas.py:369",
        "also_replaces": "hermespy_rt_tpu/ops/intersect_pallas.py:388",
        "launches": launches, "max_abs_err": max(max_err, path_err),
        "flips": flips, "path_flips": path_flips,
        "path_max_abs_err": path_err,
        "ms": t["ms"], "plain_ms": t["plain_ms"],
        "shadow_ms": timing["shadow_4x2^20"]["ms"],
        "shadow_plain_ms": timing["shadow_4x2^20"]["plain_ms"]}]}),
        flush=True)
    print(smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
