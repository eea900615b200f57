#!/usr/bin/env python
"""Profile steps of the PyTorch port on one NVIDIA GPU, for one or more
checkouts of the repo in turns.

    python3 scripts/profile_op_steps.py --tree OLD --tree . --order 0110
    python3 scripts/profile_op_steps.py --tree OLD --tree . --order 0110 \
        --steps city

Each entry of ``--order`` (an index into the ``--tree`` list) runs in a
process of its own that imports ``hermespy_rt_tpu_torch`` from that tree
(whose kernels it builds there) and measures, on the canyon stand-in of
``chip_smoke.py`` (``random_soup_scene(234, seed=0, extent=90,
tri_size=8)``, or ``scenes/simple_street_canyon_with_cars.hrt`` where the
tree has it) at 2^20 paths, B = 3, nrx = 1, reference parity:

- ``phase9``: ``bench.py``'s material-calibration step on the op path
  (``chip_smoke.py`` phase 9, ``shade="xla"``);
- ``N``: the full-gradient step on the op path with every kernel
  (``chip_smoke.py`` phase N, ``shade="pallas", cull=True``,
  ``grad_geometry``; loss ``testing.grad_loss``; gradients to the
  materials, the RX and TX positions, the frequency and the vertices);
- ``7``: ``bench.py``'s material-calibration step on the fused path
  (``chip_smoke.py`` phase 7), and ``7_nrx4`` the same at nrx = 4;
- ``G``: the full-gradient fused step (``chip_smoke.py`` phase G: the
  JAX defaults ``grad_positions``, ``grad_geometry``), and ``G_nrx4``;

and the nearest-hit queries (``queries``), each recorded inside the tracer
and then run alone: per query its rays, live rays (the ones with a limit
``>= 0``), the count of 256-ray blocks holding 0, 1-31, 32-255 and 256
live rays, the kernel's device time (profiler, 5 calls after a warm-up)
and the device-to-host copies and host synchronisations in one profiler
window over one call (the window's own closing synchronise included):

- ``path``: the seven brute queries of one op-path forward
  (``chip_smoke.py`` phases 3-4: ``compute_paths``, its default launch
  order, compact rays) at nrx = 1 and 4;
- ``N``: the seven culled queries of one N step at nrx = 1, each with the
  culled kernel's skipped (block, tile) pairs and the brute kernel's time
  on the same query;
- ``soup2000``: the seven brute queries of the same forward at nrx = 1 on
  ``random_soup_scene(2000, seed=0, extent=90, tri_size=8)`` (2,048 padded
  triangles, the size of the street canyon), each also through the culled
  kernel (its skipped pairs and time).

and on the config-5 city of ``chip_smoke.py`` (``scene.make_city``: 131,072
triangles written as Sionna XML + PLY under the tree's ``_build/``, read
back, Morton-sorted; TX (-120, 80, 45), RX (30, -40, 1.5), 3 GHz, 2^20
paths, B = 3, physical parity, coherent launch order; every query through
the visit-list walk), nrx = 1:

- ``D``: the op-path forward (``chip_smoke.py`` phase D);
- ``E``: the fused material-calibration step (phase E);
- ``walk``: the seven walk queries of one D forward, recorded: each
  query's walk kernel and prepass kernel device time (profiler, 5 calls
  after a warm-up), its rays and live rays, and the device-to-host copies
  and synchronisations in one profiler window over one ``walk_query``
  (the window's own closing synchronise included).

``--steps`` picks ``canyon`` (phase9, N, 7, G, the single calls and the
queries), ``queries`` (the queries alone), ``city`` (D, E and the walk
queries) or ``all`` (the default).

Per step: the host-clock wall of 3 steps after two warm-ups, then one
torch.profiler window over one step: wall, device busy, device operations,
idle share (``1 - busy / wall``), and the device time and operations of the
row gather, the scatter-add, the sorts and the two walk kernels.  Then
(canyon) single calls of the scatter-add and the gather at the steps'
shapes (``calls``: 2^20 rows of 27 columns, seeded, runs of 64 equal ids):
the scatter-add into the canyon's 256 rows with the first 7,699 rows kept
(as G's first call) and with every row kept (as N's payload backward), and
into the city's 131,072 rows with every row kept; the gather of 2^20 rows
from 256.  For each, the whole call's device time and device operations
per call, over 20 calls after a warm-up.  One JSON line per process, then a
summary per tree (the mean of its turns and, under ``spread``, their least
and greatest value), the card's name and power limit.  Exits non-zero
without a CUDA device.
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

PATHS = 1 << 20
BOUNCES = 3
TX = [[-20.0, -10.0, 10.0]]
RX = [[10.0, 5.0, 2.0]]
FREQ_GHZ = 3.0
CITY_TX = [[-120.0, 80.0, 45.0]]
CITY_RX = [[30.0, -40.0, 1.5]]
NAMED = ("gather", "scatter_add", "sort", "walk_kernel", "walk_prepass",
         "nearest_hit_kernel", "nearest_hit_culled_kernel")
BLOCK_RAYS = 256       # rays per block of the nearest-hit kernels


def rx_positions(nrx):
    """``chip_smoke.py``'s receivers: (10, 5, 2) + k (1.5, -2, 0.25)."""
    return [[10.0 + 1.5 * k, 5.0 - 2.0 * k, 2.0 + 0.25 * k]
            for k in range(nrx)]


def smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def _ms(e):
    """A profiler row's own device time in ms."""
    us = getattr(e, "self_device_time_total", None)
    return (e.self_cuda_time_total if us is None else us) / 1e3


def window(torch, fn):
    """One profiler window over ``fn`` (warm): wall, busy, operations,
    idle share, and the named device operations' time and count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy = sum(_ms(e) for e in rows)
    named = {}
    for name in NAMED:
        ev = [e for e in rows if name in e.key.lower()]
        named[name] = dict(ms=sum(_ms(e) for e in ev),
                           ops=sum(e.count for e in ev))
    return dict(wall_ms=wall_ms, device_busy_ms=busy,
                device_ops=sum(e.count for e in rows),
                idle_share=1.0 - busy / wall_ms if rows else None,
                named=named)


def device_rows(torch, fn, reps):
    """The profiler's events of ``reps`` calls of ``fn`` after a warm-up:
    ``(device rows, host rows)``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = prof.key_averages()
    return ([e for e in rows if e.device_type == DeviceType.CUDA],
            [e for e in rows if e.device_type != DeviceType.CUDA])


def kernel_ms(torch, fn, name, reps=5):
    """Device time in ms per call of the kernels named ``name``."""
    dev_rows, _ = device_rows(torch, fn, reps)
    return sum(_ms(e) for e in dev_rows if name in e.key) / reps


def walk_queries(torch, tracer, walk_cuda, walk_ops, city_paths):
    """The seven walk queries of one city forward (see the module
    docstring)."""
    recorded = []
    real = tracer.walk_query

    def spy(o, d, scene, **kw):
        recorded.append((o, d, scene, kw))
        return real(o, d, scene, **kw)

    tracer.walk_query = spy
    try:
        city_paths()
    finally:
        tracer.walk_query = real
    out = []
    for o, d, scene, kw in recorded:
        t_max, live = kw.get("t_max"), kw.get("live")
        any_hit = bool(kw.get("any_hit")) and t_max is not None
        lim = walk_ops.query_limits(o.shape[0], scene.block_rays, t_max=t_max,
                                    live=live, device=o.device)
        reach, key = walk_cuda.walk_prepass(o, d, lim, scene.boxes)
        visits = walk_ops.visit_rows(reach, key)

        def run_walk():
            walk_cuda.walk(o, d, lim, scene, visits,
                           exclude=kw.get("exclude"), any_hit=any_hit)

        dev_rows, host = device_rows(torch, lambda: real(o, d, scene, **kw), 1)
        out.append(dict(
            rays=o.shape[0], live=int((lim >= 0).sum()), any_hit=any_hit,
            walk_ms=kernel_ms(torch, run_walk, "walk_kernel"),
            prepass_ms=kernel_ms(
                torch, lambda: walk_cuda.walk_prepass(o, d, lim, scene.boxes),
                "walk_prepass"),
            query_dtoh=sum(e.count for e in dev_rows if "DtoH" in e.key),
            query_syncs=sum(e.count for e in host
                            if "Synchronize" in e.key)))
    return out


def recorded_queries(tracer, run):
    """The brute and culled queries ``(o, d, tris, kw)`` that ``run()``
    makes inside the tracer, by kind."""
    out = {"nearest_hit": [], "nearest_hit_culled": []}
    real = {name: getattr(tracer, name) for name in out}

    def spy(name):
        def call(o, d, tris, *args, **kw):
            kw = {k: v for k, v in kw.items() if k != "chunk_size"}
            if args:                                     # the culled aabbs
                kw["aabbs"] = args[0]
            out[name].append((o, d, tris, kw))
            return real[name](o, d, tris, **kw)
        return call

    for name in out:
        setattr(tracer, name, spy(name))
    try:
        run()
    finally:
        for name, fn in real.items():
            setattr(tracer, name, fn)
    return out


def query_row(torch, walk_ops, kernels, o, d, tris, kw, culled):
    """One query's rays, live rays, live rays per block and device times
    (see the module docstring).  ``culled``: the query is the culled
    kernel's (its brute time beside it), else the brute kernel's (with a
    culled twin where the query carries none: the culled time beside it)."""
    brute, cull = kernels
    R = o.shape[0]
    lim = walk_ops.query_limits(R, BLOCK_RAYS, t_max=kw.get("t_max"),
                                live=kw.get("live"), device=o.device)
    per_block = (lim >= 0).reshape(-1, BLOCK_RAYS).sum(1)
    bins = [int((per_block == 0).sum()),
            int(((per_block >= 1) & (per_block < 32)).sum()),
            int(((per_block >= 32) & (per_block < BLOCK_RAYS)).sum()),
            int((per_block == BLOCK_RAYS).sum())]
    brute_kw = {k: v for k, v in kw.items() if k != "aabbs"}
    cull_kw = dict(kw)
    if "aabbs" not in cull_kw:
        cull_kw["aabbs"] = walk_ops.cull_boxes(tris)
    skipped = torch.zeros(1, dtype=torch.int64, device=o.device)
    run_b = lambda: brute(o, d, tris, **brute_kw)          # noqa: E731
    run_c = lambda: cull(o, d, tris, **cull_kw)            # noqa: E731
    cull(o, d, tris, skipped=skipped, **cull_kw)
    run = run_c if culled else run_b
    dev_rows, host = device_rows(torch, run, 1)
    return dict(
        rays=R, live=int(per_block.sum()), T=tris.pad_triangles,
        operands=sorted(k for k in kw if kw[k] is not None),
        blocks_by_live=dict(zip(("0", "1-31", "32-255", "256"), bins)),
        brute_ms=kernel_ms(torch, run_b, "nearest_hit_kernel"),
        culled_ms=kernel_ms(torch, run_c, "nearest_hit_culled_kernel"),
        culled_skipped=int(skipped), culled_pairs=int(
            per_block.numel() * cull_kw["aabbs"].shape[0]),
        query_dtoh=sum(e.count for e in dev_rows if "DtoH" in e.key),
        query_syncs=sum(e.count for e in host if "Synchronize" in e.key),
        query_ops=sum(e.count for e in dev_rows))


def queries(torch, dev, tris, paths_of, n_step):
    """The ``queries`` measurements (see the module docstring)."""
    from hermespy_rt_tpu_torch import tracer
    from hermespy_rt_tpu_torch.ops import walk as walk_ops
    from hermespy_rt_tpu_torch.ops.intersect_cuda import (nearest_hit,
                                                          nearest_hit_culled)
    from hermespy_rt_tpu_torch.scene import flatten_scene, random_soup_scene

    kernels = (nearest_hit, nearest_hit_culled)
    out = {}
    soup = flatten_scene(random_soup_scene(2000, seed=0, extent=90.0,
                                           tri_size=8.0), device=dev)
    for label, scene, nrx, culled in (("path_nrx1", tris, 1, False),
                                      ("path_nrx4", tris, 4, False),
                                      ("N_nrx1", tris, 1, True),
                                      ("soup2000_nrx1", soup, 1, False)):
        run = (n_step if culled else
               lambda scene=scene, nrx=nrx: paths_of(scene, nrx))
        rec = recorded_queries(tracer, run)
        kind = "nearest_hit_culled" if culled else "nearest_hit"
        out[label] = [query_row(torch, walk_ops, kernels, *q, culled)
                      for q in rec[kind]]
        del rec
    return out


def calls(torch, fetch_cuda, dev):
    """Whole-call device time and operations of single scatter-add and
    gather calls (see the module docstring)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    N, C = 1 << 20, 27
    g = torch.randn((N, C), generator=gen, device=dev)

    def ids(T, kept):
        runs = torch.randint(0, T, (N // 64,), generator=gen, device=dev)
        idx = runs.repeat_interleave(64).to(torch.int32)
        idx[kept:] = -1
        return idx

    cases = {
        "scatter_canyon_first": lambda i=ids(256, 7699): (
            fetch_cuda.scatter_add(i, g, 256)),
        "scatter_canyon_all_kept": lambda i=ids(256, N): (
            fetch_cuda.scatter_add(i, g, 256)),
        "scatter_city_all_kept": lambda i=ids(131072, N): (
            fetch_cuda.scatter_add(i, g, 131072)),
        "gather_canyon": lambda i=ids(256, N), t=torch.randn(
            (256, C), generator=gen, device=dev): fetch_cuda.gather(t, i),
    }
    out = {}
    for name, fn in cases.items():
        rows, _ = device_rows(torch, fn, 20)
        out[name] = dict(call_ms=sum(_ms(e) for e in rows) / 20,
                         call_ops=sum(e.count for e in rows) / 20)
    return out


def child(tree, steps):
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    import numpy as np

    import hermespy_rt_tpu_torch as pkg
    from hermespy_rt_tpu_torch import compute_paths, default_materials, trace
    from hermespy_rt_tpu_torch.ops import fetch_cuda
    from hermespy_rt_tpu_torch.scene import (flatten_scene, load_hrt,
                                             random_soup_scene)
    from hermespy_rt_tpu_torch.testing import (calibration_config,
                                               calibration_step, grad_loss)

    if not torch.cuda.is_available():
        sys.exit("profile_op_steps: no CUDA device")
    here = os.path.dirname(os.path.dirname(os.path.abspath(pkg.__file__)))
    assert here == os.path.abspath(tree), (here, tree)
    dev = torch.device("cuda", 0)
    hrt = os.path.join(tree, "scenes", "simple_street_canyon_with_cars.hrt")
    scene = (load_hrt(hrt) if os.path.exists(hrt) else
             random_soup_scene(234, seed=0, extent=90.0, tri_size=8.0))
    tris = flatten_scene(scene, device=dev)

    def op_step():
        calibration_step(tris, RX, TX, FREQ_GHZ, default_materials(dev),
                         calibration_config(PATHS, BOUNCES, False))

    n_cfg = calibration_config(PATHS, BOUNCES, False, grad_geometry=True,
                               shade="pallas", cull=True)
    g_cfg = calibration_config(PATHS, BOUNCES, True, grad_geometry=True,
                               grad_positions=True)

    def grad_step(cfg, rx=RX):
        mats = default_materials(dev)
        v0 = tris.v0.detach().clone().requires_grad_(True)
        leaves = [torch.tensor(x, device=dev, requires_grad=True)
                  for x in (rx, TX, FREQ_GHZ)]
        res = trace(dataclasses.replace(tris, v0=v0), leaves[0], leaves[1],
                    carrier_frequency=leaves[2], config=cfg,
                    materials=mats)
        grad_loss(res).backward()
        torch.cuda.synchronize()

    def fused_step(rx):
        calibration_step(tris, rx, TX, FREQ_GHZ, default_materials(dev),
                         calibration_config(PATHS, BOUNCES, True))

    def paths_of(scene, nrx):
        compute_paths(scene, rx_positions(nrx), TX, np.zeros((nrx, 3)),
                      np.zeros((1, 3)), FREQ_GHZ, nrx, 1, PATHS, BOUNCES,
                      device=dev, parity="reference", keep_rays=False,
                      compact_rays=True)
        torch.cuda.synchronize()

    out = dict(tree=tree, gpu=smi())
    timed = []
    if steps in ("canyon", "all"):
        rx4 = rx_positions(4)
        timed += [("phase9", op_step), ("N", lambda: grad_step(n_cfg)),
                  ("7", lambda: fused_step(RX)),
                  ("7_nrx4", lambda: fused_step(rx4)),
                  ("G", lambda: grad_step(g_cfg)),
                  ("G_nrx4", lambda: grad_step(g_cfg, rx4))]
    if steps in ("city", "all"):
        city, city_paths = city_scene(dev)
        e_cfg = calibration_config(PATHS, BOUNCES, True, parity="physical")

        def e_step():
            calibration_step(city, CITY_RX, CITY_TX, FREQ_GHZ,
                             default_materials(dev), e_cfg)

        timed += [("D", city_paths), ("E", e_step)]
    for name, step in timed:
        step()
        step()                                                  # warm-ups
        t0 = time.perf_counter()
        for _ in range(3):
            step()
        out[name] = dict(wall_mean_ms=(time.perf_counter() - t0) / 3 * 1e3,
                         profile=window(torch, step))
    if steps in ("canyon", "all"):
        out["calls"] = calls(torch, fetch_cuda, dev)
    if steps in ("canyon", "queries", "all"):
        out["queries"] = queries(torch, dev, tris, paths_of,
                                 lambda: grad_step(n_cfg))
    if steps in ("city", "all"):
        from hermespy_rt_tpu_torch import tracer
        from hermespy_rt_tpu_torch.ops import walk as walk_ops
        from hermespy_rt_tpu_torch.ops import walk_cuda
        out["walk"] = walk_queries(torch, tracer, walk_cuda, walk_ops,
                                   city_paths)
    print(json.dumps(out), flush=True)


def city_scene(dev):
    """The config-5 city on the card, and its forward (see the module
    docstring)."""
    import shutil

    import torch

    from hermespy_rt_tpu_torch import compute_paths
    from hermespy_rt_tpu_torch.ops._cuda_build import BUILD_DIR
    from hermespy_rt_tpu_torch.scene import (flatten_scene, load_scene,
                                             make_city)

    out_dir = BUILD_DIR / "city131k_profile"
    city = flatten_scene(load_scene(make_city(str(out_dir))),
                         sort_triangles=True, device=dev)
    shutil.rmtree(out_dir)

    def city_paths():
        compute_paths(city, CITY_RX, CITY_TX, [[0.0, 0.0, 0.0]],
                      [[0.0, 0.0, 0.0]], FREQ_GHZ, 1, 1, PATHS, BOUNCES,
                      device=dev, parity="physical",
                      launch_order="coherent", compact_rays=True,
                      keep_rays=False)
        torch.cuda.synchronize()

    return city, city_paths


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=None)
    ap.add_argument("--order", default=None)
    ap.add_argument("--steps", default="all",
                    choices=("all", "canyon", "city", "queries"))
    ap.add_argument("--out", default=None,
                    help="also write every JSON line to this file")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        return child(args.child, args.steps)
    trees = args.tree or ["."]
    order = [int(c) for c in (args.order or "0" * len(trees))]
    out = open(args.out, "w") if args.out else None

    def emit(line):
        print(line, flush=True)
        if out is not None:
            out.write(line + "\n")
            out.flush()

    runs = []
    for i in order:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--child", trees[i], "--steps", args.steps],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
            sys.exit(f"profile_op_steps: tree {trees[i]} failed")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        emit(json.dumps(runs[-1]))
    summary = {}
    for tree in trees:
        mine = [r for r in runs if r["tree"] == tree]
        if not mine:
            continue

        def stat(get):
            vals = [get(r) for r in mine]
            return sum(vals) / len(vals), [min(vals), max(vals)]

        summary[tree] = {"turns": len(mine), "spread": {}}
        steps = [k for k in ("phase9", "N", "7", "7_nrx4", "G", "G_nrx4",
                             "D", "E") if k in mine[0]]
        for step in steps:
            keys = {k: (lambda r, k=k: r[step]["profile"][k])
                    for k in ("wall_ms", "device_busy_ms", "device_ops",
                              "idle_share")}
            keys["wall_mean_ms"] = lambda r: r[step]["wall_mean_ms"]
            for name in ("walk_kernel", "walk_prepass", "nearest_hit_kernel",
                         "nearest_hit_culled_kernel"):
                keys[f"{name}_ms"] = (
                    lambda r, n=name: r[step]["profile"]["named"][n]["ms"])
            summary[tree][step], summary[tree]["spread"][step] = {}, {}
            for k, get in keys.items():
                summary[tree][step][k], summary[tree]["spread"][step][k] = (
                    stat(get))
        if "calls" in mine[0]:
            summary[tree]["calls"] = {
                c: {k: stat(lambda r: r["calls"][c][k])[0]
                    for k in ("call_ms", "call_ops")}
                for c in mine[0]["calls"]}
        if "walk" in mine[0]:
            summary[tree]["walk"], summary[tree]["spread"]["walk"] = [], []
            for q in range(len(mine[0]["walk"])):
                row, spread = dict(mine[0]["walk"][q]), {}
                for k in ("walk_ms", "prepass_ms"):
                    row[k], spread[k] = stat(lambda r: r["walk"][q][k])
                summary[tree]["walk"].append(row)
                summary[tree]["spread"]["walk"].append(spread)
        if "queries" in mine[0]:
            summary[tree]["queries"], summary[tree]["spread"]["queries"] = (
                {}, {})
            for label, rows in mine[0]["queries"].items():
                summary[tree]["queries"][label] = []
                summary[tree]["spread"]["queries"][label] = []
                for q in range(len(rows)):
                    row, spread = dict(rows[q]), {}
                    for k in ("brute_ms", "culled_ms"):
                        row[k], spread[k] = stat(
                            lambda r: r["queries"][label][q][k])
                    summary[tree]["queries"][label].append(row)
                    summary[tree]["spread"]["queries"][label].append(spread)
    emit(json.dumps({"summary": summary}))
    emit(smi())


if __name__ == "__main__":
    main()
