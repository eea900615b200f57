#!/usr/bin/env python
"""Profile steps of the PyTorch port on one NVIDIA GPU, for one or more
checkouts of the repo in turns.

    python3 scripts/profile_op_steps.py --tree OLD --tree . --order 0110
    python3 scripts/profile_op_steps.py --tree OLD --tree . --order 0110 \
        --steps city
    python3 scripts/profile_op_steps.py --tree OLD --tree . --order 0110 \
        --steps bwd

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
- ``J``: ``config5_e2e.py``'s loss through the full-gradient fused path
  (phase J: gradients to the materials, the RX and TX positions and the
  frequency);
- ``walk``: the seven walk queries of one D forward, recorded: each
  query's rays, live rays, ray tiles and those with a live ray, the walk
  kernel's and the prepass kernel's device time (profiler, 5 calls after a
  warm-up), and the whole making of its visit rows (the prepass and, in a
  tree whose prepass returns reach and key, ``visit_rows``' torch sort): its
  device time and operations; the prepass again with the 50 MB L2 emptied
  before each call (``prepass_cold_ms``); the prepass's bounds
  (``measure.prepass_bounds``: over the (live ray, box) pairs a per-tile
  prune keeps, ``ops/walk.py::prepass_kept_plain``, where the tree has it,
  and the prune's tests; and over all (live ray, box) pairs at the f32 rate
  and at half of it), its (live ray, box) pairs and the kept ones; and
  the device operations, device-to-host copies and
  synchronisations in one profiler window over one ``walk_query`` (the
  window's own closing synchronise included).  The summary sets the seven
  standalone prepass times beside the prepass time inside D's step.

and the stage backwards (``bwd``): kernel 12, the full pre backward, its
calls recorded in one step of G, of G at nrx = 4 and of J (after a
warm-up), each with its rays, RX and payload columns, its device time
(profiler, 20 calls after a warm-up), its bound (``measure.bwd_work``), the
share, and the SHA-1 of each output (``d_o``, ``d_d``, ``d_st``, ``d_pay``
per ray, the sums ``d_rxp`` and ``d_sc``) with whether a second run gave
the same bits; kernels 13-16 (the full post backward, the slim pre and
post backwards and the whole-loop backward), their calls recorded in those
steps, in phase 7's step and in the slim per-stage step (``I``:
``unroll_bounces=False``), each with the SHA-1 of its operands and of its
outputs and whether a second run gave the same bits.  The summary says,
per call, whether kernel 12's per-ray outputs and kernels 13-16's operands
and outputs are the same bits in every turn of every tree.

``--steps`` picks ``canyon`` (phase9, N, 7, G, the single calls and the
queries), ``queries`` (the queries alone), ``city`` (D, E, J and the walk
queries), ``bwd`` (the stage backwards) or ``all`` (all but ``bwd``, the
default).  Every child also reports the registers and spills of the
prepass and the full pre backward from its tree's build, and its profiler
windows with the launches they missed (``measure.profiled``: every window
opens on a warm-up cycle; a device time is a window's sum over its
calls).  The yardstick is this checkout's ``hermespy_rt_tpu_torch/
measure.py`` whichever tree is measured.

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
import hashlib
import importlib.util
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
         "nearest_hit_kernel", "nearest_hit_culled_kernel",
         "bounce_pre_bwd_kernel")
BLOCK_RAYS = 256       # rays per block of the nearest-hit kernels
L2_FLUSH_BYTES = 64 << 20   # more than the H100's 50 MB L2
OTHER_BWD = ("bounce_post_bwd", "bounce_pre_bwd_slim", "bounce_post_bwd_slim",
             "loop_bwd_slim")   # kernels 13-16


def _measure():
    """``hermespy_rt_tpu_torch/measure.py`` of this script's checkout: the
    same yardstick (peaks, operation counts, bounds, profiler window)
    whichever tree a child measures."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "hermespy_rt_tpu_torch", "measure.py")
    spec = importlib.util.spec_from_file_location("_measure", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


M = _measure()
PROFILER = dict(windows=0, taken_again=0, missed=0)   # a child's windows


def rx_positions(nrx):
    """``chip_smoke.py``'s receivers: (10, 5, 2) + k (1.5, -2, 0.25)."""
    return [[10.0 + 1.5 * k, 5.0 - 2.0 * k, 2.0 + 0.25 * k]
            for k in range(nrx)]


def smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def launch_counts():
    """Every kernel wrapper's launch count in the measured tree."""
    from hermespy_rt_tpu_torch.ops import walk_cuda
    from hermespy_rt_tpu_torch.testing import KERNELS

    return {n: k.launches for n, k in {
        **KERNELS, "walk_prepass": walk_cuda.walk_prepass,
        "walk": walk_cuda.walk}.items()}


def profiled(fn, reps):
    """``measure.profiled`` over ``reps`` calls of ``fn``, its windows and
    misses counted in :data:`PROFILER`."""
    w = M.profiled(fn, reps, launch_counts)
    PROFILER["windows"] += 1
    PROFILER["taken_again"] += w.tries > 1
    PROFILER["missed"] += w.missed
    return w


def window(fn):
    """One profiler window over a call of ``fn`` (warm): wall, busy,
    operations, idle share, and the named device operations' time and
    count."""
    w = profiled(fn, 1)
    busy = sum(M.event_ms(e) for e in w.device)
    named = {}
    for name in NAMED:
        ev = [e for e in w.device if name in e.key.lower()]
        named[name] = dict(ms=sum(M.event_ms(e) for e in ev),
                           ops=sum(e.count for e in ev))
    return dict(wall_ms=w.wall_ms, device_busy_ms=busy,
                device_ops=sum(e.count for e in w.device),
                idle_share=1.0 - busy / w.wall_ms if w.device else None,
                named=named)


def kernel_ms(fn, name, reps=5):
    """Device time in ms per call of the kernels named ``name``."""
    return sum(M.event_ms(e) for e in profiled(fn, reps).device
               if name in e.key) / reps


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
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for o, d, scene, kw in recorded:
        t_max, live = kw.get("t_max"), kw.get("live")
        any_hit = bool(kw.get("any_hit")) and t_max is not None
        lim = walk_ops.query_limits(o.shape[0], scene.block_rays, t_max=t_max,
                                    live=live, device=o.device)
        # a tree whose prepass returns (reach, key) sorts them into visit
        # rows with torch ops (visit_rows); a later one writes the rows
        in_kernel = not isinstance(
            walk_cuda.walk_prepass(o, d, lim, scene.boxes), tuple)

        def rows():
            out = walk_cuda.walk_prepass(o, d, lim, scene.boxes)
            return out if in_kernel else walk_ops.visit_rows(*out)

        def cold_rows():
            flush.zero_()      # the 50 MB L2 emptied of the rays and boxes
            return rows()

        visits = rows()

        def run_walk():
            walk_cuda.walk(o, d, lim, scene, visits,
                           exclude=kw.get("exclude"), any_hit=any_hit)

        query = profiled(lambda: real(o, d, scene, **kw), 1)
        rows_dev = profiled(rows, 5).device
        cold_dev = profiled(cold_rows, 5).device
        live_per_tile = (lim >= 0).reshape(-1, scene.block_rays).sum(1)
        # the prepass's bounds (measure.prepass_bounds): over the pairs its
        # per-tile prune keeps, where the tree has one, and over all pairs
        kept_plain = getattr(walk_ops, "prepass_kept_plain", None)
        pre = M.prepass_bounds(
            M.nbytes(o, d, lim, scene.boxes, visits), live_per_tile,
            scene.boxes.shape[0], None if kept_plain is None else kept_plain(
                o, d, lim, scene.boxes, scene.block_rays))
        prepass_ms = sum(M.event_ms(e) for e in rows_dev
                         if "walk_prepass" in e.key) / 5
        rows_ms = sum(M.event_ms(e) for e in rows_dev) / 5
        out.append(dict(
            rays=o.shape[0], live=int(live_per_tile.sum()), any_hit=any_hit,
            ray_tiles=live_per_tile.numel(), live_tiles=pre["live_tiles"],
            boxes=scene.boxes.shape[0],
            visit_mean=float(visits[:, 0].float().mean()),
            rows_in_kernel=in_kernel,
            walk_ms=kernel_ms(run_walk, "walk_kernel"),
            prepass_ms=prepass_ms,
            # the visit rows from the rays: the prepass and, in a tree that
            # sorts outside it, visit_rows' torch ops
            rows_ms=rows_ms, sort_ms=rows_ms - prepass_ms,
            rows_ops=sum(e.count for e in rows_dev) / 5,
            prepass_cold_ms=sum(M.event_ms(e) for e in cold_dev
                                if "walk_prepass" in e.key) / 5,
            prepass_bound_ms=pre["kept"][0] if "kept" in pre else None,
            prepass_all_pairs_bound_ms=pre["all_pairs"][0],
            prepass_all_pairs_bound_half_rate_ms=pre[
                "all_pairs_half_rate"][0],
            pairs=pre["pairs"], kept_pairs=pre.get("kept_pairs"),
            query_ops=sum(e.count for e in query.device),
            query_dtoh=sum(e.count for e in query.device if "DtoH" in e.key),
            query_syncs=sum(e.count for e in query.host
                            if "Synchronize" in e.key)))
    return out


def digest(torch, x):
    """SHA-1 of a tensor's shape, type and bytes, or of another operand's
    repr."""
    h = hashlib.sha1()
    if isinstance(x, torch.Tensor):
        x = x.detach().contiguous().cpu()
        h.update(f"{tuple(x.shape)}{x.dtype}".encode())
        h.update(x.reshape(-1).view(torch.uint8).numpy().tobytes())
    else:
        h.update(repr(x).encode())
    return h.hexdigest()


def pre_bwd_calls(torch, recording_fused, kernel, step):
    """Kernel 12's recorded calls in one ``step`` (after a warm-up): per
    call its rays, RX, payload columns, device time (profiler, 20 calls
    after a warm-up), bound, share, and the SHA-1 of each per-ray output
    and of the sums, with whether a second run gave the same bits."""
    step()
    with recording_fused() as calls:
        step()
    out = []
    for i, (args, k) in enumerate(calls["bounce_pre_bwd"]):
        spec, R = args[0], args[1].shape[0]
        again = kernel(*args)
        ms = kernel_ms(lambda: kernel(*args), "bounce_pre_bwd_kernel",
                       reps=20)
        n_bytes, n_ops = M.bwd_work("bounce_pre_bwd", spec, args[1:], k)
        bound_ms = M.bound(n_bytes, n_ops)[0]
        out.append(dict(
            call=i, R=R, nrx=spec.nrx, pc=k[3].shape[1], ms=ms,
            bound_ms=bound_ms, share=bound_ms / ms, bytes=n_bytes,
            digests={n: digest(torch, x) for n, x in zip(
                ("d_o", "d_d", "d_st", "d_pay", "d_rxp", "d_sc"), k)},
            same_bits_twice=all(torch.equal(a, b) for a, b in zip(k, again))))
    return out


def other_bwd_calls(torch, recording_fused, kernels, steps):
    """Kernels 13-16's recorded calls in each of ``steps`` (after a
    warm-up): per call the SHA-1 of its operands and of its outputs, and
    whether a second run gave the same bits."""
    out = {}
    for step_name, step in steps:
        step()
        with recording_fused() as calls:
            step()
        for name in OTHER_BWD:
            for i, (args, k) in enumerate(calls[name]):
                again = kernels[name](*args)
                out[f"{step_name} {name} {i}"] = dict(
                    operands=[digest(torch, x) for x in args],
                    outputs=[digest(torch, x) for x in k],
                    same_bits_twice=all(
                        a is None or torch.equal(a, b)
                        for a, b in zip(k, again)))
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
    query = profiled(run, 1)
    return dict(
        rays=R, live=int(per_block.sum()), T=tris.pad_triangles,
        operands=sorted(k for k in kw if kw[k] is not None),
        blocks_by_live=dict(zip(("0", "1-31", "32-255", "256"), bins)),
        brute_ms=kernel_ms(run_b, "nearest_hit_kernel"),
        culled_ms=kernel_ms(run_c, "nearest_hit_culled_kernel"),
        culled_skipped=int(skipped), culled_pairs=int(
            per_block.numel() * cull_kw["aabbs"].shape[0]),
        query_dtoh=sum(e.count for e in query.device if "DtoH" in e.key),
        query_syncs=sum(e.count for e in query.host
                        if "Synchronize" in e.key),
        query_ops=sum(e.count for e in query.device))


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
        rows = profiled(fn, 20).device
        out[name] = dict(call_ms=sum(M.event_ms(e) for e in rows) / 20,
                         call_ops=sum(e.count for e in rows) / 20)
    return out


def child(tree, steps):
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    import numpy as np

    import hermespy_rt_tpu_torch as pkg
    from hermespy_rt_tpu_torch import (TracerConfig, compute_paths,
                                       default_materials, trace)
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
    if steps in ("city", "all", "bwd"):
        city, city_paths = city_scene(dev)
        e_cfg = calibration_config(PATHS, BOUNCES, True, parity="physical")
        j_cfg = TracerConfig(num_paths=PATHS, num_bounces=BOUNCES,
                             parity="physical", launch_order="coherent",
                             keep_rays=False, shade="fused")

        def e_step():
            calibration_step(city, CITY_RX, CITY_TX, FREQ_GHZ,
                             default_materials(dev), e_cfg)

        def j_step():
            mats = default_materials(dev)
            leaves = [torch.tensor(x, device=dev, requires_grad=True)
                      for x in (CITY_RX, CITY_TX, FREQ_GHZ)]
            res = trace(city, leaves[0], leaves[1],
                        carrier_frequency=leaves[2], config=j_cfg,
                        materials=mats)
            ((res.scatter.a_te.abs().square().sum()
              + res.scatter.a_tm.abs().square().sum()) * 1e9).backward()
            torch.cuda.synchronize()

    if steps in ("city", "all"):
        timed += [("D", city_paths), ("E", e_step), ("J", j_step)]
    for name, step in timed:
        step()
        step()                                                  # warm-ups
        t0 = time.perf_counter()
        for _ in range(3):
            step()
        out[name] = dict(wall_mean_ms=(time.perf_counter() - t0) / 3 * 1e3,
                         profile=window(step))
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
    if steps == "bwd":
        from hermespy_rt_tpu_torch.testing import KERNELS, recording_fused

        i_cfg = calibration_config(PATHS, BOUNCES, True,
                                   unroll_bounces=False)
        g_steps = (("G", lambda: grad_step(g_cfg)),
                   ("G_nrx4", lambda: grad_step(g_cfg, rx_positions(4))),
                   ("J", j_step))
        out["bwd"] = {
            name: pre_bwd_calls(torch, recording_fused,
                                KERNELS["bounce_pre_bwd"], step)
            for name, step in g_steps}
        out["other_bwd"] = other_bwd_calls(
            torch, recording_fused, KERNELS,
            (*g_steps, ("7", lambda: fused_step(RX)),
             ("I", lambda: calibration_step(
                 tris, RX, TX, FREQ_GHZ, default_materials(dev), i_cfg))))
    from hermespy_rt_tpu_torch.ops._cuda_build import LIBRARY
    out["ptxas"] = {name: M.kernel_ptxas(LIBRARY.build_log, name)
                    for name in ("walk_prepass_kernel",
                                 "bounce_pre_bwd_kernel")}
    out["profiler"] = PROFILER
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
                    choices=("all", "canyon", "city", "queries", "bwd"))
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
                             "D", "E", "J") if k in mine[0]]
        for step in steps:
            keys = {k: (lambda r, k=k: r[step]["profile"][k])
                    for k in ("wall_ms", "device_busy_ms", "device_ops",
                              "idle_share")}
            keys["wall_mean_ms"] = lambda r: r[step]["wall_mean_ms"]
            for name in ("walk_kernel", "walk_prepass", "nearest_hit_kernel",
                         "nearest_hit_culled_kernel", "bounce_pre_bwd_kernel"):
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
                for k in ("walk_ms", "prepass_ms", "rows_ms", "sort_ms",
                          "prepass_cold_ms"):
                    row[k], spread[k] = stat(lambda r: r["walk"][q][k])
                summary[tree]["walk"].append(row)
                summary[tree]["spread"]["walk"].append(spread)
            # the prepass inside D's step against the seven standalone
            summary[tree]["prepass_settle"] = {
                k: sum(q[k] for q in summary[tree]["walk"])
                for k in ("prepass_ms", "rows_ms", "prepass_cold_ms",
                          "rows_ops")}
            if "D" in summary[tree]:
                summary[tree]["prepass_settle"]["in_step_D_ms"] = (
                    summary[tree]["D"]["walk_prepass_ms"])
        if "bwd" in mine[0]:
            summary[tree]["bwd"] = {}
            for step, calls in mine[0]["bwd"].items():
                summary[tree]["bwd"][step] = []
                for c in range(len(calls)):
                    row = dict(calls[c])
                    row["ms"], spread = stat(
                        lambda r: r["bwd"][step][c]["ms"])
                    row["ms_spread"] = spread
                    row["share"] = row["bound_ms"] / row["ms"]
                    row["digests_every_turn"] = all(
                        r["bwd"][step][c]["digests"] == calls[c]["digests"]
                        for r in mine)
                    summary[tree]["bwd"][step].append(row)
        summary[tree]["ptxas"] = mine[0]["ptxas"]
        summary[tree]["profiler"] = {
            k: sum(r.get("profiler", {}).get(k, 0) for r in mine)
            for k in ("windows", "taken_again", "missed")}
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
    with_bwd = [t for t in summary if "bwd" in summary[t]]
    if len(with_bwd) > 1:
        # kernel 12's per-ray outputs, and kernels 13-16's operands and
        # outputs: the same bits in every turn of every tree
        t0 = with_bwd[0]
        summary["bwd_per_ray_equal_across_trees"] = {
            step: [all(summary[t]["bwd"][step][c]["digests"][n]
                       == summary[t0]["bwd"][step][c]["digests"][n]
                       for t in with_bwd
                       for n in ("d_o", "d_d", "d_st", "d_pay"))
                   for c in range(len(calls))]
            for step, calls in summary[t0]["bwd"].items()}
        first = next(r for r in runs if r["tree"] == t0)["other_bwd"]
        summary["other_bwd_equal_across_trees"] = {
            call: {k: all(r["other_bwd"].get(call, {}).get(k) == d[k]
                          for r in runs)
                   for k in ("operands", "outputs")}
            for call, d in first.items()}
        summary["other_bwd_same_bits_twice"] = all(
            d["same_bits_twice"] for r in runs
            for d in r["other_bwd"].values())
    emit(json.dumps({"summary": summary}))
    emit(smi())


if __name__ == "__main__":
    main()
