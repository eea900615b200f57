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
  (``chip_smoke.py`` phases 3-4: ``compute_paths``, ``shade="xla"``, its
  default launch order, compact rays) at nrx = 1 and 4;
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

and the stage backwards (``bwd``): kernels 12 and 13, the full pre and
post backwards, their calls recorded in one step of G, of G at nrx = 4 and
of J, kernel 16, the whole-loop backward, its call in one step of phase 7
at nrx = 1 and 4, and kernel 14, the slim pre backward, its three calls in
one step of the slim per-stage form (``I``: ``unroll_bounces=False``; each
after a warm-up; ``I`` is also timed as a step): per call its rays, RX,
device time and its whole call's (profiler, 20 calls after a warm-up;
the call: the kernel and any device operation its wrapper adds), bound
(``measure.bwd_work``), share, and for kernel 16 both times again on a
300-row material table with ids drawn over all of it (``chip_smoke.py``
phase 8's case) and its live rays per bounce, with the share of live
lanes in the warps that hold one; the SHA-1 of each operand, of each
per-ray output (12: ``d_o``, ``d_d``, ``d_st``, ``d_pay``; 13: ``d_d2``,
``d_st2``, ``d_ex``, ``d_sh_d``, ``d_d2rx``, ``d_pay``, ``d_no``, ``occ``;
14: ``d_st``, ``d_eta``; 16: ``d_st0``) and of each sum across rays (12:
``d_rxp``, ``d_sc``; 13: ``d_sc``; 16: the ``[M, 12]`` table), whether a
second run gave the same bits, and whether the outputs are within their
tiers of the float64 plain version (the tree's ``testing.hold_*``); kernel
14 again on the card tests' seeded operand sets (``slim_cases``:
``measure.pre_bwd_slim_operands`` at 2^20 and 2^16 + 77 rays, every live
pattern; the SHA-1 of its outputs, the same bits twice, within its tier,
and at 2^20 rays its time, bound and share); and kernel 15 (the slim post
backward), its calls in ``I``, with the SHA-1 of their operands and
outputs and whether a second run gave the same bits.  The summary says,
per call and per seeded set, whether the operands and per-ray outputs (15:
every output) are the same bits in every turn of every tree.

``--steps`` picks ``canyon`` (phase9, N, 7, G, the single calls and the
queries), ``queries`` (the queries alone), ``city`` (D, E, J and the walk
queries), ``bwd`` (the stage backwards) or ``all`` (all but ``bwd``, the
default).  Every child also reports the registers and spills of the
prepass, the full pre, full post and whole-loop backwards and the slim pre
backward from its tree's build, and its profiler
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
         "bounce_pre_bwd_kernel", "bounce_post_bwd_kernel",
         "loop_bwd_slim_kernel", "bounce_pre_bwd_slim_kernel")
BLOCK_RAYS = 256       # rays per block of the nearest-hit kernels
L2_FLUSH_BYTES = 64 << 20   # more than the H100's 50 MB L2
# the timed backwards: kernels 12, 13, 14 and 16, their per-ray outputs (the
# same bits in every tree) and their sums across rays (within their tiers)
BWD_TIMED = {
    "bounce_pre_bwd": (("d_o", "d_d", "d_st", "d_pay"), ("d_rxp", "d_sc")),
    "bounce_post_bwd": (("d_d2", "d_st2", "d_ex", "d_sh_d", "d_d2rx", "d_pay",
                         "d_no", "occ"), ("d_sc",)),
    "loop_bwd_slim": (("d_st0",), ("d_tab",)),
    "bounce_pre_bwd_slim": (("d_st", "d_eta"), ())}
OTHER_BWD = ("bounce_post_bwd_slim",)                      # kernel 15
SLIM_RAYS = (1 << 20, (1 << 16) + 77)   # kernel 14's seeded operand sets


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


def bwd_calls(torch, testing, step, names, mats):
    """The recorded calls of the timed backward kernels ``names`` in one
    ``step`` (after a warm-up): per call its rays, RX, device time
    (profiler, 20 calls after a warm-up), bound, share, the SHA-1 of each
    operand, of each per-ray output and of each sum, whether a second run
    gave the same bits, and whether the outputs are within their tiers of
    the float64 plain version (the tree's ``testing.hold_*``; else the
    failure)."""
    holds = {"bounce_pre_bwd": testing.hold_pre_bwd,
             "bounce_post_bwd": testing.hold_post_bwd,
             "bounce_pre_bwd_slim": testing.hold_pre_bwd_slim,
             "loop_bwd_slim": lambda spec, rest, k, label: testing.hold_bwd(
                 spec, rest, k, mats, FREQ_GHZ, label)}
    step()
    with testing.recording_fused() as calls:
        step()
    out = {}
    for name in names:
        kernel, (per_ray, sums) = testing.KERNELS[name], BWD_TIMED[name]
        out[name] = []
        for i, (args, k) in enumerate(calls[name]):
            spec = args[0]
            again = kernel(*args)
            rows = profiled(lambda: kernel(*args), 20).device
            ms = sum(M.event_ms(e) for e in rows
                     if f"{name}_kernel" in e.key) / 20
            n_bytes, n_ops = M.bwd_work(name, spec, args[1:], k)
            bound_ms = M.bound(n_bytes, n_ops)[0]
            try:
                holds[name](spec, args[1:], k, f"{name} {i}")
                tier = True
            except AssertionError as e:
                tier = str(e)[:300]
            out[name].append(dict(
                call=i, R=(args[2].shape[-1] if name == "loop_bwd_slim"
                           else args[1].shape[-1] if "slim" in name
                           else args[1].shape[0]), nrx=spec.nrx, ms=ms,
                call_ms=sum(M.event_ms(e) for e in rows) / 20,
                **(materials_300(torch, testing, args, kernel)
                   if name == "loop_bwd_slim" else {}),
                bound_ms=bound_ms, share=bound_ms / ms, bytes=n_bytes,
                operands=[digest(torch, x) for x in args],
                digests={n: digest(torch, x)
                         for n, x in zip(per_ray + sums, k)},
                same_bits_twice=all(a is None or torch.equal(a, b)
                                    for a, b in zip(k, again)),
                within_tier=tier))
    return out


def materials_300(torch, testing, args, kernel):
    """The whole-loop backward on a recorded call's operands with a
    300-row material table and ids drawn over all of it (``chip_smoke.py``
    phase 8's case): its kernel's and its whole call's device time; and of
    the recorded call, the share of live rays at each bounce and the share
    of live lanes in the warps (32 consecutive rays) that hold one."""
    import numpy as np

    from hermespy_rt_tpu_torch.ops.fresnel import ETA_FIELDS, precompute_eta

    rng = np.random.default_rng(args[0].nrx)
    eta = precompute_eta(testing.material_table(300, rng, args[1].device),
                         FREQ_GHZ)
    rest = list(args)
    rest[1] = torch.stack([getattr(eta, f) for f in ETA_FIELDS],
                          dim=-1).detach()
    rest[4] = torch.as_tensor(rng.integers(0, 300, rest[4].shape),
                              dtype=torch.int32, device=rest[4].device)
    rows = profiled(lambda: kernel(*rest), 20).device
    live = args[3][:, :args[3].shape[1] // 32 * 32].reshape(
        args[3].shape[0], -1, 32)
    warps = live.any(-1)
    return dict(ms_300=sum(M.event_ms(e) for e in rows
                           if "loop_bwd_slim_kernel" in e.key) / 20,
                call_ms_300=sum(M.event_ms(e) for e in rows) / 20,
                live_share=(live.float().mean((1, 2))).tolist(),
                live_lanes_in_live_warps=[
                    float(live[b][warps[b]].float().mean())
                    for b in range(live.shape[0])])


def slim_cases(torch, testing, kernel, dev):
    """Kernel 14 on the seeded operand sets of the card tests
    (``measure.pre_bwd_slim_operands`` on a 256-row table with the eta rows
    of a seeded 300-row material table; :data:`SLIM_RAYS` rays, each live
    pattern): per set the SHA-1 of each output, whether a second run gave
    the same bits, whether the outputs are within their tiers (the tree's
    ``testing.hold_pre_bwd_slim``) and, at 2^20 rays, the device time
    (profiler, 20 calls after a warm-up), bound and share."""
    import numpy as np

    from hermespy_rt_tpu_torch.ops.bounce_fused import FusedSpec
    from hermespy_rt_tpu_torch.ops.fresnel import ETA_FIELDS, precompute_eta

    rng = np.random.default_rng(0)
    eta = precompute_eta(testing.material_table(300, rng, dev), FREQ_GHZ)
    eta_tab = torch.stack([getattr(eta, f) for f in ETA_FIELDS],
                          dim=-1).detach()
    ids = torch.as_tensor(rng.integers(0, 300, 256), device=dev)
    geo = torch.as_tensor(rng.normal(size=(256, 15)).astype(np.float32),
                          device=dev)
    table = torch.cat([geo, eta_tab[ids]], dim=-1).contiguous()
    spec = FusedSpec(nrx=1, grad_positions=False, grad_geometry=False)
    out = {}
    for R in SLIM_RAYS:
        for live in M.SLIM_LIVE:
            ops = M.pre_bwd_slim_operands(R, live, table, seed=R)
            k = kernel(spec, *ops)
            again = kernel(spec, *ops)
            try:
                testing.hold_pre_bwd_slim(spec, ops, k, f"{R} {live}")
                tier = True
            except AssertionError as e:
                tier = str(e)[:300]
            row = out[f"{R} {live}"] = dict(
                outputs=[digest(torch, x) for x in k],
                same_bits_twice=all(torch.equal(a, b)
                                    for a, b in zip(k, again)),
                within_tier=tier)
            if R == SLIM_RAYS[0]:
                rows = profiled(lambda: kernel(spec, *ops), 20).device
                row["ms"] = sum(M.event_ms(e) for e in rows
                                if "bounce_pre_bwd_slim_kernel" in e.key) / 20
                row["bound_ms"] = M.bound(*M.bwd_work(
                    "bounce_pre_bwd_slim", spec, ops, list(k)))[0]
                row["share"] = row["bound_ms"] / row["ms"]
    return out


def other_bwd_calls(torch, recording_fused, kernels, steps):
    """Kernel 15's recorded calls in each of ``steps`` (after a
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
                      compact_rays=True, shade="xla")
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

    i_cfg = calibration_config(PATHS, BOUNCES, True, unroll_bounces=False)

    def i_step():
        calibration_step(tris, RX, TX, FREQ_GHZ, default_materials(dev),
                         i_cfg)

    if steps in ("city", "all"):
        timed += [("D", city_paths), ("E", e_step), ("J", j_step)]
    if steps == "bwd":
        timed.append(("I", i_step))
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
        from hermespy_rt_tpu_torch import testing

        mats = default_materials(dev)
        out["bwd"] = {
            name: bwd_calls(torch, testing, step, names, mats)
            for name, step, names in (
                ("G", lambda: grad_step(g_cfg),
                 ("bounce_pre_bwd", "bounce_post_bwd")),
                ("G_nrx4", lambda: grad_step(g_cfg, rx_positions(4)),
                 ("bounce_pre_bwd", "bounce_post_bwd")),
                ("J", j_step, ("bounce_pre_bwd", "bounce_post_bwd")),
                ("7", lambda: fused_step(RX), ("loop_bwd_slim",)),
                ("7_nrx4", lambda: fused_step(rx_positions(4)),
                 ("loop_bwd_slim",)),
                ("I", i_step, ("bounce_pre_bwd_slim",)))}
        out["slim_cases"] = slim_cases(
            torch, testing, testing.KERNELS["bounce_pre_bwd_slim"], dev)
        out["other_bwd"] = other_bwd_calls(
            torch, testing.recording_fused, testing.KERNELS,
            (("I", i_step),))
    from hermespy_rt_tpu_torch.ops._cuda_build import LIBRARY
    out["ptxas"] = {name: M.kernel_ptxas(LIBRARY.build_log, name)
                    for name in ("walk_prepass_kernel",
                                 "bounce_pre_bwd_kernel",
                                 "bounce_post_bwd_kernel",
                                 "loop_bwd_slim_kernel",
                                 "bounce_pre_bwd_slim_kernel")}
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
                             "D", "E", "J", "I") if k in mine[0]]
        for step in steps:
            keys = {k: (lambda r, k=k: r[step]["profile"][k])
                    for k in ("wall_ms", "device_busy_ms", "device_ops",
                              "idle_share")}
            keys["wall_mean_ms"] = lambda r: r[step]["wall_mean_ms"]
            for name in ("walk_kernel", "walk_prepass", "nearest_hit_kernel",
                         "nearest_hit_culled_kernel", "bounce_pre_bwd_kernel",
                         "bounce_post_bwd_kernel", "loop_bwd_slim_kernel",
                         "bounce_pre_bwd_slim_kernel"):
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
            for step, kernels in mine[0]["bwd"].items():
                summary[tree]["bwd"][step] = {}
                for name, calls in kernels.items():
                    rows = summary[tree]["bwd"][step][name] = []
                    per_ray = BWD_TIMED[name][0]
                    for c in range(len(calls)):
                        row = {k: v for k, v in calls[c].items()
                               if k != "operands"}
                        for key in ("ms", "call_ms", "ms_300",
                                    "call_ms_300"):
                            if key in calls[c]:
                                row[key], row[f"{key}_spread"] = stat(
                                    lambda r, key=key:
                                    r["bwd"][step][name][c][key])
                        row["share"] = row["bound_ms"] / row["ms"]
                        turns = [r["bwd"][step][name][c] for r in mine]
                        row["per_ray_every_turn"] = all(
                            t["digests"][n] == calls[c]["digests"][n]
                            for t in turns for n in per_ray)
                        row["same_bits_twice"] = all(
                            t["same_bits_twice"] for t in turns)
                        row["within_tier"] = all(
                            t["within_tier"] is True for t in turns)
                        rows.append(row)
        if "slim_cases" in mine[0]:
            summary[tree]["slim_cases"] = {}
            for case, row in mine[0]["slim_cases"].items():
                turns = [r["slim_cases"][case] for r in mine]
                row = {k: v for k, v in row.items() if k != "outputs"}
                if "ms" in row:
                    row["ms"], row["ms_spread"] = stat(
                        lambda r, c=case: r["slim_cases"][c]["ms"])
                    row["share"] = row["bound_ms"] / row["ms"]
                row["same_bits_twice"] = all(t["same_bits_twice"]
                                             for t in turns)
                row["within_tier"] = all(t["within_tier"] is True
                                         for t in turns)
                summary[tree]["slim_cases"][case] = row
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
        # the timed kernels' operands and per-ray outputs, and kernels 14
        # and 15's operands and outputs: the same bits in every turn of
        # every tree (the sums: within their tiers, the same bits twice)
        bwd_runs = [r for r in runs if "bwd" in r]
        summary["bwd_equal_across_trees"] = {
            f"{step} {name} {c}": {
                "operands": all(r["bwd"][step][name][c]["operands"]
                                == call["operands"] for r in bwd_runs),
                "per_ray": all(r["bwd"][step][name][c]["digests"][n]
                               == call["digests"][n] for r in bwd_runs
                               for n in BWD_TIMED[name][0])}
            for step, kernels in bwd_runs[0]["bwd"].items()
            for name, calls in kernels.items()
            for c, call in enumerate(calls)}
        summary["slim_cases_equal_across_trees"] = {
            case: all(r["slim_cases"][case]["outputs"] == d["outputs"]
                      for r in bwd_runs)
            for case, d in bwd_runs[0]["slim_cases"].items()}
        first = bwd_runs[0]["other_bwd"]
        summary["other_bwd_equal_across_trees"] = {
            call: {k: all(r["other_bwd"].get(call, {}).get(k) == d[k]
                          for r in bwd_runs)
                   for k in ("operands", "outputs")}
            for call, d in first.items()}
        summary["other_bwd_same_bits_twice"] = all(
            d["same_bits_twice"] for r in bwd_runs
            for d in r["other_bwd"].values())
    emit(json.dumps({"summary": summary}))
    emit(smi())


if __name__ == "__main__":
    main()
