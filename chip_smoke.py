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
               masks.  Every ray's (t, idx) must be the twin's bits.
3. trace    -- the op path (``shade="xla"``), forward only:
               ``compute_paths`` at 2^20 paths, 3 bounces, reference parity,
               nrx = 1 and 4, through the kernel: its launch count, finite
               outputs, a written scatter; at 2^16 paths the same trace with
               the plain twin must agree; forward queries/s of both.  Every
               kernel query of the two 2^20-path traces is recorded.
4. path     -- each recorded query re-run through the twin and held to its
               bits, with its kernel time and its blocks of 256 rays by
               live rays (0, 1-31, 32-255, 256); then the kernel's and the
               twin's time on the recorded nrx = 4 bounce and shadow
               queries.
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

The large-scene path, on the config-5 city (``scene.make_city``: 131,072
triangles, written as a Sionna XML + PLY scene, read back by
``load_scene``, Morton-sorted), TX (-120, 80, 45), RX (30, -40, 1.5) +
k (1.5, -2, 0.25), 3 GHz, B = 3, physical parity, coherent launch order,
compact rays; every query goes through the visit-list walk (the prepass
kernel, which writes the visit rows, then the walk kernel):

A. city       -- write, read and flatten the city: triangles, host seconds,
                 fine tiles and coarse boxes, the materials in use.
B. walk       -- record the queries of one 2^20-path forward (nrx = 1) and
                 its launches; per query the prepass kernel's visit rows
                 equal to the plain version's (``visit_rows`` of
                 ``prepass_plain``) and to a second run's, the walk
                 kernel against its plain version on every ray (the same
                 bits; the same bits again in a second run) and against the
                 brute kernel on every ray (nearest mode: every flip an f64
                 edge/tie case, counted; any-hit mode: `blocked` equal, each
                 reported hit a valid hit within its limit); visit-list
                 lengths, live rays, listed and block-reached fine tiles,
                 the bound's ray-reached pairs and the contract's pairs
                 (live rays x block-reached tiles x block_tris) with the
                 time they bound; device times of prepass and walk, their
                 plain versions' and their bounds (the prepass's over the
                 pairs its per-tile prune keeps, ``prepass_kept_plain``,
                 which must keep every reached box, and the prune's tests;
                 beside it over all live pairs at the f32 rate and at the
                 half rate that operations without FMA reach, with its
                 live ray tiles); both kernels' registers and spills from
                 the build.
C. city_equal -- a 14,336-triangle city at 2^14 paths: walk=True against
                 walk=False and against the culled query (walk=False,
                 cull=True), both parities, nrx = 1 and 4, every output equal
                 bit for bit; with M's city part (below).
D. city_fwd   -- ``compute_paths`` on the city at 2^20 paths, nrx = 1: mean
                 of 3 after a warm-up, queries/s, launches, one profiler
                 window; then once with ``walk=False`` (the brute kernel),
                 every scatter output equal to the walk's.
E. city_train -- the calibration step (``shade="fused", grad_positions=
                 False``) on the city at 2^20 paths, nrx = 1 and 4: launches
                 of one step, forward+backward mean of 3, material gradients
                 finite and nonzero; at 2^16 paths the fused step against
                 the op path (slots agree, gradients within their tier).
F. city_loss  -- ``benchmarks/config5_e2e.py``'s loss once through the op
                 path (its fetches the row-gather kernel, their backward the
                 scatter-add): gradients to the materials and the TX
                 position, finite and nonzero; wall, device busy, PyTorch's
                 indexing backward left; its gathers recorded for K, its
                 scatter-adds held as in H and the busiest on the sorted
                 route (the 131,072-row table) timed.

The full-gradient fused path (``trace(shade="fused")`` with the JAX
defaults ``grad_positions=True, grad_geometry=True``: per-stage backward
kernels and the table scatter-add):

G. grad_step  -- the canyon stand-in at 2^20 paths, B = 3, reference
                 parity, nrx = 1 and 4, tests/test_bounce_fused.py's loss,
                 backward to the materials, the RX and TX positions, the
                 frequency and the vertices: launches of one step (recorded),
                 forward+backward mean of 3 after a warm-up, one profiler
                 window; at 2^16 paths every gradient against the op path's.
H. bwd_kernel -- every recorded call of the full backwards and the
                 scatter-add held against its plain version in float64 (tier
                 and ulp gaps per row), run twice to the same bits, each
                 scatter-add on its dense route (``ops/fetch.py::
                 scatter_route``) also equal bit for bit to
                 ``scatter_add_ordered_plain``; device time (profiler and
                 CUDA events), plain time, bound; the scatter-add's first
                 and busiest calls with the whole call's device time and
                 operations and ``index_add_``'s time (on the kept rows, and
                 on all rows with the dropped ones zeroed); each timed
                 kernel's share of its bound, registers and spills.
I. slim_stages -- ``unroll_bounces=False`` (the slim per-stage backwards) at
                 2^20 paths, nrx = 1: launches, the two slim kernels and the
                 scatter-add held and timed the same way, the material
                 gradients against the whole-loop backward's.  Then a turn
                 with a 5,000-row material table (ids over all of it) under
                 the default ``unroll_bounces``: past ``MAX_MATERIALS``
                 (4842) the step takes the per-stage nodes (launches:
                 loop_bwd_slim 0, the slim backwards 3 each), its calls
                 held the same way; at 2^16 paths its material gradients
                 (nonzero past row 4842) against the op path's.
J. city_grad  -- ``config5_e2e.py``'s loss through the full-gradient fused
                 path on the city at 2^20 paths, nrx = 1: gradients to the
                 materials and the TX position, finite, nonzero and within
                 their tier of phase F's; wall, device busy, idle share,
                 launches; its full pre backward calls (kernel 12) held as
                 in H, each with its device time, bound and share, and the
                 kernel's registers and spills.

The op path with every kernel (``trace(shade="pallas", cull=True,
compact_rays=True)``: the culled query, the row gather with the scatter-add
as its backward, the reflection-half shading), after phase I:

N. pallas_step -- the canyon stand-in at 2^20 paths, B = 3, with every
                 gradient (G's loss), nrx = 1 and 4 under reference parity
                 and nrx = 1 under physical parity: launches of one step
                 (counts zeroed just before, read just after; its kernel
                 calls recorded), the same step of the default op path
                 (``shade="xla"``, brute query) beside it: every gradient
                 within 1e-4 of each leaf's max, scatter slots agree;
                 forward+backward of both in turns, a profiler window each
                 (device busy, operations, idle share, PyTorch's indexing
                 backward left).
K. gather     -- every recorded gather of N (and of F on the city) equal to
                 ``table[idx]`` bit for bit; the first payload fetch (2^20
                 ids, 27 columns) timed against its plain version and
                 ``torch.index_select``, with its bound, on the canyon's
                 256-row (staged in shared memory) and the city's
                 131,072-row table; then every recorded scatter-add of N
                 held as in H and the busiest (an all-kept 2^20-row
                 backward of a fetch, dense route) timed as in H.
L. shade      -- every recorded shading call of N against its plain
                 version: a dead ray's state bit for bit, values within
                 their tier (ulp gaps); the first call timed and bounded.
M. culled     -- every recorded culled query of N (LoS, bounce, shadow;
                 nrx 1 and 4) and of C: the same bits and skip count as the
                 plain culled scan (``ops/walk.py::culled_reach_plain``),
                 decisions against the brute kernel (each flip an f64 edge
                 or tie case, counted); the bounce and the 4 x 2^20-ray
                 shadow query and C's city bounce query timed against the
                 brute kernel and the plain version, with their bounds.

The transmission modes and the models (steps with a gradient run the op
path, and ``shade="fused"`` warns and runs it, as in the JAX package; the
no-gradient coverage map runs the fused forward), after phase M and phase
J:

O. transmission -- the canyon stand-in at 2^20 paths, B = 3, physical
                 parity, nrx 1 and 4, bench.py's step (loss to the material
                 table) in seven turns: the physical step without
                 transmission, then ``transmission=True`` with
                 ``shade="xla"`` and ``"pallas"``, ``spawn_transmission``
                 with ``refraction="straight"`` and ``"snell"``
                 (``shade="pallas"``, which spawning runs as torch ops),
                 ``shade="fused"`` under ``transmission`` (its warning; its
                 outputs and gradients the xla turn's bits) and ``cull=True``.
                 Each: launches of one step (counts zeroed just before, read
                 just after) against ``testing.transmission_launches``,
                 every recorded kernel call held as phases 4, K, L and M
                 hold theirs (the brute and culled queries, among them the
                 nearest-blocker shadow queries, the blockers' row gathers
                 and their scatter-adds over nrx x 2^20 rows, the shading);
                 forward and step walls (mean of 3 after a warm-up, with
                 min and max), a profiler window (busy, operations, idle
                 share, per-kernel time and launches); at 2^16 paths the
                 step against ``backend="torch"`` (slots agree, gradients
                 within the op path's tier).  Then the transmission step's
                 ratio to the physical step.
P. transmission_city -- ``transmission=True`` on the config-5 city at 2^20
                 paths, nrx 1: every query walks, the shadow queries with
                 any-hit off; each walk query held (prepass rows, the plain
                 walk's bits, the brute kernel's decisions), each gather and
                 scatter-add held; launches, walls, a profiler window; the
                 physical step without transmission beside it (its launches,
                 walls, window) and the ratios of wall, busy and walk time.
Q. models     -- ``coverage_map`` under ``transmission`` on the canyon
                 stand-in at the JAX defaults (4096 paths, B = 3, 256-probe
                 batches) over x, y in [-60, 60] at 2 m, 1.5 m high (3,721
                 probes, 15 batches): every cell finite, both LoS verdicts,
                 the first batch against ``trace`` + ``path_gain_db`` and its
                 trace against the plain query's; a third map's launches
                 (45 ``bounce_pre``, 45 ``bounce_post``) and every call of
                 its fused forward (``transmission`` alone: pre ``<0>``,
                 post ``<1>``) held against its plain version (equal
                 decisions, values within ``ROW_RTOL``); ``run_sweep`` over the same
                 probes into a temporary directory (15 chunks, a resume 0, 1
                 after one chunk file is removed, the chunks' power the map's
                 gain); seconds and probes a second of each.

R. sharded   -- two ranks share the card over gloo, each a process of
                 this script (``--sharded-rank``) that imports the port
                 only; the kernels are built before they start.  R1 (rays 2
                 x tris 1): bench.py's step on the canyon stand-in at 2^20
                 paths, B = 3, nrx 1 and 4, ``shade="fused"``: each rank's
                 launches (#1 7, #10 3, #11 3, #16 1), the gathered outputs
                 the single-process step's bits, material gradients within
                 rtol 1e-5.  R2 (rays 1 x tris 2): the config-5 city, each
                 rank walking a 65,536-triangle slab, physical parity, 2^20
                 paths, nrx 1, the op-path forward: launches the single
                 process's (#6 and #4/#5 7 each), every query's hits after
                 the lexicographic minimum the single process's, outputs
                 within the op path's tier; one backward step per payload
                 table mode (replicated, masked), gradients within rtol
                 1e-4, every scatter-add held.  Walls (mean of 3 after a
                 warm-up, min, max) and seconds in collectives: the ranks
                 share one card, so these show the collectives' cost, not
                 scaling.
S. aux        -- ``save_hrt`` -> ``load_hrt`` of the canyon stand-in;
                 ``hrt-torch-trace`` on it with ``--device cuda --metrics``
                 (queries a second; its npz ``api.trace``'s arrays, bit for
                 bit); the native reader and writer against the Python ones
                 where ``g++`` builds them, else a printed skip of that part.
T. bench      -- the step ``hrt-torch-bench`` times (``hermespy_rt_tpu_torch/
                 bench.py``: bench.py's workload and flags on the port).
                 T1: ``bench_main([])`` at its defaults (2^21 paths, B = 3,
                 nrx 1), its line with queries 3 x 2^21 x 2 and a finite,
                 positive rate.  T2: ``bench.measure`` at 2^20 paths for nrx
                 1, 4 and 16 (8, 4 and 4 steps, as bench.py runs them), both
                 shades in turns (bench.py's choice, the other, the other,
                 the choice, twice): the walls' mean, min and max and the
                 queries a second; for each (nrx, shade) one step's launches
                 (counts zeroed just before, read just after) against
                 ``testing.calibration_launches``, its loss and material
                 gradients finite and not all zero, its peak device memory,
                 and one profiler window over one step (busy, device
                 operations, idle share, per-kernel time).  At nrx 16 and
                 2^16 paths the fused gradients against the op path's
                 (``PATH_GRAD_RTOL``) and the scatter slots alike, as phase 7
                 holds them at nrx 1 and 4.
U. o2i        -- the O2I cell's drop (``umi_o2i131k.fwd.nrx5``: the
                 benchmark's 131,072-triangle box city, 2^20 paths, B = 3,
                 5 RX from its drawer, 4 indoor) on the fused forward under
                 each transmission mode it takes: both (the cell's; pre
                 ``<2>``, post ``<3>``), ``transmission`` alone (``<0>``,
                 ``<1>``) and ``spawn_transmission`` alone (``<2>``,
                 ``<2>``).  Each: one drop's launches (counts zeroed just
                 before, read just after), every ``bounce_pre`` /
                 ``bounce_post`` call held against its plain version (equal
                 decisions, values within ``ROW_RTOL``), then timed
                 (profiler) against its bound, with its live rays, written
                 pairs and ptxas line.  The kernel summary's fused rows
                 carry these launches, errors and times.

Then the profiler's windows (each opened on a warm-up cycle and taken
again while it misses launches; every device time is a window's sum over
its calls) and the launches they still missed, the kernel summary, the
card's name and power limit, and the result line.  Without a CUDA device
it exits non-zero and prints no result.
"""
import contextlib
import dataclasses
import datetime
import importlib.util
import io
import json
import math
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
import types
import warnings

import numpy as np
import torch
import torch.distributed as dist

from hermespy_rt_tpu_torch import (TracerConfig, compute_paths,
                                   default_materials, trace)
from hermespy_rt_tpu_torch import bench
from hermespy_rt_tpu_torch import tracer as tracer_module
from hermespy_rt_tpu_torch.materials import MATERIAL_FIELDS, MATERIAL_NAMES
from hermespy_rt_tpu_torch.models import (SweepConfig, coverage_map,
                                          load_sweep_results, path_gain_db,
                                          run_sweep)
from hermespy_rt_tpu_torch.measure import (
    F32_OPS_PER_S, NEAREST_HIT_OPS_PER_PAIR, POST_OPS_PER_RX, PRE_OPS_PER_RAY,
    PRE_OPS_PER_RX, SLAB_OPS, bound, bwd_work, event_ms, kernel_ptxas, nbytes,
    prepass_bounds, profiled)
from hermespy_rt_tpu_torch.ops import bounce_fused_cuda as fused_ops
from hermespy_rt_tpu_torch.ops import fetch_cuda, shade_cuda, walk_cuda
from hermespy_rt_tpu_torch.ops._cuda_build import BUILD_DIR, LIBRARY
from hermespy_rt_tpu_torch.ops.fresnel import ETA_FIELDS, precompute_eta
from hermespy_rt_tpu_torch.ops.geometry import fibonacci_sphere
from hermespy_rt_tpu_torch.ops.intersect import intersect_torch, mt_hit
from hermespy_rt_tpu_torch.ops.fetch import gather_plain
from hermespy_rt_tpu_torch.ops.intersect_cuda import (SOURCE, nearest_hit,
                                                      nearest_hit_culled)
from hermespy_rt_tpu_torch.ops.shade import shade_a_plain
from hermespy_rt_tpu_torch.parallel import (TriShardedSceneAccess,
                                            default_mesh,
                                            initialize_distributed,
                                            trace_paths_sharded)
from hermespy_rt_tpu_torch.parallel.sharding import (COLLECTIVES,
                                                     collective_route,
                                                     reset_collectives)
from hermespy_rt_tpu_torch.ops.walk import (CULL_BLOCK_RAYS, CULL_BLOCK_TRIS,
                                            prepare_walk, prepass_kept_plain,
                                            prepass_plain, query_limits,
                                            visit_rows, walk_plain)
from hermespy_rt_tpu_torch.scene import (box_scene, flatten_scene, load_hrt,
                                         load_scene, make_city,
                                         random_soup_scene)
from hermespy_rt_tpu_torch.scene.model import TriangleSoA
from hermespy_rt_tpu_torch.tracer import launch_directions, trace_paths
from hermespy_rt_tpu_torch.testing import (
    FUSED, KERNELS, LEAF_ATOL, LEAF_RTOL, OUTPUT_FIELDS, PATH_GRAD_RTOL,
    PLAIN, STAGE_BWD, CheckFailure, check, calibration_config,
    calibration_launches, calibration_step, grad_loss, grads_of, hold_bwd, hold_culled,
    hold_gather, hold_post, hold_post_bwd, hold_post_bwd_slim, hold_pre,
    hold_pre_bwd, hold_pre_bwd_slim, hold_scatter_add, hold_shade,
    leaves_close, material_table, recording_fused, slots_agree,
    transmission_config, transmission_launches)

REPO = os.path.dirname(os.path.abspath(__file__))
CANYON = os.path.join(REPO, "scenes", "simple_street_canyon_with_cars.hrt")
TX = [[-20.0, -10.0, 10.0]]
FREQ_GHZ = 3.0
BOUNCES = 3
PATHS = 1 << 20          # main-path paths per trace
SMALL_PATHS = 1 << 16    # paths of the kernel-vs-twin trace and the backward
KERNEL_RAYS = 1 << 18    # rays per kernel-vs-twin query
TWIN_CHUNK = 1 << 15     # ray chunk of the plain twin on the card

# The card's peak rates, the kernels' f32 operation counts and the bounds
# they give are in hermespy_rt_tpu_torch/measure.py.
CITY = {}                  # make_city's defaults: 131,072 triangles
CITY_TRIANGLES = 131072
CITY_TX = [[-120.0, 80.0, 45.0]]
CITY_RX0 = [30.0, -40.0, 1.5]
# phase C's smaller city has wider blocks: these stand in its streets
SMALL_CITY_TX = [[0.0, 120.0, 30.0]]
SMALL_CITY_RX0 = [10.0, -20.0, 1.5]
# The tolerances of the kernels against their plain versions, with their
# reasons, are in hermespy_rt_tpu_torch/testing.py.
REPLACES = {"nearest_hit": "hermespy_rt_tpu/ops/intersect_pallas.py:369",
            "walk_prepass": "hermespy_rt_tpu/ops/intersect_pallas.py:699",
            "walk": "hermespy_rt_tpu/ops/intersect_pallas.py:552",
            "bounce_pre": "hermespy_rt_tpu/ops/bounce_fused.py:344",
            "bounce_post": "hermespy_rt_tpu/ops/bounce_fused.py:684",
            "loop_bwd_slim": "hermespy_rt_tpu/ops/bounce_fused.py:1170",
            "bounce_pre_bwd": "hermespy_rt_tpu/ops/bounce_fused.py:461",
            "bounce_post_bwd": "hermespy_rt_tpu/ops/bounce_fused.py:716",
            "bounce_pre_bwd_slim": "hermespy_rt_tpu/ops/bounce_fused.py:426",
            "bounce_post_bwd_slim": "hermespy_rt_tpu/ops/bounce_fused.py:655",
            "scatter_add": "hermespy_rt_tpu/ops/fetch_pallas.py:82",
            "nearest_hit_culled":
                "hermespy_rt_tpu/ops/intersect_pallas.py:421",
            "gather": "hermespy_rt_tpu/ops/fetch_pallas.py:59",
            "shade_a": "hermespy_rt_tpu/ops/shade.py:159"}


def emit(**kw):
    print(json.dumps(kw), flush=True)


def rx_positions(nrx, rx0=(10.0, 5.0, 2.0)):
    k = np.arange(nrx, dtype=np.float32)[:, None]
    return (np.array([rx0], np.float32)
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


PROFILER = dict(windows=0, taken_again=0, missed=0, windows_with_misses=[],
                event_timed=[])


def device_window(fn, reps, label):
    """A profiler window over ``reps`` calls of ``fn``
    (``measure.profiled``: warm, opened on a warm-up cycle, taken again
    while it misses launches), the kernel wrappers' launch counts checked
    against its device rows.  Every window is counted in :data:`PROFILER`,
    and one that still missed launches is listed there under ``label``."""
    w = profiled(fn, reps, read_counts)
    PROFILER["windows"] += 1
    PROFILER["taken_again"] += w.tries > 1
    if w.missed:
        PROFILER["missed"] += w.missed
        PROFILER["windows_with_misses"].append([label, reps, w.missed,
                                                w.odd[:4]])
    return w


def device_ms(fn, reps, kernel=None):
    """Device time in ms per call of ``fn``: the own times of the device
    events (torch.profiler) of ``reps`` calls, only those of ``kernel`` when
    it is named, over ``reps``.  Unlike :func:`time_pair` it leaves out the
    host's gaps between launches.  Where every window the profiler took
    still missed launches, or recorded none of what is measured, the time
    is :func:`cuda_ms`'s (CUDA events around the calls, host gaps
    included) and the label is listed in ``PROFILER["event_timed"]``."""
    label = kernel or "whole call"
    w = device_window(fn, reps, label)
    ms = sum(event_ms(e) for e in w.device
             if kernel is None or f"{kernel}_kernel" in e.key) / reps
    if w.missed or not ms > 0:
        PROFILER["event_timed"].append(label)
        return cuda_ms(fn, reps)
    return ms


def call_profile(fn, reps):
    """A whole call of ``fn`` on the device: its device time in ms, its
    device operations and their names (every device event of the call)."""
    ev = device_window(fn, reps, "whole call").device
    return (sum(event_ms(e) for e in ev) / reps,
            sum(e.count for e in ev) / reps,
            sorted({e.key[:60] for e in ev}))


def flips_check():
    """tests/utils.py::assert_flips_explained, loaded by file path: an
    installed package named `tests` would shadow the repo's tests/ directory,
    which has no __init__.py."""
    spec = importlib.util.spec_from_file_location(
        "_smoke_test_utils", os.path.join(REPO, "tests", "utils.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.assert_flips_explained


def plain_kw(kw):
    """A query's operands for the plain twin: without the kernels' triangle
    records and tile boxes."""
    return {k: v for k, v in kw.items() if k not in ("records", "aabbs")}


def blocks_by_live(o, kw):
    """How many blocks of 256 rays hold 0, 1-31, 32-255 and 256 live rays
    (live set and a limit >= 0)."""
    lim = query_limits(o.shape[0], CULL_BLOCK_RAYS, t_max=kw.get("t_max"),
                       live=kw.get("live"), device=o.device)
    n = (lim >= 0).reshape(-1, CULL_BLOCK_RAYS).sum(1)
    return {"0": int((n == 0).sum()), "1-31": int(((n > 0) & (n < 32)).sum()),
            "32-255": int(((n >= 32) & (n < CULL_BLOCK_RAYS)).sum()),
            "256": int((n == CULL_BLOCK_RAYS).sum())}


def hold_against_twin(tris, o, d, kw, t_k, i_k, label):
    """Hold the kernel's answer ``(t_k, i_k)`` to query ``(o, d, **kw)``
    against the plain twin on the same inputs: the same bits, dead rays
    missing and no ray hitting its excluded triangle.  Returns ``(flips,
    max_abs_err, hits)`` (0 flips and 0 error once the bits agree)."""
    t_p, i_p = intersect_torch(o, d, tris, chunk_size=TWIN_CHUNK,
                               **plain_kw(kw))
    flips = int((i_k != i_p).sum())
    check(flips == 0 and torch.equal(t_k.view(torch.int32),
                                     t_p.view(torch.int32)),
          f"{label}: the kernel's (t, idx) are not the twin's bits "
          f"({flips} index flips)")
    if kw.get("live") is not None:
        check(bool((i_k[~kw["live"]] == -1).all()), f"{label}: a dead ray hit")
    if kw.get("exclude") is not None:
        ex = kw["exclude"]
        check(not bool(((ex >= 0) & (i_k == ex)).any()),
              f"{label}: a ray hit its excluded triangle")
    return flips, 0.0, int((i_k >= 0).sum())


class QueryRecorder:
    """Stands in for the kernel's wrapper inside the tracer for one trace:
    forwards every query to :data:`nearest_hit` (which counts the launch)
    and keeps the query's inputs (the scene's triangle records among its
    operands) and the kernel's answer."""

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
    """``compute_paths`` as bench.py drives it, on the op path
    (``shade="xla"``; the default runs the fused forward on a card)."""
    los, sc = compute_paths(host, rx_positions(nrx), TX, np.zeros((nrx, 3)),
                            np.zeros((1, 3)), FREQ_GHZ, nrx, 1, paths,
                            BOUNCES, device=dev, parity="reference",
                            backend=backend, keep_rays=False,
                            compact_rays=True, **{"shade": "xla", **kw})
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
    """The recorded main-path queries against the twin (each with its
    kernel time and its blocks by live rays), then the kernel's and the
    twin's time on the nrx = 4 trace's first bounce query (2^20 rays) and
    its shadow query (4 x 2^20 rays)."""
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
                     k for k, v in plain_kw(kw).items() if v is not None),
                 live=None if live is None else int(live.sum()),
                 blocks_by_live=blocks_by_live(o, kw),
                 ms=device_ms(lambda: nearest_hit(  # noqa: B023
                     o, d, tris, **kw), 5, "nearest_hit"),
                 hits=hits, flips=flips, bit_equal=True, max_abs_err=err)

    timing = {}
    queries = recorded[4]
    for label, q in (("bounce_2^20", queries[1]),
                     ("shadow_4x2^20", queries[2])):
        o, d, tris, kw, _, _ = q
        check(o.shape[0] == (PATHS if label.startswith("bounce")
                             else 4 * PATHS), f"{label}: {o.shape[0]} rays")
        run_k = lambda: nearest_hit(o, d, tris, **kw)  # noqa: E731
        run_p = lambda: intersect_torch(o, d, tris,  # noqa: E731
                                        chunk_size=TWIN_CHUNK,
                                        **plain_kw(kw))
        wall_ms, plain_wall_ms = time_pair(run_k, run_p)
        ms = device_ms(run_k, 20, "nearest_hit")
        plain_ms = device_ms(run_p, 3)
        live = kw.get("live")
        n_live = o.shape[0] if live is None else int(live.sum())
        t_k, i_k = q[4], q[5]
        bound_ms, bound_by = bound(
            nbytes(o, d, *plain_kw(kw).values(), tris.v0, tris.e1, tris.e2,
                   t_k, i_k),
            NEAREST_HIT_OPS_PER_PAIR * n_live * tris.pad_triangles)
        timing[label] = dict(ms=ms, plain_ms=plain_ms, wall_ms=wall_ms,
                             plain_wall_ms=plain_wall_ms, bound_ms=bound_ms,
                             bound_by=bound_by, rays=o.shape[0], live=n_live,
                             blocks_by_live=blocks_by_live(o, kw),
                             T=tris.pad_triangles)
        emit(phase="kernel_time", query=label, **timing[label], gpu=smi())
    return worst, total_flips, timing


def phase_profile(host, dev):
    """One profiler window per nrx over a warm 2^20-path ``compute_paths``
    (launch directions cached).  Device busy is the sum of the device
    events' own times (kernels and copies run one at a time on the one
    stream); the idle share is the rest of the profiled call's wall time."""
    for nrx in (1, 4):
        w = device_window(lambda: run_paths(  # noqa: B023
            host, nrx, dev, "cuda", PATHS), 1, f"profile nrx {nrx}")
        wall_ms, dev_rows = w.wall_ms, w.device
        host_ms = sum(e.self_cpu_time_total for e in w.host) / 1e3
        out = dict(phase="profile", nrx=nrx, paths=PATHS, wall_ms=wall_ms,
                   host_self_ms=host_ms, gpu=smi())
        if dev_rows:
            busy = sum(event_ms(e) for e in dev_rows)
            nh = [e for e in dev_rows if "nearest_hit_kernel" in e.key]
            nh_ms = sum(event_ms(e) for e in nh)
            top = sorted(dev_rows, key=event_ms, reverse=True)[:5]
            out.update(device_busy_ms=busy, idle_share=1.0 - busy / wall_ms,
                       nearest_hit_ms=nh_ms,
                       nearest_hit_launches=sum(e.count for e in nh),
                       nearest_hit_share=nh_ms / busy,
                       device_ops=sum(e.count for e in dev_rows),
                       top_device=[[e.key[:60], event_ms(e), e.count]
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
    expected = {**{n: 0 for n in KERNELS},
                "nearest_hit": 1 + 2 * BOUNCES, "bounce_pre": BOUNCES,
                "bounce_post": BOUNCES, "loop_bwd_slim": 1,
                "gather": 1}      # the payload table's eta rows
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
    output written once (the backward's: ``measure.bwd_work``)."""
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
    return bwd_work(name, spec, rest, outs)


def fused_symbol(name, spec):
    """The stem of kernel ``name``'s mangled name in the build log
    (``measure.kernel_ptxas``'s key) for the instantiation ``spec``
    launches: the forward kernels are templates on the transmission modes
    (``csrc/bounce_fused.cu``; the pre kernel on ``kSpawn`` alone)."""
    if name not in ("bounce_pre", "bounce_post"):
        return f"{name}_kernel"
    trans = 2 * int(spec.spawn_transmission)
    if name == "bounce_post":
        trans |= int(spec.transmission)
    return f"{name}_kernelILi{trans}E"


def hold_fused_forward(calls, label):
    """Every recorded ``bounce_pre`` / ``bounce_post`` launch against its
    plain version (``hold_pre`` / ``hold_post``: equal decisions, values
    within ``ROW_RTOL``).  Returns the largest error per kernel."""
    worst = {}
    for name, hold in (("bounce_pre", hold_pre), ("bounce_post", hold_post)):
        worst[name] = 0.0
        for i, (args, out) in enumerate(calls[name]):
            err, _ = hold(args[0], args[1:], out, f"{label}/{name}/call{i}")
            worst[name] = max(worst[name], err)
    return worst


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
            timing.update(share=bound_ms / timing["ms"],
                          ptxas=kernel_ptxas(LIBRARY.build_log,
                                             fused_symbol(name, spec)))
            summary[name].setdefault("timing", {})[nrx] = timing
            emit(phase="fused_kernel_time", kernel=name, nrx=nrx, **timing,
                 gpu=smi())
    return summary


def phase_profile_step(tris, dev):
    """One profiler window over a warm forward+backward step at nrx = 1, of
    the fused path and of the op path: device busy, the four kernels' times
    and launches, device operations and the idle share of the step."""
    mats = default_materials(dev)
    for shade in ("fused", "xla"):
        cfg = calib_config(PATHS, 1, shade == "fused")
        calib_step(tris, 1, mats, cfg)                         # warm-up
        t0 = time.perf_counter()
        calib_step(tris, 1, mats, cfg)
        unprofiled_ms = (time.perf_counter() - t0) * 1e3
        w = device_window(lambda: calib_step(  # noqa: B023
            tris, 1, mats, cfg), 1, f"profile_step {shade}")
        wall_ms, dev_rows = w.wall_ms, w.device
        host_ms = sum(e.self_cpu_time_total for e in w.host) / 1e3
        out = dict(phase="profile_step", shade=shade, nrx=1, paths=PATHS,
                   wall_ms=wall_ms, unprofiled_wall_ms=unprofiled_ms,
                   host_self_ms=host_ms, gpu=smi())
        if dev_rows:
            busy = sum(event_ms(e) for e in dev_rows)
            per = {}
            for name in KERNELS:
                ev = [e for e in dev_rows if f"{name}_kernel" in e.key]
                per[name] = dict(ms=sum(event_ms(e) for e in ev),
                                 launches=sum(e.count for e in ev))
            top = sorted(dev_rows, key=event_ms, reverse=True)[:8]
            out.update(device_busy_ms=busy, idle_share=1.0 - busy / wall_ms,
                       idle_share_unprofiled=1.0 - busy / unprofiled_ms,
                       kernels=per, device_ops=sum(e.count for e in dev_rows),
                       indexing_backward_ms=indexing_backward_ms(dev_rows),
                       top_device=[[e.key[:60], event_ms(e), e.count]
                                   for e in top])
        else:
            out.update(device_busy_ms=None,
                       note="the profiler recorded no device events")
        emit(**out)


# --- the large-scene path -------------------------------------------------


WALK_KERNELS = {"walk_prepass": walk_cuda.walk_prepass,
                "walk": walk_cuda.walk}


def zero_counts():
    for kern in (*KERNELS.values(), *WALK_KERNELS.values()):
        kern.launches = 0


def read_counts():
    return {n: k.launches for n, k in {**KERNELS, **WALK_KERNELS}.items()}


def indexing_backward_ms(dev_rows):
    """Device time of PyTorch's indexing backward (the backward of a
    ``table[idx]`` gather) among profiled device events."""
    return sum(event_ms(e) for e in dev_rows
               if "indexing_backward" in e.key)


def profile_window(fn, label):
    """One profiler window over a call of ``fn`` (:func:`device_window`):
    wall, device busy, device operations, idle share and the top device
    operations."""
    w = device_window(fn, 1, label)
    wall_ms, dev_rows = w.wall_ms, w.device
    if not dev_rows:
        return dict(wall_ms=wall_ms, device_busy_ms=None,
                    note="the profiler recorded no device events")
    busy = sum(event_ms(e) for e in dev_rows)
    per = {}
    for name in ("walk_prepass", "walk", "nearest_hit", *FUSED, *STAGE_BWD,
                 "scatter_add", "nearest_hit_culled", "gather", "shade_a"):
        ev = [e for e in dev_rows if f"{name}_kernel" in e.key]
        per[name] = dict(ms=sum(event_ms(e) for e in ev),
                         launches=sum(e.count for e in ev))
    top = sorted(dev_rows, key=event_ms, reverse=True)[:8]
    return dict(wall_ms=wall_ms, device_busy_ms=busy,
                idle_share=1.0 - busy / wall_ms, kernels=per,
                indexing_backward_ms=indexing_backward_ms(dev_rows),
                device_ops=sum(e.count for e in dev_rows),
                top_device=[[e.key[:60], event_ms(e), e.count]
                            for e in top])


def phase_city(dev):
    """A: the config-5 city through the Sionna importer."""
    out_dir = BUILD_DIR / "city131k"
    t0 = time.perf_counter()
    xml = make_city(str(out_dir), **CITY)
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = load_scene(xml)
    t_load = time.perf_counter() - t0
    t0 = time.perf_counter()
    tris = flatten_scene(host, sort_triangles=True, device=dev)
    torch.cuda.synchronize()
    t_flat = time.perf_counter() - t0
    shutil.rmtree(out_dir)
    scene = prepare_walk(tris)
    mats = sorted({m.material_index for m in host.meshes})
    check(tris.num_triangles == CITY_TRIANGLES,
          f"city: {tris.num_triangles} triangles")
    check(mats == [1, 15], f"city: materials {mats}")
    emit(phase="city", triangles=tris.num_triangles,
         padded=tris.pad_triangles, write_s=t_write, load_s=t_load,
         flatten_sort_s=t_flat, fine_tiles=scene.n_tiles,
         block_tris=scene.block_tris, coarse_boxes=scene.n_boxes,
         group=scene.group, materials=mats,
         material_names=[MATERIAL_NAMES[m] for m in mats])
    return tris


class WalkRecorder:
    """Stands in for the walk query inside the tracer for one trace:
    forwards every query to :func:`walk_cuda.walk_query` (whose wrappers
    count the launches) and keeps its inputs and answer."""

    def __init__(self):
        self.queries = []

    def __call__(self, o, d, scene, **kw):
        t, idx = walk_cuda.walk_query(o, d, scene, **kw)
        self.queries.append((o, d, scene, kw, t, idx))
        return t, idx


@contextlib.contextmanager
def recording_walk():
    rec = WalkRecorder()
    saved = tracer_module.walk_query
    tracer_module.walk_query = rec
    try:
        yield rec
    finally:
        tracer_module.walk_query = saved


def city_paths(tris, nrx, paths, **kw):
    """``compute_paths`` on the city as config-5 traces it."""
    los, sc = compute_paths(tris, rx_positions(nrx, CITY_RX0), CITY_TX,
                            np.zeros((nrx, 3)), np.zeros((1, 3)), FREQ_GHZ,
                            nrx, 1, paths, BOUNCES, device=tris.device,
                            parity="physical",
                            launch_order="coherent", compact_rays=True,
                            keep_rays=False, **kw)
    torch.cuda.synchronize()
    return los, sc


def walk_work(o, d, scene, lim, visits, t, exclude_given, block_reached):
    """What the walk of one query must move and do on this run's data.  The
    bound (``bytes``, ``ops``): 47 operations per (live ray, triangle) pair
    in the fine tiles that ray's own slab test reaches within min(final t,
    lim) (``ray_reached_pairs``), and one slab test per (live ray, listed
    fine tile) (``listed_pairs``); the rays (o, d, exclude, lim) in and (t,
    idx) out, the visit entries used, the fine tiles' boxes and the
    triangles once.  The contract's work: every live ray of a ray tile
    evaluates every fine tile that any ray of the tile reaches
    (``block_reached``, bool[nRT, nT], from the plain walk), so
    ``contract_pairs`` = sum over ray tiles of live rays x block-reached
    tiles x block_tris, and ``contract_ops`` those pairs at 47 operations
    plus the same slab tests."""
    br, g, bt = scene.block_rays, scene.group, scene.block_tris
    n_rt = visits.shape[0]
    R = o.shape[0]
    counts = visits[:, 0].long()
    n_pad = n_rt * br
    pad = lambda x: torch.cat([x, x.new_zeros((n_pad - R, 3))])  # noqa: E731
    o_t, d_t = pad(o).reshape(n_rt, br, 3), pad(d).reshape(n_rt, br, 3)
    inv = 1.0 / torch.where(d_t == 0, 1e-30, d_t)
    t_f = torch.cat([t, t.new_full((n_pad - R,), float("inf"))])
    limit = torch.minimum(t_f, lim).reshape(n_rt, br)
    live = (lim >= 0).reshape(n_rt, br)
    reached = listed = 0
    step = 16
    for a in range(0, n_rt, step):
        b = min(a + step, n_rt)
        c_max = int(counts[a:b].max())
        if c_max == 0:
            continue
        e = torch.arange(c_max * g, device=o.device)
        box = visits[a:b, 1:1 + c_max].long()                   # [n, c]
        fine = (box[:, :, None] * g + torch.arange(g, device=o.device)
                ).reshape(b - a, -1)                             # [n, c*g]
        on = e[None, :] < counts[a:b, None] * g
        ab = scene.aabbs[fine]                                   # [n, c*g, 6]
        tn = tf = None
        for ax in range(3):
            o_ax, i_ax = o_t[a:b, :, None, ax], inv[a:b, :, None, ax]
            p = (ab[:, None, :, ax] - o_ax) * i_ax
            q = (ab[:, None, :, 3 + ax] - o_ax) * i_ax
            na, fa = torch.minimum(p, q), torch.maximum(p, q)
            tn = na if ax == 0 else torch.maximum(tn, na)
            tf = fa if ax == 0 else torch.minimum(tf, fa)
        lm = limit[a:b, :, None]
        hit = ((tf >= 0) & (tn <= tf) & (tn <= lm) & (lm >= 0)
               & on[:, None, :] & live[a:b, :, None])
        reached += int(hit.sum())
        listed += int((on[:, None, :] & live[a:b, :, None]).sum())
    contract = bt * int((live.sum(dim=1) * block_reached.sum(dim=1)).sum())
    n_bytes = (R * (24 + 4 + (4 if exclude_given else 0)) + R * 8
               + 4 * int((counts + 1).sum()) + nbytes(scene.aabbs)
               + nbytes(scene.v0, scene.e1, scene.e2))
    return dict(bytes=n_bytes,
                ops=(NEAREST_HIT_OPS_PER_PAIR * bt * reached
                     + SLAB_OPS * listed),
                ray_reached_pairs=bt * reached, listed_pairs=listed,
                contract_pairs=contract,
                contract_ops=NEAREST_HIT_OPS_PER_PAIR * contract
                + SLAB_OPS * listed)


def phase_walk(tris, dev):
    """B: the walk kernels on the recorded queries of one config-5 forward.
    Returns the launches of that forward and the timing rows."""
    assert_flips = flips_check()
    ns = types.SimpleNamespace(**{f: getattr(tris, f).cpu().numpy()
                                  for f in ("v0", "e1", "e2")})
    city_paths(tris, 1, PATHS)                                   # warm-up
    with recording_walk() as rec:
        zero_counts()
        city_paths(tris, 1, PATHS)
        launches = read_counts()
    check(launches["walk"] == launches["walk_prepass"] == 1 + 2 * BOUNCES
          and launches["nearest_hit"] == 0,
          f"city forward launches {launches}")
    check(len(rec.queries) == 1 + 2 * BOUNCES, "recorded queries")
    timing = {}
    totals = dict(brute_flips=0, walk_max_abs_err=0.0)
    for qi, (o, d, scene, kw, t_k, i_k) in enumerate(rec.queries):
        label = f"walk/q{qi}"
        R = o.shape[0]
        t_max, live, ex = kw.get("t_max"), kw.get("live"), kw.get("exclude")
        any_hit = bool(kw.get("any_hit")) and t_max is not None
        lim = query_limits(R, scene.block_rays, t_max=t_max, live=live,
                           device=dev)
        visits = walk_cuda.walk_prepass(o, d, lim, scene.boxes)
        rows_p = visit_rows(*prepass_plain(o, d, lim, scene.boxes,
                                           scene.block_rays))
        check(torch.equal(visits, rows_p),
              f"{label}: the prepass kernel's visit rows differ from the "
              f"plain version's in {int((visits != rows_p).any(1).sum())} "
              f"ray tiles")
        check(torch.equal(walk_cuda.walk_prepass(o, d, lim, scene.boxes),
                          visits), f"{label}: the prepass is not "
              "deterministic")
        t_w, i_w = walk_cuda.walk(o, d, lim, scene, visits, exclude=ex,
                                  any_hit=any_hit)
        check(torch.equal(t_w.view(torch.int32), t_k.view(torch.int32))
              and torch.equal(i_w, i_k),
              f"{label}: the walk is not deterministic")
        # the plain walk on every ray, with the fine tiles each ray tile
        # reached
        block_reached = torch.zeros((visits.shape[0], scene.n_tiles),
                                    dtype=torch.bool, device=dev)
        t0 = time.perf_counter()
        t_p, i_p = walk_plain(o, d, scene, visits, lim, exclude=ex,
                              any_hit=any_hit, tile_chunk=1024,
                              reach_out=block_reached)
        torch.cuda.synchronize()
        walk_plain_ms = (time.perf_counter() - t0) * 1e3
        plain_flips = int((i_p != i_k).sum())
        fin = torch.isfinite(t_p) & (i_p == i_k)
        walk_err = (float((t_p[fin] - t_k[fin]).abs().max())
                    if fin.any() else 0.0)
        totals["walk_max_abs_err"] = max(totals["walk_max_abs_err"], walk_err)
        check(plain_flips == 0 and torch.equal(t_p.view(torch.int32),
                                               t_k.view(torch.int32)),
              f"{label}: {plain_flips} flips against the plain walk")
        # the brute kernel on every ray
        t_b, i_b = nearest_hit(o, d, tris, exclude=ex, t_max=t_max,
                               live=live)
        if any_hit:
            tm = t_max if isinstance(t_max, torch.Tensor) else torch.full_like(
                t_k, float(t_max))
            blocked = (i_k >= 0) & (t_k <= tm)
            check(torch.equal(blocked, (i_b >= 0) & (t_b <= tm)),
                  f"{label}: any-hit blocked differs from the brute kernel")
            sel = i_k[blocked].long()
            comp = lambda x: tuple(x[:, c] for c in range(3))  # noqa: E731
            t_re, valid = mt_hit(comp(o[blocked]), comp(d[blocked]),
                                 comp(tris.v0[sel]), comp(tris.e1[sel]),
                                 comp(tris.e2[sel]))
            check(bool(valid.all()) and torch.equal(t_re, t_k[blocked])
                  and (ex is None
                       or not bool((sel == ex[blocked].long()).any())),
                  f"{label}: an any-hit answer is not a valid hit")
            brute_flips = int((blocked != ((i_b >= 0) & (t_b <= tm))).sum())
        else:
            brute_flips = int((i_k != i_b).sum())
            if brute_flips:
                assert_flips(ns, o.cpu().numpy(), d.cpu().numpy(),
                             t_b.cpu().numpy(), i_b.cpu().numpy(),
                             t_k.cpu().numpy(), i_k.cpu().numpy(),
                             t_rtol=0.0, label=label)
            m = (i_k == i_b) & (i_k >= 0)
            check(torch.equal(t_k[m], t_b[m]), f"{label}: t differs")
        totals["brute_flips"] += brute_flips
        counts = visits[:, 0].float()
        n_live = int((lim >= 0).sum())
        work = walk_work(o, d, scene, lim, visits, t_k, ex is not None,
                         block_reached)
        row = dict(rays=R, live=n_live, any_hit=any_hit,
                   hits=int((i_k >= 0).sum()), brute_flips=brute_flips,
                   plain_flips=plain_flips, plain_rays=R,
                   visit_mean=float(counts.mean()),
                   visit_max=int(counts.max()), boxes=scene.n_boxes,
                   group=scene.group,
                   listed_tiles=int(counts.sum()) * scene.group,
                   block_reached_tiles=int(block_reached.sum()),
                   ray_reached_pairs=work["ray_reached_pairs"],
                   contract_pairs=work["contract_pairs"],
                   contract_pair_ms=NEAREST_HIT_OPS_PER_PAIR
                   * work["contract_pairs"] / F32_OPS_PER_S * 1e3,
                   walk_bound=bound(work["bytes"], work["ops"]),
                   contract_bound=bound(work["bytes"], work["contract_ops"]),
                   walk_bytes=work["bytes"], walk_ops=work["ops"],
                   walk_plain_ms=walk_plain_ms)
        # every query's prepass (its visit rows included) and walk device
        # time: later bounces start from scattered hit points, so their ray
        # tiles are less coherent.  The prepass's bound is over the work it
        # does: 28 operations a (live ray, box) pair its per-tile prune keeps
        # and the prune's per (ray tile with a live ray, box), the rays and
        # boxes read once and the rows written once; beside it the bound
        # over every (live ray, box) pair at the f32 rate and at the half
        # rate that operations without FMA reach
        run_pre = lambda: walk_cuda.walk_prepass(  # noqa: E731
            o, d, lim, scene.boxes)
        # the boxes the prune keeps must hold every box the tile reaches
        kept = prepass_kept_plain(o, d, lim, scene.boxes, scene.block_rays)
        n_reach = visits[:, 0].long()
        reached = (torch.arange(scene.n_boxes, device=dev)[None, :]
                   < n_reach[:, None])
        check(bool(kept.gather(1, visits[:, 1:].long())[reached].all()),
              f"{label}: the prune dropped a reached box")
        pre = prepass_bounds(nbytes(o, d, lim, scene.boxes, visits),
                             (lim >= 0).reshape(-1, scene.block_rays).sum(1),
                             scene.n_boxes, kept)
        row.update(prepass_ms=device_ms(run_pre, 5, "walk_prepass"),
                   prepass_bound=pre["kept"],
                   prepass_kept_pairs=pre["kept_pairs"],
                   prepass_pairs=pre["pairs"],
                   prepass_all_pairs_bound=pre["all_pairs"],
                   prepass_all_pairs_bound_half_rate=pre[
                       "all_pairs_half_rate"],
                   live_ray_tiles=pre["live_tiles"])
        row["prepass_share"] = row["prepass_bound"][0] / row["prepass_ms"]
        row["walk_ms"] = device_ms(
            lambda: walk_cuda.walk(o, d, lim, scene, visits, exclude=ex,
                                   any_hit=any_hit), 5, "walk")
        if qi in (1, 2):     # the first bounce query and its shadow query
            name = "bounce" if qi == 1 else "shadow"
            run_walk = lambda: walk_cuda.walk(  # noqa: E731
                o, d, lim, scene, visits, exclude=ex, any_hit=any_hit)
            row.update(
                prepass_ms=device_ms(run_pre, 20, "walk_prepass"),
                prepass_plain_ms=device_ms(
                    lambda: visit_rows(*prepass_plain(
                        o, d, lim, scene.boxes, scene.block_rays)), 2),
                walk_ms=device_ms(run_walk, 20, "walk"),
                # the whole call: the kernel and the sort of its block order
                walk_call_ms=device_ms(run_walk, 20),
                # CUDA events: the profiler reported no device time for
                # these 0.1-1 s launches
                brute_ms=cuda_ms(lambda: nearest_hit(
                    o, d, tris, exclude=ex, t_max=t_max, live=live), 1))
            row["prepass_share"] = (row["prepass_bound"][0]
                                    / row["prepass_ms"])
            if any_hit:     # what the early exit saves on this query
                row["walk_nearest_mode_ms"] = device_ms(
                    lambda: walk_cuda.walk(o, d, lim, scene, visits,
                                           exclude=ex), 20, "walk")
            timing[name] = row
        emit(phase="walk", query=qi, **row, gpu=smi())
        timing.setdefault("queries", []).append({k: row[k] for k in (
            "rays", "live", "any_hit", "walk_ms", "walk_bound",
            "contract_bound", "listed_tiles", "block_reached_tiles",
            "ray_reached_pairs", "contract_pairs", "prepass_ms",
            "prepass_bound", "prepass_kept_pairs", "prepass_pairs",
            "prepass_all_pairs_bound", "prepass_all_pairs_bound_half_rate",
            "live_ray_tiles")})
    timing["ptxas"] = kernel_ptxas(LIBRARY.build_log, "walk_kernel")
    timing["prepass_ptxas"] = kernel_ptxas(LIBRARY.build_log,
                                           "walk_prepass_kernel")
    emit(phase="walk_summary", launches_per_forward=launches, **totals,
         prepass_ms_seven=sum(q["prepass_ms"] for q in timing["queries"]),
         walk_kernel_ptxas=timing["ptxas"],
         prepass_kernel_ptxas=timing["prepass_ptxas"])
    timing["errors"] = totals
    return launches, timing


def phase_city_equal(dev):
    """C: walk and the culled query against brute on a 14,336-triangle city,
    every output bit for bit; M (city): the culled queries of one trace per
    configuration held, the bounce query timed against the brute kernel."""
    out_dir = BUILD_DIR / "city14k"
    host = load_scene(make_city(str(out_dir), n_buildings=16, ground_sub=32))
    shutil.rmtree(out_dir)
    tris = flatten_scene(host, sort_triangles=True, device=dev)
    check(tris.num_triangles == 14336, f"{tris.num_triangles} triangles")
    assert_flips = flips_check()
    ns = types.SimpleNamespace(**{f: getattr(tris, f).cpu().numpy()
                                  for f in ("v0", "e1", "e2")})
    modes = {"walk": dict(walk=True), "brute": dict(walk=False),
             "cull": dict(walk=False, cull=True)}
    query = {"walk": "walk", "brute": "nearest_hit",
             "cull": "nearest_hit_culled"}
    culled = dict(brute_flips=0, skipped=0, pairs=0, plain_bit_equal=True)
    timing = {}
    for parity in ("reference", "physical"):
        for nrx in (1, 4):
            out, wall = {}, {}
            for mode, kw in modes.items():
                with recording_fused() as calls:
                    zero_counts()
                    t0 = time.perf_counter()
                    los, sc = compute_paths(
                        tris, rx_positions(nrx, SMALL_CITY_RX0),
                        SMALL_CITY_TX, np.zeros((nrx, 3)),
                        np.zeros((1, 3)), FREQ_GHZ, nrx, 1, SMALL_PATHS // 4,
                        BOUNCES, device=dev, parity=parity,
                        compact_rays=True, keep_rays=False, **kw)
                    torch.cuda.synchronize()
                    wall[mode] = time.perf_counter() - t0
                    n = read_counts()
                for q in query.values():
                    check(n[q] == (1 + 2 * BOUNCES if q == query[mode]
                                   else 0),
                          f"{parity}/nrx={nrx}/{mode}: launches {n}")
                out[mode] = (los, sc)
                if mode != "cull":
                    continue
                for qi, (args, (t, idx)) in enumerate(
                        calls["nearest_hit_culled"]):
                    o, d, q_tris, q_kw = args
                    label = f"M city {parity}/nrx={nrx}/q{qi}"
                    row, reach = hold_culled_query(q_tris, o, d, q_kw, t,
                                                   idx, label, assert_flips,
                                                   ns)
                    culled["brute_flips"] += row["brute_flips"]
                    culled["skipped"] += row["skipped"]
                    culled["pairs"] += reach.numel()
                    if (parity, nrx, qi) == ("physical", 1, 1):
                        brute_kw = {k: v for k, v in q_kw.items()
                                    if k != "aabbs"}
                        n_bytes, n_ops = culled_work(o, d, q_tris, q_kw,
                                                     reach, t, idx)
                        timing = time_kernel(
                            "nearest_hit_culled",
                            lambda: nearest_hit_culled(  # noqa: B023
                                o, d, q_tris, **q_kw),
                            lambda: intersect_torch(  # noqa: B023
                                o, d, q_tris, chunk_size=TWIN_CHUNK,
                                **plain_kw(q_kw)), n_bytes, n_ops)
                        timing["brute_ms"] = device_ms(
                            lambda: nearest_hit(  # noqa: B023
                                o, d, q_tris, **brute_kw), 20, "nearest_hit")
                        timing.update(row, library_ms=None,
                                      pairs=reach.numel())
                        emit(phase="culled_time", query="city_bounce",
                             **timing, gpu=smi())
                del calls
            for mode in ("brute", "cull"):
                for part in (0, 1):
                    for f in OUTPUT_FIELDS:
                        check(torch.equal(getattr(out["walk"][part], f),
                                          getattr(out[mode][part], f)),
                              f"{parity}/nrx={nrx}: {f} differs walk vs "
                              f"{mode}")
            nonzero = int((out["walk"][1].a_te.abs() > 0).sum())
            check(nonzero > 0, f"{parity}/nrx={nrx}: empty scatter")
            emit(phase="city_equal", triangles=tris.num_triangles,
                 paths=SMALL_PATHS // 4, parity=parity, nrx=nrx,
                 bit_equal=True, wall_s=wall, scatter_nonzero=nonzero)
    emit(phase="culled_summary", scene="city14k", **culled, gpu=smi())
    return dict(culled, timing=timing)


def phase_city_forward(tris):
    """D: config-5 forward at the port's default (on a card the fused
    forward: no gradient can be asked of ``compute_paths``)."""
    nrx = 1
    city_paths(tris, nrx, PATHS)                                 # warm-up
    zero_counts()
    los, sc = city_paths(tris, nrx, PATHS)
    launches = read_counts()
    for f in OUTPUT_FIELDS:
        x = getattr(sc, f)
        x = torch.view_as_real(x) if x.is_complex() else x
        check(bool(torch.isfinite(x).all()), f"city fwd: {f} not finite")
    nonzero = int((sc.a_te.abs() > 0).sum())
    check(nonzero > 0, "city fwd: empty scatter")
    t0 = time.perf_counter()
    for _ in range(3):
        city_paths(tris, nrx, PATHS)
    s = (time.perf_counter() - t0) / 3
    prof = profile_window(lambda: city_paths(tris, nrx, PATHS), "D")
    # the brute-force control, once, as benchmarks/config5_e2e.py runs one
    t0 = time.perf_counter()
    _, sc_b = city_paths(tris, nrx, PATHS, walk=False)
    brute_s = time.perf_counter() - t0
    for f in OUTPUT_FIELDS:
        check(torch.equal(getattr(sc, f), getattr(sc_b, f)),
              f"city fwd: {f} differs between walk and brute")
    emit(phase="city_fwd", paths=PATHS, bounces=BOUNCES, nrx=nrx,
         launches=launches, scatter_nonzero=nonzero, fwd_s=s,
         fwd_queries_per_s=BOUNCES * PATHS * (1 + nrx) / s,
         brute_fwd_s=brute_s, walk_equals_brute=True, **prof, gpu=smi())
    return launches


def phase_city_train(tris, dev):
    """E: the calibration step on the city.  Returns per nrx the launches
    of one step."""
    counts = {}
    for nrx in (1, 4):
        cfgs = {fused: calibration_config(PATHS, BOUNCES, fused,
                                          parity="physical")
                for fused in (True, False)}
        mats = default_materials(dev)
        step = lambda cfg, bwd=True: calibration_step(  # noqa: E731
            tris, rx_positions(nrx, CITY_RX0), CITY_TX, FREQ_GHZ, mats, cfg,
            backward=bwd)
        step(cfgs[True])                                         # warm-up
        zero_counts()
        res, loss = step(cfgs[True])
        counts[nrx] = read_counts()
        expected = {**{n: 0 for n in read_counts()}, "bounce_pre": BOUNCES,
                    "bounce_post": BOUNCES, "loop_bwd_slim": 1, "gather": 1,
                    "walk_prepass": 1 + 2 * BOUNCES, "walk": 1 + 2 * BOUNCES}
        check(counts[nrx] == expected,
              f"city step nrx={nrx}: launches {counts[nrx]}")
        g = grads_of(mats)
        check(all(bool(torch.isfinite(v).all()) for v in g.values())
              and any(float(v.abs().max()) > 0 for v in g.values()),
              f"city step nrx={nrx}: gradients not finite or all zero")
        written = int((res.scatter.a_te.abs() > 0).sum())
        loss_value = float(loss.detach())
        del res, loss
        times = {}
        for bwd in (False, True):
            step(cfgs[True], bwd)
            t0 = time.perf_counter()
            for _ in range(3):
                step(cfgs[True], bwd)
            times["fwd_bwd" if bwd else "fwd"] = (time.perf_counter() - t0) / 3
        prof = profile_window(lambda: step(cfgs[True]), "E")

        grads, scat = {}, {}
        for fused in (False, True):
            m = default_materials(dev)
            res, _ = calibration_step(
                tris, rx_positions(nrx, CITY_RX0), CITY_TX, FREQ_GHZ, m,
                calibration_config(SMALL_PATHS, BOUNCES, fused,
                                   parity="physical"))
            grads[fused], scat[fused] = grads_of(m), res.scatter
        share = leaves_close(grads[True], grads[False], PATH_GRAD_RTOL,
                             LEAF_ATOL, f"city nrx={nrx}: fused vs op path")
        agree = {f: slots_agree(getattr(scat[False], f),
                                getattr(scat[True], f), f)
                 for f in OUTPUT_FIELDS}
        emit(phase="city_train", nrx=nrx, paths=PATHS, launches=counts[nrx],
             loss=loss_value, scatter_nonzero=written, step_s=times,
             queries_per_s={k: BOUNCES * PATHS * (1 + nrx) / v
                            for k, v in times.items()},
             grad_vs_op_path_max_leaf_share=share, slot_agreement_2_16=agree,
             profile=prof, gpu=smi())
    return counts


def phase_city_loss(tris, dev):
    """F: benchmarks/config5_e2e.py's loss through the op path, gradients
    to the materials and the TX position."""
    cfg = TracerConfig(num_paths=PATHS, num_bounces=BOUNCES,
                       parity="physical", launch_order="coherent",
                       keep_rays=False)
    z = np.zeros((1, 3), np.float32)

    def run():
        mats = default_materials(dev)
        tx = torch.tensor(CITY_TX, device=dev, requires_grad=True)
        res = trace_paths(tris, mats, rx_positions(1, CITY_RX0), tx, z, z,
                          FREQ_GHZ, cfg)
        loss = (res.scatter.a_te.abs().square().sum()
                + res.scatter.a_tm.abs().square().sum()) * 1e9
        loss.backward()
        torch.cuda.synchronize()
        return loss, grads_of(mats), tx.grad

    with recording_fused() as calls:
        t0 = time.perf_counter()
        loss, g, g_tx = run()
        wall = time.perf_counter() - t0
    gathers, scatters = calls["gather"], calls["scatter_add"]
    del calls
    leaves = torch.cat([v.reshape(-1) for v in g.values()]
                       + [g_tx.reshape(-1)])
    check(bool(torch.isfinite(leaves).all()) and bool((leaves != 0).any())
          and bool((g_tx != 0).any()) and math.isfinite(float(loss.detach())),
          "config5 loss: gradients not finite or zero")
    prof = profile_window(run, "F")
    emit(phase="city_loss", paths=PATHS, bounces=BOUNCES,
         loss=float(loss.detach()),
         tx_grad=g_tx.cpu().tolist()[0], wall_s=wall,
         grad_abs_max={k: float(v.abs().max()) for k, v in g.items()},
         profile_wall_ms=prof["wall_ms"],
         device_busy_ms=prof["device_busy_ms"],
         idle_share=prof.get("idle_share"), device_ops=prof.get("device_ops"),
         kernels=prof.get("kernels"),
         indexing_backward_ms=prof.get("indexing_backward_ms"),
         top_device=prof.get("top_device"), gpu=smi())
    return (g, g_tx), gathers, scatters


# --- the full-gradient fused path ------------------------------------------


def grad_config(paths, fused, **kw):
    """The calibration flags with every gradient: the fused path with the
    JAX defaults (``grad_positions``, ``grad_geometry``), or the op path."""
    kw = dict(grad_geometry=True, **kw)
    if fused:
        kw["grad_positions"] = True
    return calibration_config(paths, BOUNCES, fused, **kw)


def grad_step(tris, rx, tx, freq, cfg, loss_fn=grad_loss, vertices=True):
    """One forward+backward through ``trace`` with the RX and TX positions,
    the frequency and (with ``vertices``) the vertices as leaves.  Returns
    ``(result, loss, gradients by leaf)``."""
    dev = tris.device
    mats = default_materials(dev)
    v0 = tris.v0.detach().clone().requires_grad_(vertices)
    leaves = dict(rx=torch.tensor(rx, device=dev, requires_grad=True),
                  tx=torch.tensor(tx, device=dev, requires_grad=True),
                  f=torch.tensor(freq, device=dev, requires_grad=True))
    res = trace(dataclasses.replace(tris, v0=v0), leaves["rx"], leaves["tx"],
                carrier_frequency=leaves["f"], config=cfg, materials=mats)
    loss = loss_fn(res)
    loss.backward()
    torch.cuda.synchronize()
    zero = torch.zeros((), device=dev)
    grads = {**grads_of(mats),
             **{k: zero if x.grad is None else x.grad
                for k, x in dict(leaves, v0=v0).items()}}
    return res, loss, grads


def check_grads(grads, label, leaves=("rx", "tx", "f", "v0")):
    """Every gradient finite; the named leaves and the materials nonzero."""
    for k, v in grads.items():
        check(bool(torch.isfinite(v).all()), f"{label}: gradient {k} not "
              "finite")
    for k in leaves:
        check(float(grads[k].abs().max()) > 0, f"{label}: gradient {k} zero")
    check(any(float(grads[f].abs().max()) > 0 for f in MATERIAL_FIELDS),
          f"{label}: material gradients all zero")


def grad_maxima(grads):
    return {k: float(v.abs().max()) for k, v in grads.items()}


def mean_s(fn, reps=3):
    """Host-clock mean of ``fn`` (which synchronises) after one warm-up."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps


def phase_grad_step(tris, dev):
    """G: the full-gradient fused step on the canyon stand-in.  Returns per
    nrx the launches of one step and its recorded kernel calls."""
    expected = {**{n: 0 for n in KERNELS}, "nearest_hit": 1 + 2 * BOUNCES,
                "bounce_pre": BOUNCES, "bounce_post": BOUNCES,
                "bounce_pre_bwd": BOUNCES, "bounce_post_bwd": BOUNCES,
                # per bounce: the pre and post payload rows, the occluder
                # normals (reference parity with grad_geometry); then the
                # table's eta rows per material (their one gather)
                "scatter_add": 3 * BOUNCES + 1, "gather": 1}
    counts, recorded = {}, {}
    for nrx in (1, 4):
        cfg = grad_config(PATHS, True)
        step = lambda cfg=cfg: grad_step(  # noqa: E731
            tris, rx_positions(nrx), TX, FREQ_GHZ, cfg)
        step()                                                   # warm-up
        with recording_fused() as calls:
            for kern in KERNELS.values():
                kern.launches = 0
            res, loss, grads = step()
            counts[nrx] = {n: kern.launches for n, kern in KERNELS.items()}
        recorded[nrx] = calls
        check(counts[nrx] == expected,
              f"G nrx={nrx}: launches {counts[nrx]}, expected {expected}")
        for f in OUTPUT_FIELDS:
            x = getattr(res.scatter, f)
            x = torch.view_as_real(x) if x.is_complex() else x
            check(bool(torch.isfinite(x).all()), f"G nrx={nrx}: {f}")
        check_grads(grads, f"G nrx={nrx}")
        loss_value, maxima = float(loss.detach()), grad_maxima(grads)
        del res, loss, grads
        step_s = mean_s(lambda: step())
        prof = profile_window(lambda: step(), f"G nrx {nrx}")
        # at 2^16 paths: every gradient against the op path's autograd
        small = {fused: grad_step(tris, rx_positions(nrx), TX, FREQ_GHZ,
                                  grad_config(SMALL_PATHS, fused))[2]
                 for fused in (False, True)}
        share = leaves_close(small[True], small[False], PATH_GRAD_RTOL,
                             LEAF_ATOL, f"G nrx={nrx}: fused vs op path")
        emit(phase="grad_step", nrx=nrx, paths=PATHS, bounces=BOUNCES,
             launches=counts[nrx], loss=loss_value, grad_abs_max=maxima,
             fwd_bwd_s=step_s,
             queries_per_s=BOUNCES * PATHS * (1 + nrx) / step_s,
             grad_vs_op_path_max_leaf_share=share, profile=prof, gpu=smi())
    return counts, recorded


def scatter_work(idx, g, T):
    """(bytes, operations) of one scatter-add: the ids in once, the kept
    rows (ids in ``[0, T)``) in once, the table out once; one add per (kept
    row, column)."""
    kept = int(((idx >= 0) & (idx < T)).sum())
    return (nbytes(idx) + (kept + T) * g.shape[1] * 4,
            kept * g.shape[1])


def time_kernel(name, run_k, run_p, n_bytes, n_ops):
    """Device time (profiler), CUDA-event wall time, the plain version's
    and the bound of one recorded call."""
    bound_ms, bound_by = bound(n_bytes, n_ops)
    wall_ms, plain_wall_ms = time_pair(run_k, run_p)
    return dict(ms=device_ms(run_k, 20, name), plain_ms=device_ms(run_p, 3),
                wall_ms=wall_ms, plain_wall_ms=plain_wall_ms,
                bound_ms=bound_ms, bound_by=bound_by, bytes=n_bytes,
                ops=n_ops)


FAILURES = []   # checks of phases H and I, reported together at the end

HOLDS = {"bounce_pre_bwd": hold_pre_bwd, "bounce_post_bwd": hold_post_bwd,
         "bounce_pre_bwd_slim": hold_pre_bwd_slim,
         "bounce_post_bwd_slim": hold_post_bwd_slim}


def hold_recorded(calls, names, label):
    """Every recorded call of the backward kernels ``names`` and of the
    scatter-add against its plain version, and twice to the same bits;
    then the first call of each timed.  Returns ``{name: summary}``."""
    summary = {}
    for name in names:
        worst = 0.0
        for i, (args, out) in enumerate(calls[name]):
            spec, rest = args[0], args[1:]
            try:
                err, ulps, flips = HOLDS[name](spec, rest, out,
                                               f"{label} {name}{i}")
            except CheckFailure as e:
                FAILURES.append(str(e))
                emit(phase="bwd_kernel", run=label, kernel=name, call=i,
                     failed=str(e))
                continue
            again = KERNELS[name](*args)
            check(all(a is None or torch.equal(a, b)
                      for a, b in zip(out, again)),
                  f"{label} {name}{i}: two runs differ")
            worst = max(worst, err)
            emit(phase="bwd_kernel", run=label, kernel=name, call=i,
                 R=rest[0].shape[-1] if "slim" in name else rest[0].shape[0],
                 max_abs_err=err, ulps=ulps, rays_f32_cannot_reach=flips,
                 same_bits_twice=True)
        args, out = calls[name][0]
        spec, rest = args[0], args[1:]
        timing = time_kernel(
            name, lambda: KERNELS[name](*args),  # noqa: B023
            lambda: PLAIN[name](*args),          # noqa: B023
            *bwd_work(name, spec, rest, list(out)))
        timing.update(share=timing["bound_ms"] / timing["ms"],
                      ptxas=kernel_ptxas(LIBRARY.build_log, f"{name}_kernel"))
        emit(phase="bwd_kernel_time", run=label, kernel=name, **timing,
             gpu=smi())
        summary[name] = dict(max_abs_err=worst, timing=timing)
    worst, rows = 0.0, []
    for i, (args, _) in enumerate(calls["scatter_add"]):
        idx, g, T = args
        err, kept = hold_scatter_add(idx, g, T, f"{label} scatter_add{i}")
        worst = max(worst, err)
        rows.append(dict(call=i, N=idx.numel(), C=g.shape[1], T=T,
                         kept=kept, max_abs_err=err,
                         route=fetch_cuda.scatter_add.route(
                             T, g.shape[1], g.device)))
    emit(phase="bwd_kernel", run=label, kernel="scatter_add", calls=rows,
         same_bits_twice=True, dense_equals_ordered_plain=True)
    # the first call (the last bounce's post-stage payload rows at the live
    # rays' hits) and the one with the most kept values (rows x columns)
    first = calls["scatter_add"][0][0]
    busiest = max((args for args, _ in calls["scatter_add"]),
                  key=lambda a: int(((a[0] >= 0) & (a[0] < a[2])).sum())
                  * a[1].shape[1])
    timing = time_scatter(*first, label)
    timing["busiest"] = time_scatter(*busiest, label)
    summary["scatter_add"] = dict(max_abs_err=worst, timing=timing)
    return summary


def time_scatter(idx, g, T, label):
    """:func:`time_kernel` of one scatter-add call (``ms``: its kernels'
    device time), with its route and the whole call's device time and
    operations (``call_ms``, ``call_ops``: the zeros of its table, and on
    the sorted route the sort, too), and the library call's."""
    run_k = lambda: fetch_cuda.scatter_add(idx, g, T)   # noqa: E731
    timing = time_kernel("scatter_add", run_k,
                         lambda: PLAIN["scatter_add"](idx, g, T),
                         *scatter_work(idx, g, T))
    timing["route"] = fetch_cuda.scatter_add.route(T, g.shape[1], g.device)
    (timing["call_ms"], timing["call_ops"],
     timing["call_device_ops"]) = call_profile(run_k, 20)
    # the one PyTorch call that sums rows per index (atomics: the bits vary
    # from run to run): on the kept rows, filtered outside the timing; and
    # on all N rows, the dropped rows' ids and values set to 0 outside the
    # timing (no host sync, as a caller without the filter would)
    keep = (idx >= 0) & (idx < T)
    idx_k, g_k = idx[keep].long(), g[keep]
    idx_all = torch.where(keep, idx, 0).long()
    g_all = torch.where(keep[:, None], g, 0.0)
    out = torch.zeros((T, g.shape[1]), device=g.device)
    timing["library_ms"] = device_ms(
        lambda: out.index_add_(0, idx_k, g_k), 20)
    timing["library_all_rows_ms"] = device_ms(
        lambda: out.index_add_(0, idx_all, g_all), 20)
    timing.update(N=idx.numel(), C=g.shape[1], T=T, kept=int(keep.sum()))
    emit(phase="bwd_kernel_time", run=label, kernel="scatter_add", **timing,
         gpu=smi())
    return timing


def phase_bwd_kernel(recorded):
    """H: the recorded calls of G's 2^20-path steps against their plain
    versions.  Returns per nrx the summaries."""
    return {nrx: hold_recorded(calls, ("bounce_pre_bwd", "bounce_post_bwd"),
                               f"G nrx={nrx}")
            for nrx, calls in recorded.items()}


def phase_slim_stages(tris, dev):
    """I: ``unroll_bounces=False`` at 2^20 paths, nrx = 1.  Returns the
    launches of one step and the kernels' summaries."""
    nrx = 1
    cfgs = {unroll: calibration_config(PATHS, BOUNCES, True,
                                       unroll_bounces=unroll)
            for unroll in (True, False)}
    expected = {**{n: 0 for n in KERNELS}, "nearest_hit": 1 + 2 * BOUNCES,
                "bounce_pre": BOUNCES, "bounce_post": BOUNCES,
                "bounce_pre_bwd_slim": BOUNCES,
                "bounce_post_bwd_slim": BOUNCES,
                "scatter_add": 2 * BOUNCES + 1, "gather": 1}
    mats = default_materials(dev)
    calib_step(tris, nrx, mats, cfgs[False])                     # warm-up
    with recording_fused() as calls:
        for kern in KERNELS.values():
            kern.launches = 0
        calib_step(tris, nrx, mats, cfgs[False])
        counts = {n: kern.launches for n, kern in KERNELS.items()}
    check(counts == expected, f"I: launches {counts}, expected {expected}")
    grads = {}
    for unroll in (True, False):
        m = default_materials(dev)
        calib_step(tris, nrx, m, cfgs[unroll])
        grads[unroll] = grads_of(m)
    share = leaves_close(grads[False], grads[True], LEAF_RTOL, LEAF_ATOL,
                         "I: slim stages vs whole loop")
    times = {"stages": [], "unrolled": []}
    for unroll in (False, True, True, False):        # in turns
        times["unrolled" if unroll else "stages"].append(mean_s(
            lambda c=cfgs[unroll]: calib_step(tris, nrx, mats, c)))
    step_s = {k: sum(v) / len(v) for k, v in times.items()}
    summary = hold_recorded(calls, ("bounce_pre_bwd_slim",
                                    "bounce_post_bwd_slim"), "I nrx=1")
    emit(phase="slim_stages", nrx=nrx, paths=PATHS, launches=counts,
         grad_vs_whole_loop_max_leaf_share=share, fwd_bwd_s=step_s,
         gpu=smi())
    return {"slim_step_nrx1": counts,
            "large_table_step_nrx1": large_table_turn(tris, dev, expected)}, \
        summary


LARGE_MATERIALS = 5000   # past fused_ops.MAX_MATERIALS


def large_table_turn(tris, dev, expected):
    """I's turn with a :data:`LARGE_MATERIALS`-row material table, the
    triangles' ids drawn over all of it, under the default
    ``unroll_bounces``: the launches of one step must be ``expected`` (the
    per-stage nodes; the whole-loop backward holds at most
    ``MAX_MATERIALS`` rows), its backward calls are held as I's, and at
    2^16 paths its material gradients hold against the op path's.  Returns
    the launches."""
    nrx = 1
    rng = np.random.default_rng(LARGE_MATERIALS)
    ids = rng.integers(0, LARGE_MATERIALS, tris.pad_triangles)
    big = dataclasses.replace(tris, material=torch.as_tensor(ids, device=dev))
    table = lambda: material_table(  # noqa: E731
        LARGE_MATERIALS, np.random.default_rng(LARGE_MATERIALS), dev)
    cfg = calib_config(PATHS, nrx, True)
    mats = table()
    calib_step(big, nrx, mats, cfg)                              # warm-up
    with recording_fused() as calls:
        zero_counts()
        calib_step(big, nrx, mats, cfg)
        counts = {n: kern.launches for n, kern in KERNELS.items()}
    check(counts == expected, f"I {LARGE_MATERIALS} materials: launches "
          f"{counts}, expected {expected}")
    hold_recorded(calls, ("bounce_pre_bwd_slim", "bounce_post_bwd_slim"),
                  f"I {LARGE_MATERIALS} materials")
    del calls
    grads = {}
    for fused in (False, True):
        m = table()
        calib_step(big, nrx, m, calib_config(SMALL_PATHS, nrx, fused))
        grads[fused] = grads_of(m)
    past = float(grads[True]["a"][fused_ops.MAX_MATERIALS:].abs().max())
    check(past > 0, f"I {LARGE_MATERIALS} materials: no gradient past row "
          f"{fused_ops.MAX_MATERIALS}")
    share = leaves_close(grads[True], grads[False], PATH_GRAD_RTOL,
                         LEAF_ATOL, f"I {LARGE_MATERIALS} materials: fused "
                         "vs op-path gradients")
    emit(phase="slim_stages_large_table", nrx=nrx, paths=PATHS,
         materials=LARGE_MATERIALS, materials_hit=int(np.unique(ids).size),
         launches=counts, grad_past_max_materials_abs_max=past,
         grad_vs_op_path_max_leaf_share=share, gpu=smi())
    return counts


def city_loss_fn(res):
    """``benchmarks/config5_e2e.py``'s loss."""
    return (res.scatter.a_te.abs().square().sum()
            + res.scatter.a_tm.abs().square().sum()) * 1e9


def phase_city_grad(city, dev, f_grads):
    """J: config-5's loss through the full-gradient fused path, against
    phase F's op-path gradients ``f_grads = (materials, tx)``.  Returns the
    launches of one step."""
    cfg = TracerConfig(num_paths=PATHS, num_bounces=BOUNCES,
                       parity="physical", launch_order="coherent",
                       keep_rays=False, shade="fused")
    step = lambda: grad_step(city, rx_positions(1, CITY_RX0),  # noqa: E731
                             CITY_TX, FREQ_GHZ, cfg, city_loss_fn,
                             vertices=False)
    step()                                                       # warm-up
    zero_counts()
    _, loss, grads = step()
    launches = read_counts()
    expected = {**{n: 0 for n in launches}, "walk_prepass": 1 + 2 * BOUNCES,
                "walk": 1 + 2 * BOUNCES, "bounce_pre": BOUNCES,
                "bounce_post": BOUNCES, "bounce_pre_bwd": BOUNCES,
                "bounce_post_bwd": BOUNCES, "scatter_add": 2 * BOUNCES + 1,
                "gather": 1}
    check(launches == expected, f"J: launches {launches}")
    check_grads(grads, "J", leaves=("tx",))
    g_f, tx_f = f_grads
    share = leaves_close({**grads_of_fields(grads), "tx": grads["tx"]},
                         {**g_f, "tx": tx_f}, PATH_GRAD_RTOL, LEAF_ATOL,
                         "J: fused vs op path (F)")
    loss_value, maxima = float(loss.detach()), grad_maxima(grads)
    del grads
    wall_s = mean_s(step)
    prof = profile_window(step, "J")
    pre_bwd = city_pre_bwd(step)
    emit(phase="city_grad", paths=PATHS, bounces=BOUNCES, nrx=1,
         launches=launches, loss=loss_value, grad_abs_max=maxima,
         grad_vs_op_path_max_leaf_share=share, fwd_bwd_s=wall_s,
         profile_wall_ms=prof["wall_ms"],
         device_busy_ms=prof["device_busy_ms"],
         idle_share=prof.get("idle_share"), device_ops=prof.get("device_ops"),
         kernels=prof.get("kernels"), top_device=prof.get("top_device"),
         pre_bwd=pre_bwd, gpu=smi())
    return launches


def city_pre_bwd(step):
    """J's full pre backward calls: one step recorded, each call held
    against its plain version in float64 and timed against its bound, with
    the kernel's registers and spills."""
    with recording_fused() as calls:
        step()
    rows = []
    for i, (args, out) in enumerate(calls["bounce_pre_bwd"]):
        spec, rest = args[0], args[1:]
        label = f"J bounce_pre_bwd{i}"
        try:
            err, _, far = hold_pre_bwd(spec, rest, out, label)
        except CheckFailure as e:
            FAILURES.append(str(e))
            err, far = None, None
        bound_ms, bound_by = bound(*bwd_work("bounce_pre_bwd", spec, rest,
                                             list(out)))
        ms = device_ms(lambda: KERNELS["bounce_pre_bwd"](*args),  # noqa: B023
                       20, "bounce_pre_bwd")
        rows.append(dict(call=i, R=rest[0].shape[0], max_abs_err=err,
                         rays_f32_cannot_reach=far, ms=ms, bound_ms=bound_ms,
                         bound_by=bound_by, share=bound_ms / ms))
    return dict(calls=rows, ms_step=sum(r["ms"] for r in rows),
                ptxas=kernel_ptxas(LIBRARY.build_log, "bounce_pre_bwd_kernel"))



# --- the op path with every kernel ----------------------------------------




def pallas_config(paths, pallas, **kw):
    """The calibration flags with every gradient on the op path: with
    ``pallas`` every kernel of it (``shade="pallas", cull=True``), else the
    default op path (``shade="xla"``, the brute query)."""
    if pallas:
        kw.update(shade="pallas", cull=True)
    return grad_config(paths, False, **kw)


def op_expected(parity, pallas):
    """The launches of one op-path step: the LoS query and per bounce a
    bounce and a shadow query; the payload table's eta rows, per bounce the
    payload rows and (reference parity) the occluder normals, each gather
    with its scatter-add backward (``grad_geometry``); a shading node per
    bounce."""
    n_fetch = 1 + BOUNCES * (1 + (parity == "reference"))
    query = "nearest_hit_culled" if pallas else "nearest_hit"
    return {**{n: 0 for n in KERNELS}, query: 1 + 2 * BOUNCES,
            "gather": n_fetch, "scatter_add": n_fetch,
            "shade_a": BOUNCES if pallas else 0}


def phase_pallas_step(tris, dev):
    """N: the op path with every kernel, ``trace(shade="pallas", cull=True,
    compact_rays=True)`` with every gradient, at 2^20 paths, B = 3, nrx 1
    and 4 under reference parity and nrx 1 under physical parity; beside
    it, in turns, the default op path's step.  Returns the launches of each
    step and its recorded kernel calls (reference parity)."""
    counts, recorded = {}, {}
    for parity, nrx in (("reference", 1), ("reference", 4),
                        ("physical", 1)):
        key = f"{parity}_nrx{nrx}"
        cfgs = {p: pallas_config(PATHS, p, parity=parity)
                for p in (True, False)}
        step = lambda p: grad_step(  # noqa: E731
            tris, rx_positions(nrx), TX, FREQ_GHZ, cfgs[p])
        step(True)                                               # warm-up
        with recording_fused() as calls:
            zero_counts()
            res, loss, grads = step(True)
            counts[key] = read_counts()
        check(counts[key] == {**op_expected(parity, True),
                              "walk_prepass": 0, "walk": 0},
              f"N {key}: launches {counts[key]}")
        if parity == "reference":
            recorded[nrx] = calls
        del calls
        for f in OUTPUT_FIELDS:
            x = getattr(res.scatter, f)
            x = torch.view_as_real(x) if x.is_complex() else x
            check(bool(torch.isfinite(x).all()), f"N {key}: {f}")
        check_grads(grads, f"N {key}")
        # the default op path on the same step: gradients within 1e-4 of
        # each leaf's max, the written scatter slots agree
        zero_counts()
        res_x, loss_x, grads_x = step(False)
        counts_x = read_counts()
        check(counts_x == {**op_expected(parity, False), "walk_prepass": 0,
                           "walk": 0}, f"N {key}: op path launches {counts_x}")
        share = leaves_close(grads, grads_x, PATH_GRAD_RTOL, LEAF_ATOL,
                             f"N {key}: pallas vs xla op path")
        agree = {f: slots_agree(getattr(res_x.scatter, f),
                                getattr(res.scatter, f), f)
                 for f in OUTPUT_FIELDS}
        loss_value, maxima = float(loss.detach()), grad_maxima(grads)
        del res, loss, grads, res_x, loss_x, grads_x
        times = {"pallas": [], "xla": []}
        for p in (False, True, True, False):                    # in turns
            times["pallas" if p else "xla"].append(mean_s(
                lambda p=p: step(p)))
        prof = {("pallas" if p else "xla"): profile_window(
            lambda p=p: step(p), f"N {parity} nrx {nrx} pallas {p}")
            for p in (True, False)}
        emit(phase="pallas_step", parity=parity, nrx=nrx, paths=PATHS,
             bounces=BOUNCES, launches=counts[key],
             op_path_launches=counts_x, loss=loss_value, grad_abs_max=maxima,
             grad_vs_op_path_max_leaf_share=share, slot_agreement=agree,
             fwd_bwd_s={k: sum(v) / len(v) for k, v in times.items()},
             all_fwd_bwd_s=times, profile=prof, gpu=smi())
    return counts, recorded


def gather_work(table, idx, C):
    """(bytes, operations) of one row gather: the ids in once, the output
    out once, each table row it touches (C columns) in once."""
    rows = int(torch.unique(idx).numel())
    return nbytes(idx) + (idx.numel() + rows) * C * 4, 0


def time_gather(table, idx, C, label):
    """Device time of one gather call against its plain version's and
    ``torch.index_select``'s (the one PyTorch call that computes it), and
    its bound."""
    run_k = lambda: fetch_cuda.gather(table, idx, 0, C)   # noqa: E731
    timing = time_kernel("gather", run_k,
                         lambda: gather_plain(table, idx, 0, C),
                         *gather_work(table, idx, C))
    timing["library_ms"] = device_ms(
        lambda: torch.index_select(table, 0, idx), 20)
    plan = fetch_cuda.gather.plan(idx.numel(), table.shape[0], C,
                                  table.device)
    timing.update(N=idx.numel(), C=C, T=table.shape[0], staged=plan.staged,
                  blocks=plan.blocks)
    emit(phase="gather_time", run=label, **timing, gpu=smi())
    return timing


def phase_gather(runs, label):
    """K: every recorded gather of ``runs`` (``{run: [(args, out), ...]}``)
    held against ``table[idx]`` bit for bit; the first run's first payload
    fetch of 2^20 rows (27 columns) timed."""
    n = 0
    for run, calls in runs.items():
        for i, (args, out) in enumerate(calls):
            hold_gather(args, out, f"K {run} gather{i}")
            n += 1
    args, out = next((a, o) for a, o in next(iter(runs.values()))
                     if o.shape == (PATHS, 27))
    timing = time_gather(args[0], args[1], 27, label)
    emit(phase="gather", run=label, calls_held=n, bit_equal=True, gpu=smi())
    return timing


def phase_scatter(runs, label, route):
    """Every recorded scatter-add call of ``runs`` (``{run: [(args, out),
    ...]}``) held as H holds G's (:func:`hold_scatter_add`: the same bits
    twice, within :data:`SUM_RTOL` of float64, on the dense route the bits
    of ``scatter_add_ordered_plain``); then, of the calls on ``route``, the
    one with the most kept values (rows x columns) timed."""
    rows, worst, on_route = [], 0.0, []
    for run, calls in runs.items():
        for i, (args, _) in enumerate(calls):
            idx, g, T = args
            err, kept = hold_scatter_add(idx, g, T,
                                         f"{label} {run} scatter_add{i}")
            r = fetch_cuda.scatter_add.route(T, g.shape[1], g.device)
            worst = max(worst, err)
            rows.append(dict(run=run, call=i, N=idx.numel(), C=g.shape[1],
                             T=T, kept=kept, route=r, max_abs_err=err))
            if r == route:
                on_route.append((kept * g.shape[1], args))
    check(on_route, f"{label}: no recorded scatter-add on the {route} route")
    timing = time_scatter(*max(on_route, key=lambda c: c[0])[1],
                          f"{label} {route}")
    emit(phase="scatter", run=label, calls=rows, same_bits_twice=True,
         gpu=smi())
    return dict(max_abs_err=worst, calls=len(rows), timing=timing)


def phase_shade(recorded):
    """L: every recorded shading call of N's steps against its plain version
    on the card; the first timed."""
    worst, ulps = 0.0, {}
    for nrx, calls in recorded.items():
        for i, (args, out) in enumerate(calls["shade_a"]):
            err, u = hold_shade(args, out, f"L nrx={nrx} shade_a{i}")
            worst = max(worst, err)
            ulps[f"nrx{nrx}_call{i}"] = u
            emit(phase="shade", nrx=nrx, call=i, R=args[0].shape[0],
                 live=int(args[3].sum()), max_abs_err=err, ulps=u)
    args, out = recorded[1]["shade_a"][0]
    R = args[0].shape[0]
    timing = time_kernel(
        "shade_a", lambda: shade_cuda.shade_a(*args),
        lambda: shade_a_plain(*args), nbytes(*args, *out),
        R * PRE_OPS_PER_RAY)         # csrc/shade.cu: the pre stage's body
    timing["library_ms"] = None
    emit(phase="shade_time", R=R, **timing, gpu=smi())
    return dict(max_abs_err=worst, timing=timing)


def culled_work(o, d, tris, kw, reach, t, idx):
    """(bytes, operations) of one culled query on this run's data: 47
    operations per (live ray, triangle) in the tiles its block reaches, a
    slab test per (live ray, tile); the rays in and (t, idx) out, the
    triangles and the boxes once."""
    live = kw.get("live")
    lim = query_limits(o.shape[0], CULL_BLOCK_RAYS, t_max=kw.get("t_max"),
                       live=live, device=o.device)
    live_per_tile = (lim >= 0).reshape(-1, CULL_BLOCK_RAYS).sum(1)
    n_live = int(live_per_tile.sum())
    pairs = int((reach.sum(1) * live_per_tile).sum()) * CULL_BLOCK_TRIS
    n_ops = (NEAREST_HIT_OPS_PER_PAIR * pairs
             + SLAB_OPS * n_live * reach.shape[1])
    return (nbytes(o, d, *plain_kw(kw).values(), tris.v0, tris.e1, tris.e2,
                   kw["aabbs"], t, idx), n_ops)


def hold_culled_query(tris, o, d, kw, t, idx, label, assert_flips, ns):
    """One culled query: its answer and skip count against the plain
    version, its decisions against the brute kernel's (each flip an f64
    edge or tie case, counted).  Returns the row to report and the reach
    matrix."""
    skipped = torch.zeros(1, dtype=torch.int64, device=o.device)
    t2, i2 = nearest_hit_culled(o, d, tris, skipped=skipped, **kw)
    check(torch.equal(t2, t) and torch.equal(i2, idx),
          f"{label}: the culled kernel is not deterministic")
    reach = hold_culled(o, d, tris, kw, t, idx, int(skipped), label)
    brute_kw = {k: v for k, v in kw.items() if k != "aabbs"}
    t_b, i_b = nearest_hit(o, d, tris, **brute_kw)
    flips = int((i_b != idx).sum())
    if flips:
        assert_flips(ns, o.cpu().numpy(), d.cpu().numpy(), t_b.cpu().numpy(),
                     i_b.cpu().numpy(), t.cpu().numpy(), idx.cpu().numpy(),
                     t_rtol=0.0, label=label)
    m = (i_b == idx) & (idx >= 0)
    check(torch.equal(t[m], t_b[m]), f"{label}: t differs from the brute "
          "kernel's")
    live = kw.get("live")
    return dict(rays=o.shape[0],
                live=o.shape[0] if live is None else int(live.sum()),
                hits=int((idx >= 0).sum()), brute_flips=flips, skipped=int((~reach).sum()),
                reached=int(reach.sum()), tiles=reach.shape[1]), reach


def phase_culled(recorded, tris):
    """M (canyon): every recorded culled query of N's steps held (plain
    version: the same bits and skip count; brute kernel: flips counted and
    explained); the first bounce query and the nrx = 4 shadow query timed
    against the brute kernel."""
    assert_flips = flips_check()
    ns = types.SimpleNamespace(**{f: getattr(tris, f).cpu().numpy()
                                  for f in ("v0", "e1", "e2")})
    totals = dict(brute_flips=0, skipped=0, pairs=0, plain_bit_equal=True)
    timing = {}
    for nrx, calls in recorded.items():
        for qi, (args, (t, idx)) in enumerate(calls["nearest_hit_culled"]):
            o, d, q_tris, kw = args
            label = f"M nrx={nrx} q{qi}"
            row, reach = hold_culled_query(q_tris, o, d, kw, t, idx, label,
                                           assert_flips, ns)
            totals["brute_flips"] += row["brute_flips"]
            totals["skipped"] += row["skipped"]
            totals["pairs"] += reach.numel()
            emit(phase="culled", nrx=nrx, query=qi, **row)
            if (nrx, qi) in ((1, 1), (4, 2)):
                name = "bounce" if qi == 1 else "shadow"
                brute_kw = {k: v for k, v in kw.items() if k != "aabbs"}
                n_bytes, n_ops = culled_work(o, d, q_tris, kw, reach, t, idx)
                tk = time_kernel(
                    "nearest_hit_culled",
                    lambda: nearest_hit_culled(o, d, q_tris, **kw),  # noqa: B023
                    lambda: intersect_torch(o, d, q_tris,  # noqa: B023
                                            chunk_size=TWIN_CHUNK,
                                            **plain_kw(kw)),
                    n_bytes, n_ops)
                tk["brute_ms"] = device_ms(
                    lambda: nearest_hit(o, d, q_tris, **brute_kw),  # noqa: B023
                    20, "nearest_hit")
                tk.update(library_ms=None, rays=row["rays"],
                          live=row["live"], skipped=row["skipped"],
                          pairs=reach.numel())
                timing[name] = tk
                emit(phase="culled_time", query=name, nrx=nrx, **tk,
                     gpu=smi())
    emit(phase="culled_summary", **totals, gpu=smi())
    return dict(totals, timing=timing)
# --- the transmission modes and the models --------------------------------

# O's turns: the physical op-path step without transmission (the baseline),
# then the transmission modes (shade, and the culled query for "cull")
TRANSMISSION_TURNS = (
    ("physical", dict(mode=None, shade="xla")),
    ("xla", dict(mode="transmission", shade="xla")),
    ("pallas", dict(mode="transmission", shade="pallas")),
    ("spawn_straight", dict(mode="spawn_straight", shade="pallas")),
    ("spawn_snell", dict(mode="spawn_snell", shade="pallas")),
    ("fused", dict(mode="transmission", shade="fused")),
    ("cull", dict(mode="transmission", shade="pallas", cull=True)))
COVERAGE_CFG = dict(num_paths=4096, num_bounces=3, keep_rays=False,
                    parity="physical", transmission=True)


def turn_config(paths, spec):
    """The calibration flags of an O turn (physical parity)."""
    kw = dict(spec)
    mode = kw.pop("mode")
    if mode is None:
        return calibration_config(paths, BOUNCES, False, parity="physical",
                                  **kw)
    return transmission_config(paths, BOUNCES, mode, **kw)


def spread_s(fn, reps=3):
    """Host-clock times of ``reps`` calls of ``fn`` (which synchronises)
    after one warm-up: mean, min and max in seconds."""
    fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return dict(mean_s=sum(ts) / reps, min_s=min(ts), max_s=max(ts))


def quiet(fn):
    """``fn`` with its warnings silenced (the fused turn's fallback warns
    on every call; the recorded call checks it)."""
    def run(*a, **kw):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return fn(*a, **kw)
    return run


def check_finite_result(res, label):
    for part in ("los", "scatter"):
        for f in OUTPUT_FIELDS:
            x = getattr(getattr(res, part), f).detach()
            x = torch.view_as_real(x) if x.is_complex() else x
            check(bool(torch.isfinite(x).all()), f"{label}: {part}.{f}")


def hold_op_calls(queries, calls, label, assert_flips, ns):
    """Every kernel call recorded in one op-path step against its plain
    version, as phases 4, K, L and M hold theirs: each brute query the
    twin's bits, each gather ``table[idx]``'s bits, each scatter-add as H
    holds it, each shading call within its tier, each culled query the
    plain culled scan's bits and skip count.  Returns the calls held and
    the worst errors by kernel."""
    held, worst = {}, {}

    def note(name, err=0.0):
        held[name] = held.get(name, 0) + 1
        worst[name] = max(worst.get(name, 0.0), err)

    for i, (o, d, q_tris, kw, t_k, i_k) in enumerate(queries):
        hold_against_twin(q_tris, o, d, kw, t_k, i_k, f"{label} q{i}")
        note("nearest_hit")
    for i, (args, out) in enumerate(calls["gather"]):
        hold_gather(args, out, f"{label} gather{i}")
        note("gather")
    for i, (args, _) in enumerate(calls["scatter_add"]):
        note("scatter_add", hold_scatter_add(*args,
                                             f"{label} scatter_add{i}")[0])
    for i, (args, out) in enumerate(calls["shade_a"]):
        note("shade_a", hold_shade(args, out, f"{label} shade_a{i}")[0])
    for i, (args, (t, idx)) in enumerate(calls["nearest_hit_culled"]):
        o, d, q_tris, kw = args
        hold_culled_query(q_tris, o, d, kw, t, idx, f"{label} culled{i}",
                          assert_flips, ns)
        note("nearest_hit_culled")
    return held, worst


def busy_ratio(prof, base):
    """The device busy time of one :func:`profile_window` over another's,
    or None where either window recorded no device events."""
    if prof.get("device_busy_ms") and base.get("device_busy_ms"):
        return prof["device_busy_ms"] / base["device_busy_ms"]
    return None


def step_row(step, label):
    """The forward and forward+backward walls (mean of 3 after a warm-up,
    with min and max) and one profiler window over a step."""
    return dict(fwd=spread_s(lambda: step(False)), fwd_bwd=spread_s(step),
                profile=profile_window(step, label))


def phase_transmission(tris, dev):
    """O: the transmission modes on the canyon stand-in at 2^20 paths, B =
    3, physical parity, nrx 1 and 4, as a calibration step (bench.py's
    loss, backward to the material table).  Per turn (TRANSMISSION_TURNS):
    launches of one step (counts zeroed just before, read just after, its
    kernel calls recorded) against ``testing.transmission_launches``,
    every recorded call held against its plain version, finite outputs and
    gradients; the fused turn's fallback warning and its outputs and
    gradients equal to the xla turn's bits; the forward and step walls,
    a profiler window; at 2^16 paths the same step through
    ``backend="torch"``: slots agree, material gradients within the op
    path's tier.  Returns the launches by step and the worst errors."""
    assert_flips = flips_check()
    ns = types.SimpleNamespace(**{f: getattr(tris, f).cpu().numpy()
                                  for f in ("v0", "e1", "e2")})
    counts, worst, rows = {}, {}, {}
    for nrx in (1, 4):
        rx = rx_positions(nrx)
        xla = None
        for turn, spec in TRANSMISSION_TURNS:
            key = f"{turn}_nrx{nrx}"
            cfg = turn_config(PATHS, spec)
            mats = default_materials(dev)
            step = quiet(lambda backward=True, cfg=cfg, mats=mats, rx=rx:
                         calibration_step(tris, rx, TX, FREQ_GHZ, mats, cfg,
                                          backward=backward))
            step()                                                # warm-up
            with warnings.catch_warnings(record=True) as caught, \
                    recording() as rec, recording_fused() as calls:
                warnings.simplefilter("always")
                zero_counts()
                res, loss = calibration_step(tris, rx, TX, FREQ_GHZ, mats,
                                             cfg)
                counts[key] = read_counts()
            warned = any("transmission modes" in str(w.message)
                         for w in caught)
            check(warned == (cfg.shade == "fused"),
                  f"O {key}: fallback warning {warned}")
            check(counts[key] == transmission_launches(cfg),
                  f"O {key}: launches {counts[key]}, want "
                  f"{transmission_launches(cfg)}")
            check_finite_result(res, f"O {key}")
            grads = grads_of(mats)
            for f, g in grads.items():
                check(bool(torch.isfinite(g).all()), f"O {key}: grad {f}")
            check(float(grads["a"].abs().max()) > 0,
                  f"O {key}: material gradients zero")
            if turn == "xla":
                xla = (res, grads)
            if turn == "fused":
                for part in ("los", "scatter"):
                    for f in OUTPUT_FIELDS:
                        check(torch.equal(getattr(getattr(res, part), f),
                                          getattr(getattr(xla[0], part), f)),
                              f"O {key}: {part}.{f} differs from the xla "
                              "turn's")
                check(all(torch.equal(grads[f], xla[1][f]) for f in grads),
                      f"O {key}: gradients differ from the xla turn's")
            held, errs = hold_op_calls(rec.queries, calls, f"O {key}",
                                       assert_flips, ns)
            for k, v in errs.items():
                worst[k] = max(worst.get(k, 0.0), v)
            blocked = int(res.los_blocked.sum())
            written = int((res.scatter.a_te.abs() > 0).sum())
            loss_value = float(loss.detach())
            del rec, calls, res, loss, grads
            row = step_row(step, f"O {key}")
            # the same step at 2^16 paths through the plain query
            small = turn_config(SMALL_PATHS, spec)
            g = {}
            for backend in ("auto", "torch"):
                m = default_materials(dev)
                r, _ = quiet(calibration_step)(
                    tris, rx, TX, FREQ_GHZ, m, dataclasses.replace(
                        small, backend=backend, ray_chunk=TWIN_CHUNK))
                g[backend] = (r, grads_of(m))
            agree = {f: slots_agree(getattr(g["torch"][0].scatter, f),
                                    getattr(g["auto"][0].scatter, f), f)
                     for f in OUTPUT_FIELDS}
            share = leaves_close(g["auto"][1], g["torch"][1], PATH_GRAD_RTOL,
                                 LEAF_ATOL, f"O {key}: kernels vs torch")
            del g
            rows[key] = row
            emit(phase="transmission", turn=turn, nrx=nrx, paths=PATHS,
                 bounces=BOUNCES, launches=counts[key], calls_held=held,
                 max_abs_err=errs, los_blocked=blocked,
                 scatter_written=written, loss=loss_value,
                 small_slot_agreement=agree,
                 small_grad_max_leaf_share=share, **row, gpu=smi())
        del xla
    # the transmission step against the physical step without it
    ratio = {}
    for nrx in (1, 4):
        base, tr = rows[f"physical_nrx{nrx}"], rows[f"xla_nrx{nrx}"]
        ratio[nrx] = dict(
            wall=tr["fwd_bwd"]["mean_s"] / base["fwd_bwd"]["mean_s"],
            fwd_wall=tr["fwd"]["mean_s"] / base["fwd"]["mean_s"],
            busy=busy_ratio(tr["profile"], base["profile"]))
    emit(phase="transmission_summary", ratio_to_physical=ratio,
         worst=worst, gpu=smi())
    return counts, worst


def hold_walk_query(o, d, scene, kw, t_k, i_k, tris, label, assert_flips,
                    ns):
    """One recorded walk query held as phase B holds its nearest-mode
    queries: the prepass kernel's visit rows the plain version's, the
    walk the plain walk's bits, the brute kernel's decisions (each flip an
    f64 edge or tie case)."""
    t_max, live, ex = kw.get("t_max"), kw.get("live"), kw.get("exclude")
    check(not kw.get("any_hit"), f"{label}: an any-hit query")
    lim = query_limits(o.shape[0], scene.block_rays, t_max=t_max, live=live,
                       device=o.device)
    visits = walk_cuda.walk_prepass(o, d, lim, scene.boxes)
    check(torch.equal(visits, visit_rows(*prepass_plain(
        o, d, lim, scene.boxes, scene.block_rays))),
          f"{label}: visit rows differ from the plain version's")
    t_p, i_p = walk_plain(o, d, scene, visits, lim, exclude=ex,
                          tile_chunk=1024)
    check(torch.equal(i_p, i_k) and torch.equal(t_p.view(torch.int32),
                                                t_k.view(torch.int32)),
          f"{label}: {int((i_p != i_k).sum())} flips against the plain walk")
    t_b, i_b = nearest_hit(o, d, tris, exclude=ex, t_max=t_max, live=live)
    flips = int((i_k != i_b).sum())
    if flips:
        assert_flips(ns, o.cpu().numpy(), d.cpu().numpy(), t_b.cpu().numpy(),
                     i_b.cpu().numpy(), t_k.cpu().numpy(), i_k.cpu().numpy(),
                     t_rtol=0.0, label=label)
    m = (i_k == i_b) & (i_k >= 0)
    check(torch.equal(t_k[m], t_b[m]), f"{label}: t differs from brute")
    return dict(rays=o.shape[0], live=int((lim >= 0).sum()),
                hits=int((i_k >= 0).sum()), brute_flips=flips,
                limited=t_max is not None)


def phase_transmission_city(city, dev):
    """P: the transmission step on the config-5 city (2^20 paths, B = 3,
    nrx 1, physical parity, compact and coherent rays): every query walks,
    the shadow queries with any-hit off (the nearest blocker's row is
    read).  Launches of one step; each walk query held (prepass rows, the
    plain walk's bits, the brute kernel's decisions), each gather and
    scatter-add held; walls and a profiler window, and those of the
    physical step without transmission.  Returns the launches."""
    assert_flips = flips_check()
    ns = types.SimpleNamespace(**{f: getattr(city, f).cpu().numpy()
                                  for f in ("v0", "e1", "e2")})
    cfg = transmission_config(PATHS, BOUNCES, "transmission")
    rx = rx_positions(1, CITY_RX0)
    mats = default_materials(dev)
    step = lambda backward=True: calibration_step(  # noqa: E731
        city, rx, CITY_TX, FREQ_GHZ, mats, cfg, backward=backward)
    step()                                                        # warm-up
    with recording_walk() as rec, recording_fused() as calls:
        zero_counts()
        res, loss = step()
        counts = read_counts()
    want = transmission_launches(cfg, walk=True)
    check(counts == want, f"P: launches {counts}, want {want}")
    check_finite_result(res, "P")
    check(float(grads_of(mats)["a"].abs().max()) > 0,
          "P: material gradients zero")
    queries = [hold_walk_query(o, d, scene, kw, t, i, city, f"P q{qi}",
                               assert_flips, ns)
               for qi, (o, d, scene, kw, t, i) in enumerate(rec.queries)]
    check(len(queries) == 1 + 2 * BOUNCES, f"P: {len(queries)} queries")
    for i, (args, out) in enumerate(calls["gather"]):
        hold_gather(args, out, f"P gather{i}")
    scatter_err = max([hold_scatter_add(*args, f"P scatter_add{i}")[0]
                       for i, (args, _) in enumerate(calls["scatter_add"])]
                      or [0.0])
    held = {"walk": len(queries), "gather": len(calls["gather"]),
            "scatter_add": len(calls["scatter_add"])}
    blocked = int(res.los_blocked.sum())
    del rec, calls, res, loss
    row = step_row(step, "P city transmission")
    # the physical step without transmission (any-hit shadow walks) beside
    cfg0 = calibration_config(PATHS, BOUNCES, False, parity="physical")
    step0 = lambda backward=True: calibration_step(  # noqa: E731
        city, rx, CITY_TX, FREQ_GHZ, mats, cfg0, backward=backward)
    step0()
    zero_counts()
    step0()
    counts0 = read_counts()
    check(counts0 == transmission_launches(cfg0, walk=True),
          f"P physical: launches {counts0}")
    row0 = step_row(step0, "P city physical")
    walk_ms = {k: r["profile"]["kernels"]["walk"]["ms"]
               if "kernels" in r["profile"] else None
               for k, r in (("physical", row0), ("transmission", row))}
    emit(phase="transmission_city", paths=PATHS, bounces=BOUNCES, nrx=1,
         triangles=city.num_triangles, launches=counts, calls_held=held,
         queries=queries, scatter_add_max_abs_err=scatter_err,
         los_blocked=blocked, **row, physical=row0,
         physical_launches=counts0, walk_ms=walk_ms,
         ratio_to_physical=dict(
             wall=row["fwd_bwd"]["mean_s"] / row0["fwd_bwd"]["mean_s"],
             busy=busy_ratio(row["profile"], row0["profile"]),
             walk=(walk_ms["transmission"] / walk_ms["physical"]
                   if walk_ms["transmission"] and walk_ms["physical"]
                   else None)),
         gpu=smi())
    return counts


def phase_models(host, dev):
    """Q: ``coverage_map`` under ``transmission`` on the canyon stand-in at
    the JAX defaults (4096 paths, B = 3, 256-probe batches) over x, y in
    [-60, 60] at 2 m, 1.5 m high (3,721 probes, 15 batches, the last
    zero-padded): every cell finite, both LoS verdicts present, the first
    batch's gains those of ``trace`` + ``path_gain_db`` on its probes,
    whose trace agrees with the plain query's (slots); a third map's
    launches (counts zeroed just before: the fused forward's 45
    ``bounce_pre`` and 45 ``bounce_post``, no backward) and each of those
    calls held against its plain version; then ``run_sweep`` over the same
    probes into a temporary directory: 15 chunks, a resume computes 0, 1
    after a chunk is removed, and the chunks' LoS + scatter power is the
    map's gain.  Seconds and probes a second of each.  Returns the third
    map's launches and the held calls' largest errors."""
    cfg = TracerConfig(**COVERAGE_CFG)
    kw = dict(x_range=(-60.0, 60.0), y_range=(-60.0, 60.0), resolution=2.0,
              height=1.5, carrier_frequency_ghz=FREQ_GHZ, config=cfg,
              batch_size=256, device=dev)
    secs = []
    for _ in range(2):                  # a cold call, then a warm one
        t0 = time.perf_counter()
        grid = coverage_map(host, TX, **kw)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    n = grid.gain_db.size
    check(grid.gain_db.shape == (61, 61) and n == 3721,
          f"Q: grid {grid.gain_db.shape}")
    # one more map with its launches counted and its fused forward's calls
    # (the transmission-only instantiations, pre <0> and post <1>) held
    zero_counts()
    with recording_fused() as calls:
        coverage_map(host, TX, **kw)
        torch.cuda.synchronize()
    launches = read_counts()
    fwd = -(-n // 256) * cfg.num_bounces
    check(launches["bounce_pre"] == launches["bounce_post"] == fwd
          and launches["loop_bwd_slim"] == 0
          and all(a[0].transmission and not a[0].spawn_transmission
                  for a, _ in calls["bounce_post"]),
          f"Q: the map's fused launches {launches}")
    held = hold_fused_forward(calls, "Q")
    del calls
    check(bool(np.isfinite(grid.gain_db).all()
               and np.isfinite(grid.rms_delay).all()), "Q: non-finite cell")
    check(bool(grid.los_blocked.any() and (~grid.los_blocked).any()),
          f"Q: los_blocked all {bool(grid.los_blocked.flat[0])}")
    gx, gy = np.meshgrid(grid.x, grid.y)
    probes = np.stack([gx.ravel(), gy.ravel(),
                       np.full(n, 1.5, np.float32)], axis=-1)
    tris = flatten_scene(host, device=dev)
    with torch.no_grad():
        first = {b: trace(tris, probes[:256], TX, carrier_frequency=FREQ_GHZ,
                          config=dataclasses.replace(cfg, backend=b))
                 for b in ("auto", "torch")}
    check(np.array_equal(path_gain_db(first["auto"])[:, 0].cpu().numpy(),
                         grid.gain_db.ravel()[:256]),
          "Q: the first batch's gains differ from trace + path_gain_db")
    agree = {f: slots_agree(getattr(first["torch"].scatter, f),
                            getattr(first["auto"].scatter, f), f)
             for f in OUTPUT_FIELDS}
    del first
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as out_dir:
        scfg = SweepConfig(output_dir=out_dir, chunk_size=256,
                           carrier_frequency_ghz=FREQ_GHZ, tracer=cfg)
        t0 = time.perf_counter()
        computed = [run_sweep(host, TX, probes, scfg, device=dev)]
        sweep_s = time.perf_counter() - t0
        computed.append(run_sweep(host, TX, probes, scfg, device=dev))
        os.remove(os.path.join(out_dir, "chunk_00007.npz"))
        computed.append(run_sweep(host, TX, probes, scfg, device=dev))
        chunks = list(load_sweep_results(out_dir))
    check(computed == [15, 0, 1], f"Q: sweep computed {computed} chunks")
    check(len(chunks) == 15 and sum(c["a_te"].shape[0] for c in chunks)
          == n and chunks[0]["a_te"].shape[1:]
          == (1, cfg.num_bounces * cfg.num_paths),
          "Q: sweep chunk shapes")
    power = np.concatenate([
        (np.abs(c["los_a_te"]) ** 2).sum(-1)[:, 0]
        + (np.abs(c["a_te"]) ** 2).sum(-1)[:, 0] for c in chunks])
    gain = 10.0 * np.log10(np.maximum(power, 1e-30))
    check(np.allclose(gain, grid.gain_db.ravel(), rtol=1e-5, atol=1e-4),
          "Q: the sweep's gains differ from the coverage map's")
    emit(phase="models", probes=n, batches=-(-n // 256),
         coverage_s=secs[1], coverage_cold_s=secs[0],
         coverage_probes_per_s=n / secs[1],
         sweep_s=sweep_s, sweep_probes_per_s=n / sweep_s,
         sweep_chunks_computed=computed,
         los_blocked_share=float(grid.los_blocked.mean()),
         gain_db_range=[float(grid.gain_db.min()),
                        float(grid.gain_db.max())],
         first_batch_slot_agreement=agree, fused_launches_held=fwd,
         fused_max_abs_err=held, gpu=smi())
    return dict(launches=launches, max_abs_err=held)


# --- multi-rank tracing and the host-side modules ---------------------------

SHARDED_TIMEOUT_S = 600


def sharded_turns(fn, reps=3):
    """Walls of ``fn`` (which synchronises) after one warm-up, mean, min
    and max in seconds, and the seconds and calls spent in collectives a
    call (``parallel.sharding.COLLECTIVES``, the host clock)."""
    fn()
    walls, coll = [], []
    for _ in range(reps):
        reset_collectives()
        t0 = time.perf_counter()
        fn()
        walls.append(time.perf_counter() - t0)
        coll.append(dict(COLLECTIVES))
    return dict(mean_s=sum(walls) / reps, min_s=min(walls),
                max_s=max(walls),
                collective_s=sum(c["seconds"] for c in coll) / reps,
                collective_calls=coll[-1]["calls"],
                collective_bytes=coll[-1]["bytes"])


def max_rel(a, b):
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def grads_within(g, ref, rtol, label):
    """Each material leaf elementwise within ``rtol`` and 1e-12
    (``tests/test_sharding.py``'s form); returns the largest error as a
    share of its leaf's largest value."""
    for f in ref:
        check(torch.allclose(g[f], ref[f], rtol=rtol, atol=1e-12),
              f"{label}: {f} beyond rtol {rtol}")
    return max(max_rel(g[f], ref[f]) for f in ref)


def sharded_step(tris, rx, tx, mats, cfg, dirs, mesh=None, backward=True):
    """One trace, single-process or over ``mesh``, the calibration loss
    (sum |a_te|^2 + |a_tm|^2) 1e9 and its backward to ``mats``."""
    mats.zero_grad(set_to_none=True)
    nrx = len(rx)
    args = (tris, mats, rx, tx, np.zeros((nrx, 3), np.float32),
            np.zeros((1, 3), np.float32), FREQ_GHZ, cfg)
    with torch.set_grad_enabled(backward):
        res = (trace_paths(*args, launch_dirs=dirs) if mesh is None else
               trace_paths_sharded(*args, mesh=mesh, launch_dirs=dirs))
        loss = (res.scatter.a_te.abs().square().sum()
                + res.scatter.a_tm.abs().square().sum()) * 1e9
        if backward:
            loss.backward()
    torch.cuda.synchronize()
    return res, loss


def rank_rays(dev):
    """R1 on one rank: bench.py's step over a (rays 2 x tris 1) mesh."""
    mesh = default_mesh(2, 1, device_type=dev.type)
    host = load_hrt(CANYON) if os.path.exists(CANYON) else random_soup_scene(
        234, seed=0, extent=90.0, tri_size=8.0)
    tris = flatten_scene(host, device=dev)
    dirs = launch_directions(PATHS, "coherent", dev)
    expected = {**{n: 0 for n in read_counts()}, "nearest_hit": 1 + 2 * BOUNCES,
                "bounce_pre": BOUNCES, "bounce_post": BOUNCES,
                "loop_bwd_slim": 1, "gather": 1}
    out = {}
    for nrx in (1, 4):
        cfg = calibration_config(PATHS, BOUNCES, True)
        rx = rx_positions(nrx)
        mats = default_materials(dev)

        def step(mesh_=mesh):
            return sharded_step(tris, rx, TX, mats, cfg, dirs, mesh_)

        step()                                                   # warm-up
        zero_counts()
        res, loss = step()
        counts = read_counts()
        check(counts == expected,
              f"R1 nrx={nrx}: launches {counts}, expected {expected}")
        g = grads_of(mats)
        ref, ref_loss = step(None)
        g_ref = grads_of(mats)
        for part in ("los", "scatter"):
            for f in OUTPUT_FIELDS:
                check(torch.equal(getattr(getattr(res, part), f),
                                  getattr(getattr(ref, part), f)),
                      f"R1 nrx={nrx}: {part}.{f} differs from the single "
                      "process")
        share = grads_within(g, g_ref, 1e-5, f"R1 nrx={nrx}")
        del res, ref
        out[nrx] = dict(launches=counts, loss=float(loss.detach()),
                        single_loss=float(ref_loss.detach()),
                        grad_max_rel_err=share, outputs_bit_equal=True,
                        sharded=sharded_turns(step),
                        single=sharded_turns(lambda: step(None)))
    return out


class QueryLog:
    """Stands in for a scene access's ``intersect`` for one trace and keeps
    each answer with its mode."""

    def __init__(self, cls):
        self.cls, self.saved, self.queries = cls, cls.intersect, []

    def __enter__(self):
        saved = self.saved

        def intersect(access, o, d, t_max=None, exclude=None, live=None,
                      any_hit=False):
            t, idx = saved(access, o, d, t_max=t_max, exclude=exclude,
                           live=live, any_hit=any_hit)
            self.queries.append((t, idx, any_hit))
            return t, idx
        self.cls.intersect = intersect
        return self

    def __exit__(self, *exc):
        self.cls.intersect = self.saved


def rank_tris(dev, city_path):
    """R2 on one rank: the config-5 city over a (rays 1 x tris 2) mesh."""
    mesh = default_mesh(1, 2, device_type=dev.type)
    fields = torch.load(city_path)
    num = int(fields.pop("num_triangles"))
    tris = TriangleSoA(**{k: v.to(dev) for k, v in fields.items()},
                       num_triangles=num)
    dirs = launch_directions(PATHS, "coherent", dev)
    rx = rx_positions(1, CITY_RX0)
    # the op path on both sides: a tri-sharded access runs no fused kernel,
    # and the default would run the single process's forward through them
    cfg = TracerConfig(num_paths=PATHS, num_bounces=BOUNCES,
                       parity="physical", launch_order="coherent",
                       compact_rays=True, keep_rays=False, shade="xla")
    mats = default_materials(dev)

    def fwd(mesh_=mesh):
        return sharded_step(tris, rx, CITY_TX, mats, cfg, dirs, mesh_,
                            backward=False)

    fwd()                                                        # warm-up
    zero_counts()
    with QueryLog(TriShardedSceneAccess) as log:
        res, _ = fwd()
    counts = read_counts()
    fwd(None)
    zero_counts()
    with QueryLog(tracer_module.LocalSceneAccess) as ref_log:
        ref, _ = fwd(None)
    ref_counts = read_counts()
    check(counts == ref_counts and counts["walk"] == 1 + 2 * BOUNCES
          and counts["walk_prepass"] == 1 + 2 * BOUNCES
          and counts["nearest_hit"] == 0,
          f"R2: launches {counts}, single process {ref_counts}")
    check(len(log.queries) == len(ref_log.queries) == 1 + 2 * BOUNCES,
          f"R2: {len(log.queries)} queries")
    hits = []
    for i, ((t, idx, any_hit), (t_r, idx_r, _)) in enumerate(
            zip(log.queries, ref_log.queries)):
        if any_hit:     # any blocker within range: the decision is read
            same = torch.equal(idx >= 0, idx_r >= 0)
        else:
            same = torch.equal(idx, idx_r) and torch.equal(
                t.view(torch.int32), t_r.view(torch.int32))
        check(same, f"R2 query {i} (any_hit={any_hit}): hits differ from "
              "the single process")
        hits.append(int((idx >= 0).sum()))
    agree = {f: slots_agree(getattr(ref.scatter, f), getattr(res.scatter, f),
                            f"R2 {f}") for f in OUTPUT_FIELDS}
    bit_equal = all(torch.equal(getattr(ref.scatter, f),
                                getattr(res.scatter, f))
                    for f in OUTPUT_FIELDS)
    del log, ref_log, res, ref
    out = dict(launches=counts, query_hits=hits, slot_agreement=agree,
               outputs_bit_equal=bit_equal, fwd=sharded_turns(fwd),
               single_fwd=sharded_turns(lambda: fwd(None)))

    # one op-path backward step per payload-table mode, its scatter-adds
    # held against their plain version
    _, _ = sharded_step(tris, rx, CITY_TX, mats, cfg, dirs)
    g_ref = grads_of(mats)
    for table in ("auto", True):
        tcfg = dataclasses.replace(cfg, tri_shard_table=table)
        zero_counts()
        with recording_fused() as calls:
            sharded_step(tris, rx, CITY_TX, mats, tcfg, dirs, mesh)
            step_counts = read_counts()
            g = grads_of(mats)
        worst = 0.0
        for i, ((idx, gr, T), _) in enumerate(calls["scatter_add"]):
            err, _ = hold_scatter_add(idx, gr, T, f"R2 {table} scatter{i}")
            worst = max(worst, err)
        n_scatter = len(calls["scatter_add"])
        del calls
        key = "replicated" if table == "auto" else "masked"
        out[f"step_{key}"] = dict(
            launches=step_counts, scatter_calls_held=n_scatter,
            scatter_max_abs_err=worst,
            grad_max_rel_err=grads_within(g, g_ref, 1e-4, f"R2 {key}"),
            wall=sharded_turns(lambda: sharded_step(
                tris, rx, CITY_TX, mats, tcfg, dirs, mesh)))
    out["single_step"] = sharded_turns(lambda: sharded_step(
        tris, rx, CITY_TX, mats, cfg, dirs))
    return out


def sharded_rank(argv):
    """One of phase R's two ranks (``chip_smoke.py --sharded-rank RANK
    PORT OUT_DIR``): gloo on the first card, R1 then R2; writes its
    numbers to ``OUT_DIR/rank<RANK>.json``."""
    rank, port, out_dir = int(argv[0]), int(argv[1]), argv[2]
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    initialize_distributed(backend="gloo",
                           init_method=f"tcp://localhost:{port}",
                           world_size=2, rank=rank,
                           timeout=datetime.timedelta(seconds=300))
    t0 = time.perf_counter()
    result = dict(rank=rank, backend=dist.get_backend(),
                  route=collective_route(dist.group.WORLD,
                                         torch.zeros(1, device=dev)))
    result["rays"] = rank_rays(dev)
    result["tris"] = rank_tris(dev, os.path.join(out_dir, "city.pt"))
    result["seconds"] = time.perf_counter() - t0
    result["jax_imported"] = any(m == "jax" or m.startswith("jax.")
                                 for m in sys.modules)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def phase_sharded(city):
    """R: two ranks share the card over gloo (NCCL refuses two ranks on one
    device), each a process of this script that imports the port only.  R1
    (rays 2 x tris 1): bench.py's step on the canyon stand-in at 2^20
    paths, B = 3, nrx 1 and 4, ``shade="fused"``, backward to the material
    table: each rank's launches (#1 7, #10 3, #11 3, #16 1, the eta rows'
    gather 1), the gathered outputs the single-process step's bits, the
    material gradients within rtol 1e-5 and 1e-12.  R2 (rays 1 x tris 2):
    the config-5 city (65,536 triangles a slab: each query walks its slab),
    physical parity, 2^20 paths, nrx 1, the op-path forward: each rank's
    launches equal the single process's (#6 7, #4/#5 7), every query's
    hits after the lexicographic minimum the single process's (nearest
    mode: (t, idx) bits; any-hit shadows: the blocked decisions), outputs
    within the op path's tier; then one op-path backward step per payload
    table mode (replicated, masked), gradients within rtol 1e-4, every
    scatter-add held.  Walls a mean of 3 after a warm-up with min and max,
    and the seconds in collectives: two ranks on one card measure the
    collectives' cost, not scaling."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as out_dir:
        torch.save({**{f: getattr(city, f).cpu() for f in (
            "v0", "e1", "e2", "normal", "velocity", "material", "mesh_id")},
            "num_triangles": city.num_triangles},
            os.path.join(out_dir, "city.pt"))
        s = socket.socket()
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
        s.close()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--sharded-rank",
             str(r), str(port), out_dir], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
            env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO)
            for r in range(2)]
        logs = [[] for _ in procs]
        readers = [threading.Thread(target=lambda p=p, log=log: log.extend(
            p.stdout), daemon=True) for p, log in zip(procs, logs)]
        for t in readers:
            t.start()
        failed = None
        while failed is None and any(p.poll() is None for p in procs):
            failed = next((r for r, p in enumerate(procs)
                           if p.poll() not in (None, 0)), None)
            if time.perf_counter() - t0 > SHARDED_TIMEOUT_S:
                failed = "timeout"
            time.sleep(0.2)
        if failed is None:
            failed = next((r for r, p in enumerate(procs) if p.returncode),
                          None)
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for t in readers:
            t.join(timeout=10)
        check(failed is None, f"R: rank {failed} failed:\n" + "".join(
            logs[failed if isinstance(failed, int) else 0])[-4000:])
        ranks = []
        for r in range(2):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    check(not any(r["jax_imported"] for r in ranks), "R: a rank imported jax")
    for k in ("1", "4"):
        check(ranks[0]["rays"][k]["launches"] == ranks[1]["rays"][k][
            "launches"], f"R1 nrx={k}: the ranks' launches differ")
    for k in ("launches", "query_hits"):
        check(ranks[0]["tris"][k] == ranks[1]["tris"][k],
              f"R2: the ranks' {k} differ")
    r0 = ranks[0]
    emit(phase="sharded", ranks=2, backend=r0["backend"],
         collective_route=r0["route"],
         note="two ranks share one card: the walls show the collectives' "
              "cost, not scaling", seconds=time.perf_counter() - t0,
         rank_seconds=[r["seconds"] for r in ranks],
         rays_2x1={k: {**v, "rank1_sharded": ranks[1]["rays"][k]["sharded"]}
                   for k, v in r0["rays"].items()},
         tris_1x2=r0["tris"], rank1_tris_fwd=ranks[1]["tris"]["fwd"],
         gpu=smi())
    return r0


def phase_aux(host, dev):
    """S: the host-side modules on the card.  ``save_hrt`` then ``load_hrt``
    of the canyon stand-in (the same meshes); ``hrt-torch-trace`` (the
    CLI's ``trace_main``) on that file with ``--device cuda --metrics`` at
    2^20 paths, B = 3, nrx 1: its queries a second, its npz the arrays of
    ``api.trace`` on the same inputs, bit for bit, and the device time of
    that ``api.trace`` call (one profiler window); the native (g++) reader
    and writer against the Python ones where a C++ compiler is on PATH (a
    library that then fails to build or load fails the phase), else a
    printed skip of that part alone."""
    from hermespy_rt_tpu_torch.cli import trace_main
    from hermespy_rt_tpu_torch.scene import native, save_hrt

    out = {}
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        path = os.path.join(tmp, "canyon.hrt")
        save_hrt(host, path)
        back = load_hrt(path)
        check(back.num_meshes == host.num_meshes and all(
            np.array_equal(a.vertices, b.vertices)
            and np.array_equal(a.indices, b.indices)
            and a.material_index == b.material_index
            and np.array_equal(a.velocity, b.velocity)
            for a, b in zip(back.meshes, host.meshes)),
            "S: save_hrt -> load_hrt changed the scene")
        npz, metrics = (os.path.join(tmp, n) for n in ("p.npz", "m.jsonl"))
        rx = rx_positions(1)[0]
        args = [path, "--tx=" + ",".join(map(str, TX[0])),
                "--rx=" + ",".join(map(str, rx)), "-p", str(PATHS),
                "-b", str(BOUNCES), "--device", dev.type, "-o", npz,
                "--metrics", metrics]
        with contextlib.redirect_stdout(io.StringIO()) as cli_out:
            check(trace_main(args) == 0, "S: hrt-torch-trace failed")
        summary = json.loads(cli_out.getvalue())
        record = json.loads(open(metrics).read().splitlines()[-1])

        def api_trace():
            with torch.no_grad():
                return trace(back, [rx], TX, carrier_frequency=3.0,
                             config=TracerConfig(num_paths=PATHS,
                                                 num_bounces=BOUNCES),
                             device=dev)
        res = api_trace()
        got = np.load(npz)
        for part in ("los", "scatter"):
            for f in ("a_te", "a_tm", "tau", "freq_shift", "directions_rx",
                      "directions_tx"):
                check(np.array_equal(
                    got[f"{part}_{f}"],
                    getattr(getattr(res, part), f).cpu().numpy()),
                    f"S: the CLI's {part}_{f} differs from api.trace's")
        out["trace_device_s"] = device_ms(api_trace, 3) / 1e3
        check(out["trace_device_s"] > 0,
              "S: the profiler saw no device operation of api.trace")
        out.update(cli_queries_per_s=summary["queries_per_s"],
                   cli_wall_s=record["wall_s"], cli_queries=record["queries"],
                   scatter_nonzero=summary["scatter_nonzero"],
                   npz_equals_trace=True, hrt_roundtrip=True)
        if native.compiler() is not None:
            # a library that does not build or load fails the phase here
            native._get_lib()
            t0 = time.perf_counter()
            s_native = native.load_hrt_native(path)
            out["native_load_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            load_hrt(path)
            out["python_load_s"] = time.perf_counter() - t0
            native.save_hrt_native(s_native, os.path.join(tmp, "n.hrt"))
            check(open(os.path.join(tmp, "n.hrt"), "rb").read()
                  == open(path, "rb").read(),
                  "S: the native writer's bytes differ from save_hrt's")
            check(all(np.array_equal(a.vertices, b.vertices)
                      and np.array_equal(a.indices, b.indices)
                      for a, b in zip(s_native.meshes, back.meshes)),
                  "S: the native reader differs from load_hrt")
            out["native"] = "held"
        else:
            out["native"] = "skipped: no g++ on PATH here"
    emit(phase="aux", paths=PATHS, bounces=BOUNCES, **out, gpu=smi())
    return out


# --- the bench step that hrt-torch-bench times ------------------------------

BENCH_CLI_PATHS = 1 << 21        # bench_main's default --paths
BENCH_RUNS = ((1, 8), (4, 4), (16, 4))   # (nrx, steps timed), as bench.py


def phase_bench_cli():
    """T1: ``hrt-torch-bench`` (the CLI's ``bench_main``) at its defaults on
    the card: its one line, ``queries`` B x 2^21 x (1 + 1), a finite and
    positive rate."""
    from hermespy_rt_tpu_torch.cli import bench_main

    with contextlib.redirect_stdout(io.StringIO()) as out:
        check(bench_main([]) == 0, "T1: hrt-torch-bench failed")
    line = json.loads(out.getvalue())
    check(sorted(line) == ["queries", "rays_per_s", "wall_s"],
          f"T1: keys {sorted(line)}")
    check(line["queries"] == BOUNCES * BENCH_CLI_PATHS * 2,
          f"T1: {line['queries']} queries")
    check(math.isfinite(line["rays_per_s"]) and line["rays_per_s"] > 0,
          f"T1: rate {line['rays_per_s']}")
    emit(phase="bench_cli", **line, gpu=smi())
    return line


def bench_checked_step(step, label):
    """One step of ``step`` (a ``bench.BenchStep``) with the launch counts
    zeroed just before and read just after, held to
    ``testing.calibration_launches``; its loss finite and its material
    gradients finite and not all zero.  Returns ``(launches, loss, largest
    gradient, peak device memory in bytes)``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    res, loss = step()
    torch.cuda.synchronize()
    counts = read_counts()
    nrx = step.rx.shape[0]
    expected = {**{n: 0 for n in WALK_KERNELS},
                **calibration_launches(step.cfg, nrx)}
    check(counts == expected,
          f"{label}: launches {counts}, expected {expected}")
    loss = float(loss.detach())
    check(math.isfinite(loss) and loss > 0, f"{label}: loss {loss}")
    check_finite_result(res, label)
    check(tuple(res.scatter.a_te.shape)
          == (nrx, 1, step.cfg.num_bounces * step.cfg.num_paths),
          f"{label}: scatter shape {tuple(res.scatter.a_te.shape)}")
    g = grads_of(step.mats)
    check(all(bool(torch.isfinite(v).all()) for v in g.values()),
          f"{label}: material gradients not finite")
    gmax = max(float(v.abs().max()) for v in g.values())
    check(gmax > 0, f"{label}: material gradients all zero")
    return counts, loss, gmax, torch.cuda.max_memory_allocated()


def phase_bench(dev):
    """T2: bench.measure's walls per (nrx, shade), in turns, beside one
    held step and one profiler window each; at nrx 16 the fused path
    against the op path at 2^16 paths.  Returns each step's launches by
    ``"bench_<shade>_nrx<nrx>"``."""
    counts = {}
    for nrx, iters in BENCH_RUNS:
        choice = bench.shade_for(nrx)
        other = "xla" if choice == "fused" else "fused"
        walls = {choice: [], other: []}
        for shade in (choice, other, other, choice) * 2:
            _, dt, queries = bench.measure(PATHS, BOUNCES, nrx, iters, dev,
                                           shade)
            walls[shade].append(dt)
        for shade in (choice, other):
            label = f"T2 {shade} nrx={nrx}"
            step = bench.BenchStep(PATHS, BOUNCES, nrx, dev, shade)
            step()                                              # warm-up
            launches, loss, gmax, peak = bench_checked_step(step, label)
            counts[f"bench_{shade}_nrx{nrx}"] = launches
            prof = profile_window(step, label)
            mean = sum(walls[shade]) / len(walls[shade])
            emit(phase="bench", nrx=nrx, shade=shade,
                 bench_choice=shade == choice, paths=PATHS, bounces=BOUNCES,
                 steps_timed=iters, queries=queries, wall_s=mean,
                 wall_min_s=min(walls[shade]), wall_max_s=max(walls[shade]),
                 walls_s=walls[shade], queries_per_s=queries / mean,
                 launches=launches, loss=loss, grad_abs_max=gmax,
                 peak_memory_gb=peak / 1e9,
                 **{k: prof.get(k) for k in ("wall_ms", "device_busy_ms",
                                             "idle_share", "device_ops",
                                             "kernels")}, gpu=smi())
            del step
        torch.cuda.empty_cache()

    # at nrx 16, the fused path against the op path at 2^16 paths
    nrx, grads, scat = 16, {}, {}
    for shade in ("xla", "fused"):
        step = bench.BenchStep(SMALL_PATHS, BOUNCES, nrx, dev, shade)
        res, _ = step()
        grads[shade], scat[shade] = grads_of(step.mats), res.scatter
    share = leaves_close(grads["fused"], grads["xla"], PATH_GRAD_RTOL,
                         LEAF_ATOL, f"T2 nrx={nrx}: fused vs op-path gradients")
    agree = {f: slots_agree(getattr(scat["xla"], f),
                            getattr(scat["fused"], f), f"T2 nrx={nrx} {f}")
             for f in OUTPUT_FIELDS}
    emit(phase="bench_fused_vs_op", nrx=nrx, paths=SMALL_PATHS,
         grad_vs_op_path_max_leaf_share=share, slot_agreement_2_16=agree)
    return counts


# --- the O2I cell's drop on the fused forward's transmission variants -------

O2I_CELL = "umi_o2i131k.fwd.nrx5"
O2I_RX_SEED = 2718281828
# each mode's kernels: (pre, post) template arguments (csrc/bounce_fused.cu)
O2I_MODES = {"both": {}, "transmission": dict(spawn_transmission=False),
             "spawn_straight": dict(transmission=False)}


def o2i_deployment(dev):
    """The O2I cell's deployment, built by the benchmark's own files: the
    box city of its configuration (``rtbench/scenes/city.py``, written to a
    temporary directory under ``_build/`` and read as the cell reads it,
    Morton-sorted), its TX, frequency, paths, bounces and flags, and one
    drop of 5 RX from its entry's drawer (4 indoor, 1 outdoor)."""
    from rtbench import harness
    rt = os.path.join(REPO, "rtbench")
    cfg = harness.load_json(os.path.join(rt, "configs", "umi_o2i131k.json"))
    wl = harness.load_json(os.path.join(rt, "workloads", f"{O2I_CELL}.json"))
    entry = harness.load_module(os.path.join(rt, "entries", "forward_o2i.py"),
                                "rtbench_entry_forward_o2i")
    gen = harness.load_module(os.path.join(rt, "scenes", "city.py"),
                              "rtbench_scene_city")
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as out_dir:
        out = gen.generate(cfg["scene"], out_dir)
        tris = flatten_scene(load_scene(out["file"]), sort_triangles=True,
                             device=dev)
    t = cfg["tracer"]
    tx = np.asarray(t["tx"], np.float32)
    boxes = entry.building_boxes(out["meshes"], cfg["scene"]["n_buildings"])
    rx = entry.draw_drops(wl["traffic_params"], boxes, 1,
                          np.random.default_rng(O2I_RX_SEED), tx)[0]
    return types.SimpleNamespace(
        tris=tris, rx=rx, tx=tx, f_ghz=float(t["frequency_ghz"]),
        paths=int(t["num_paths"]), bounces=int(t["num_bounces"]),
        flags={k: t[k] for k in ("parity", "transmission",
                                 "spawn_transmission", "refraction")})


def phase_o2i(dev):
    """U: the O2I cell's drop (``compute_paths``, 2^20 paths, B = 3, 5 RX,
    the 131,072-triangle box city) under each transmission mode the fused
    forward takes: the cell's (both), ``transmission`` alone and
    ``spawn_transmission`` alone.  Each: a warm-up drop, then one with the
    launch counts zeroed just before and read just after (``bounce_pre``
    and ``bounce_post`` 3 each, no backward or scatter-add; the cell's
    mode also its walk queries and the 2 gathers of the eta rows and the
    LoS blockers) and its fused calls recorded; every call held against
    its plain version (equal decisions, values within ``ROW_RTOL``; under
    ``transmission`` an indoor RX written), then timed (profiler, 20
    launches) against ``fused_work``'s bound (the payload table's 14 MB
    counted once whole), with its live rays, written pairs and the
    instantiation's ptxas line.  Returns each mode's launches, the largest
    error per kernel and the timed rows."""
    o2i = o2i_deployment(dev)
    nrx, R, B = len(o2i.rx), o2i.paths, o2i.bounces

    def drop(**kw):
        return compute_paths(o2i.tris, o2i.rx, o2i.tx[None], None, None,
                             o2i.f_ghz, nrx, 1, R, B, device=dev,
                             **{**o2i.flags, **kw})

    queries = 1 + B * (1 + nrx // tracer_module.rx_rows_per_query(
        nrx, R, TracerConfig().rx_query_rays))
    launches, worst, timed = {}, {"bounce_pre": 0.0, "bounce_post": 0.0}, []
    for mode, kw in O2I_MODES.items():
        drop(**kw)
        torch.cuda.synchronize()
        zero_counts()
        with recording_fused() as calls:
            drop(**kw)
            torch.cuda.synchronize()
        counts = read_counts()
        launches[mode] = counts
        ran = {k: v for k, v in counts.items() if v}
        check(counts["bounce_pre"] == counts["bounce_post"] == B
              and not any(counts[n] for n in ("loop_bwd_slim", *STAGE_BWD,
                                              "scatter_add")),
              f"U {mode}: launches {ran}")
        if mode == "both":
            want = {"walk_prepass": queries, "walk": queries,
                    "bounce_pre": B, "bounce_post": B, "gather": 2}
            check(ran == want, f"U {mode}: launches {ran}, expected {want}")
        flags = {**o2i.flags, **kw}
        for name, err in hold_fused_forward(calls, f"U {mode}").items():
            worst[name] = max(worst[name], err)
        if flags["transmission"]:
            check(bool(calls["bounce_post"][0][1].write[:4].any()),
                  f"U {mode}: no indoor RX written")
        for name in ("bounce_pre", "bounce_post"):
            for i, (args, out) in enumerate(calls[name]):
                spec, rest = args[0], args[1:]
                check((spec.transmission, spec.spawn_transmission)
                      == (flags["transmission"],
                          flags["spawn_transmission"]),
                      f"U {mode}: {name} spec {spec}")
                n_bytes, n_ops = fused_work(name, spec, rest, list(out))
                bound_ms, bound_by = bound(n_bytes, n_ops)
                ms = device_ms(lambda: KERNELS[name](spec, *rest),  # noqa: B023
                               20, name)
                live = (rest[3] & (rest[4] >= 0) if name == "bounce_pre"
                        else rest[8])
                row = dict(mode=mode, kernel=name, bounce=i,
                           symbol=fused_symbol(name, spec), nrx=nrx, R=R,
                           live=int(live.sum()), ms=ms, bound_ms=bound_ms,
                           bound_by=bound_by, bytes=n_bytes, ops=n_ops,
                           share=bound_ms / ms)
                if name == "bounce_post":
                    row["written_pairs"] = int(out.write.sum())
                timed.append(row)
                emit(phase="o2i_kernel_time", **row)
        del calls
        torch.cuda.empty_cache()
    ptxas = {r["symbol"]: kernel_ptxas(LIBRARY.build_log, r["symbol"])
             for r in timed}
    emit(phase="o2i", cell=O2I_CELL, triangles=o2i.tris.num_triangles,
         nrx=nrx, paths=R, bounces=B,
         launches={m: {k: v for k, v in c.items() if v}
                   for m, c in launches.items()},
         max_abs_err=worst, ptxas=ptxas, gpu=smi())
    return dict(launches=launches, max_abs_err=worst, timed=timed,
                ptxas=ptxas)


def grads_of_fields(grads):
    return {f: grads[f] for f in MATERIAL_FIELDS}


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
    grad_counts, recorded = phase_grad_step(tris, dev)
    bwd = phase_bwd_kernel(recorded)
    del recorded
    slim_counts, slim = phase_slim_stages(tris, dev)
    op_counts, recorded = phase_pallas_step(tris, dev)
    gather = phase_gather({f"canyon nrx={nrx}": calls["gather"]
                           for nrx, calls in recorded.items()}, "canyon")
    scatter_op = phase_scatter({f"canyon nrx={nrx}": calls["scatter_add"]
                                for nrx, calls in recorded.items()}, "N",
                               "dense")
    shade = phase_shade(recorded)
    culled = phase_culled(recorded, tris)
    del recorded
    trans_counts, trans_worst = phase_transmission(tris, dev)
    del tris

    city = phase_city(dev)
    _, walk_timing = phase_walk(city, dev)
    culled["city"] = phase_city_equal(dev)
    fwd_launches = phase_city_forward(city)
    city_counts = phase_city_train(city, dev)
    f_grads, city_gathers, city_scatters = phase_city_loss(city, dev)
    gather["city"] = phase_gather({"city F": city_gathers}, "city")
    scatter_city = phase_scatter({"city F": city_scatters}, "F", "sorted")
    del city_gathers, city_scatters
    city_grad_counts = phase_city_grad(city, dev, f_grads)
    trans_counts["city_nrx1"] = phase_transmission_city(city, dev)
    models = phase_models(main_scene, dev)
    torch.cuda.empty_cache()
    sharded = phase_sharded(city)
    phase_aux(main_scene, dev)
    torch.cuda.empty_cache()
    phase_bench_cli()
    bench_counts = phase_bench(dev)
    torch.cuda.empty_cache()
    o2i = phase_o2i(dev)

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
        "shadow_live": timing["shadow_4x2^20"]["live"],
        "shadow_blocks_by_live": timing["shadow_4x2^20"]["blocks_by_live"],
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
    for name in ("walk_prepass", "walk"):
        key = "prepass" if name == "walk_prepass" else "walk"
        b, sh = walk_timing["bounce"], walk_timing["shadow"]
        rows.append({
            "name": name, "route": "cuda",
            "source": os.path.relpath(str(walk_cuda.SOURCE), REPO),
            "replaces": REPLACES[name],
            "also_replaces": (None if name == "walk_prepass" else
                              "hermespy_rt_tpu/ops/intersect_pallas.py:611"),
            "launches": fwd_launches[name] + sum(c[name] for c in
                                                 city_counts.values()),
            "launches_per_step": {"city_fwd": fwd_launches[name],
                                  **{f"city_step_nrx{n}": c[name]
                                     for n, c in city_counts.items()}},
            "max_abs_err": (0.0 if name == "walk_prepass" else
                            walk_timing["errors"]["walk_max_abs_err"]),
            "ms": b[f"{key}_ms"], "plain_ms": b[f"{key}_plain_ms"],
            "bound_ms": b[f"{key}_bound"][0],
            "bound_by": b[f"{key}_bound"][1], "library_ms": None,
            "shadow_ms": sh[f"{key}_ms"],
            "shadow_plain_ms": sh[f"{key}_plain_ms"],
            "shadow_bound_ms": sh[f"{key}_bound"][0],
            "brute_ms": b["brute_ms"],
            "brute_flips": b["brute_flips"] + sh["brute_flips"],
            "triangles": city.num_triangles,
            **({"share": b["prepass_share"],
                "all_pairs_bound_ms": b["prepass_all_pairs_bound"][0],
                "all_pairs_bound_half_rate_ms":
                    b["prepass_all_pairs_bound_half_rate"][0],
                "queries": [{k: q[k] for k in (
                    "rays", "live", "live_ray_tiles", "prepass_ms",
                    "prepass_bound", "prepass_pairs", "prepass_kept_pairs",
                    "prepass_all_pairs_bound",
                    "prepass_all_pairs_bound_half_rate")}
                    for q in walk_timing["queries"]],
                "ptxas": walk_timing["prepass_ptxas"]}
               if name == "walk_prepass" else {
                "call_ms": b["walk_call_ms"],
                "contract_bound_ms": b["contract_bound"][0],
                "queries": walk_timing["queries"],
                "ptxas": walk_timing["ptxas"]})})
    check(not FAILURES, f"{len(FAILURES)} kernel calls beyond their tier: "
          f"{FAILURES}")
    for name in ("bounce_pre_bwd", "bounce_post_bwd", "scatter_add",
                 "bounce_pre_bwd_slim", "bounce_post_bwd_slim"):
        slim_kernel = "slim" in name
        t1 = (slim if slim_kernel else bwd[1])[name]["timing"]
        slim_steps = {k: c[name] for k, c in slim_counts.items()}
        steps = (slim_steps if slim_kernel else
                 {**{f"grad_step_nrx{n}": c[name]
                     for n, c in grad_counts.items()},
                  "city_grad": city_grad_counts[name]})
        if name == "scatter_add":
            steps.update(slim_steps)
            steps.update({f"pallas_step_{k}": c[name]
                          for k, c in op_counts.items()})
        rows.append({
            "name": name, "route": "cuda",
            "source": os.path.relpath(str(
                fetch_cuda.SOURCE if name == "scatter_add"
                else fused_ops.BWD_SOURCE), REPO),
            "replaces": REPLACES[name],
            "launches": sum(steps.values()), "launches_per_step": steps,
            "max_abs_err": max(
                [slim[name]["max_abs_err"]] if slim_kernel else
                [b[name]["max_abs_err"] for b in bwd.values()]
                + ([slim[name]["max_abs_err"], scatter_op["max_abs_err"],
                    scatter_city["max_abs_err"]] if name == "scatter_add"
                   else [])),
            "ms": t1["ms"], "plain_ms": t1["plain_ms"],
            "bound_ms": t1["bound_ms"], "bound_by": t1["bound_by"],
            "library_ms": t1.get("library_ms"), "wall_ms": t1["wall_ms"],
            "plain_wall_ms": t1["plain_wall_ms"],
            **({"busiest": t1["busiest"], "op_path_all_kept":
                scatter_op["timing"], "city_sorted": scatter_city["timing"],
                "timed_routes": {
                    "first": t1["route"], "busiest": t1["busiest"]["route"],
                    "op_path_all_kept": scatter_op["timing"]["route"],
                    "city_sorted": scatter_city["timing"]["route"]},
                "op_and_city_calls_held": scatter_op["calls"]
                + scatter_city["calls"]}
               if name == "scatter_add" else {}),
            **({} if slim_kernel else {"nrx4": bwd[4][name]["timing"]})})
    op_steps = {f"pallas_step_{k}": c for k, c in op_counts.items()}
    sources = {"nearest_hit_culled": SOURCE, "gather": fetch_cuda.GATHER_SOURCE,
               "shade_a": shade_cuda.SOURCE}
    timings = {"nearest_hit_culled": culled["timing"]["bounce"],
               "gather": gather, "shade_a": shade["timing"]}
    errors = {"nearest_hit_culled": 0.0, "gather": 0.0,
              "shade_a": shade["max_abs_err"]}
    for name in ("nearest_hit_culled", "gather", "shade_a"):
        t1 = timings[name]
        steps = {k: c[name] for k, c in op_steps.items()}
        rows.append({
            "name": name, "route": "cuda",
            "source": os.path.relpath(str(sources[name]), REPO),
            "replaces": REPLACES[name],
            "launches": sum(steps.values()), "launches_per_step": steps,
            "max_abs_err": errors[name],
            "ms": t1["ms"], "plain_ms": t1["plain_ms"],
            "bound_ms": t1["bound_ms"], "bound_by": t1["bound_by"],
            "library_ms": t1["library_ms"], "wall_ms": t1["wall_ms"],
            "plain_wall_ms": t1["plain_wall_ms"],
            **({"brute_ms": t1["brute_ms"],
                "shadow": culled["timing"]["shadow"],
                "city": culled["city"]["timing"],
                "brute_flips": culled["brute_flips"]
                + culled["city"]["brute_flips"]}
               if name == "nearest_hit_culled" else {}),
            **({"city": gather["city"]} if name == "gather" else {})})
    # the transmission steps (O, P) launch kernels of this line too
    for row in rows:
        steps = {f"transmission_{k}": c[row["name"]]
                 for k, c in trans_counts.items()}
        row["launches_per_step"].update(steps)
        row["launches"] += sum(steps.values())
        if row["name"] in trans_worst:
            row["max_abs_err"] = max(row["max_abs_err"],
                                     trans_worst[row["name"]])
    # so do phase R's ranks (rank 0's; phase R held rank 1's equal)
    tris_steps = sharded["tris"]
    sharded_steps = {
        **{f"sharded_rays_nrx{k}": v["launches"]
           for k, v in sharded["rays"].items()},
        "sharded_tris_fwd": tris_steps["launches"],
        **{f"sharded_tris_{k}": tris_steps[k]["launches"]
           for k in ("step_replicated", "step_masked")}}
    for row in rows:
        steps = {k: c[row["name"]] for k, c in sharded_steps.items()}
        row["launches_per_step"].update(steps)
        row["launches"] += sum(steps.values())
        if row["name"] == "scatter_add":
            row["max_abs_err"] = max(
                row["max_abs_err"],
                *(tris_steps[k]["scatter_max_abs_err"]
                  for k in ("step_replicated", "step_masked")))
    # and phase T's steps, the bench's
    for row in rows:
        steps = {k: c[row["name"]] for k, c in bench_counts.items()}
        row["launches_per_step"].update(steps)
        row["launches"] += sum(steps.values())
    # and the fused forward's transmission variants: phase Q's third map
    # and phase U's O2I drops, each call held there, U's also timed
    variant_steps = {"coverage_map": models["launches"],
                     **{f"o2i_{m}": c for m, c in o2i["launches"].items()}}
    for row in rows:
        name = row["name"]
        steps = {k: c[name] for k, c in variant_steps.items()}
        row["launches_per_step"].update(steps)
        row["launches"] += sum(steps.values())
        if name in o2i["max_abs_err"]:
            row["max_abs_err"] = max(row["max_abs_err"],
                                     o2i["max_abs_err"][name],
                                     models["max_abs_err"][name])
            row["transmission_variants"] = [
                {**t, "ptxas": o2i["ptxas"][t["symbol"]]}
                for t in o2i["timed"] if t["kernel"] == name]
    emit(phase="profiler", **PROFILER)
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sharded-rank"]:
        sys.exit(sharded_rank(sys.argv[2:]))
    sys.exit(main())
