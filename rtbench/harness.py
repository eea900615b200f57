"""One run of one cell: set-up, a measured or a traced window, the check.

Everything is found by name: the cell in ``workloads/<cell>.json``, its
configuration in ``configs/<config>.json``, its scene generator in
``scenes/<generator>.py``, its entry point in ``entries/<entry>.py`` and
each metric's reader in ``metrics/<metric>.py``; which metrics a cell
reports is read from ``BENCHMARK.json``.  Adding a configuration, a cell
or a metric is adding files and manifest entries.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import shutil
import statistics
import sys
import tempfile
import time
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from rtbench import traffic, yardstick

RTBENCH = os.path.dirname(os.path.abspath(__file__))
BANNED = ("jax", "jaxlib", "flax", "hermespy_rt_tpu")
PROGRAM = "hermespy_rt_tpu_torch"


def banned_modules(modules=None):
    """The banned top-level names among ``modules`` (``sys.modules`` by
    default), compared whole: ``hermespy_rt_tpu_torch`` is not
    ``hermespy_rt_tpu``."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(names & set(BANNED))


def load_json(path):
    with open(path) as fh:
        return json.load(fh)


def load_module(path, name):
    """The Python file ``path`` as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(manifest: dict, workload: str, section: str):
    """The entries of ``section`` (``end_to_end`` or ``per_layer``) that
    the cell reports: those listing it, and those with no list."""
    return [m for m in manifest[section]
            if workload in m.get("workloads", [workload])]


@dataclasses.dataclass
class Cell:
    """What an entry point works from: the cell, its configuration, the
    device, the run's seed and inputs, the program's prepared scene and
    the generator's meshes for the reference."""

    name: str
    workload: dict
    config: dict
    device: torch.device
    seed: int
    inputs: dict
    scene: object
    meshes: list
    sort_triangles: bool

    @property
    def tracer(self):
        return self.config["tracer"]


def build_cell(name, seed, device, root=RTBENCH, workdir=None) -> Cell:
    """Load the cell and its configuration, generate the scene (the
    program reads it back through its own reader where it is a file) and
    draw the run's inputs."""
    from hermespy_rt_tpu_torch.api import prepare_scene
    from hermespy_rt_tpu_torch.scene import HostMesh, HostScene

    wl = load_json(os.path.join(root, "workloads", f"{name}.json"))
    cfg = load_json(os.path.join(root, "configs", f"{wl['config']}.json"))
    sc = cfg["scene"]
    gen = load_module(os.path.join(root, "scenes", f"{sc['generator']}.py"),
                      f"rtbench_scene_{sc['generator']}")
    out = gen.generate(sc, workdir)
    sort = bool(sc.get("sort_triangles", False))
    if out["file"] is not None:
        scene = prepare_scene(out["file"], sort_triangles=sort,
                              device=device)
    else:
        scene = prepare_scene(HostScene([HostMesh(v, f, material_index=m)
                                         for v, f, m in out["meshes"]]),
                              sort_triangles=sort, device=device)
    inputs = traffic.make(wl["traffic_params"], seed, out["footprints"])
    return Cell(name, wl, cfg, device, seed, inputs, scene, out["meshes"],
                sort)


def launch_counts():
    """The program's kernel launch counters by kernel name, read to find a
    profiler window that lost launches."""
    from hermespy_rt_tpu_torch.ops import (bounce_fused_cuda, intersect_cuda,
                                           walk_cuda)
    return {"nearest_hit": intersect_cuda.nearest_hit.launches,
            "nearest_hit_culled": intersect_cuda.nearest_hit_culled.launches,
            "walk_prepass": walk_cuda.walk_prepass.launches,
            "walk": walk_cuda.walk.launches,
            "bounce_pre": bounce_fused_cuda.bounce_pre.launches,
            "bounce_post": bounce_fused_cuda.bounce_post.launches}


def read_metrics(entries, ctx, root=RTBENCH):
    """``{name: {"value", "unit"}}`` of each metric whose reader finds
    something to read."""
    out = {}
    for m in entries:
        reader = load_module(os.path.join(root, "metrics", f"{m['name']}.py"),
                             "rtbench_metric_" + m["name"].replace(".", "_"))
        value = reader.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device, t_start: float, manifest: dict, root=RTBENCH,
             log=lambda *a: print(*a, file=sys.stderr)) -> dict:
    """One run: returns the result line's object (without printing)."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        torch.cuda.init()
    t_ready = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="rtbench_scene_")
    try:
        cell = build_cell(workload, seed, device, root, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    sync()
    t_scene = time.perf_counter()
    entry = load_module(os.path.join(root, "entries",
                                     f"{cell.workload['entry']}.py"),
                        f"rtbench_entry_{cell.workload['entry']}").Entry(cell)
    entry.warmup()
    sync()
    setup_s = time.perf_counter() - t_start
    log(f"rtbench: {workload} seed {seed}: set-up {setup_s:.3f} s (imports "
        f"and device {t_ready - t_start:.3f}, scene and inputs "
        f"{t_scene - t_ready:.3f}, entry and warm-up "
        f"{t_start + setup_s - t_scene:.3f})")

    ctx = SimpleNamespace(workload=workload, setup_s=setup_s, latencies=[],
                          queries=0, window_s=None, trace=None,
                          peak_bytes=None, work=None)
    failed = 0
    if trace:
        calls = int(cell.workload["trace_calls"])
        entry.plan_check(2 * calls)
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        values = []
        ctx.trace = yardstick.profiled(
            lambda i: values.append(entry.call(i)), calls, entry.spans,
            launch_counts if cuda else None)
        attempted = 2 * calls * ctx.trace.tries
        log(f"rtbench: traced {calls} calls in {ctx.trace.wall_s:.6f} s, "
            f"{len(ctx.trace.device)} device operations, windows "
            f"{ctx.trace.tries}, launches missed {ctx.trace.missed}")
    else:
        entry.plan_check(int(cell.workload["check"].get("of_first_calls",
                                                           1)))
        values, i = [], 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            t = time.perf_counter()
            values.append(entry.call(i))
            ctx.latencies.append(time.perf_counter() - t)
            i += 1
        ctx.window_s = time.perf_counter() - t0
        attempted = i
        ctx.queries = i * entry.queries_per_call
        log(f"rtbench: {i} calls in {ctx.window_s:.6f} s, median "
            f"{statistics.median(ctx.latencies) * 1e3:.4f} ms")
    failed = sum(1 for v in values if not np.all(np.isfinite(v)))
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    ctx.peak_bytes = peak

    t_check = time.perf_counter()
    checks = entry.check()
    ctx.work = entry.work()
    log(f"rtbench: check {time.perf_counter() - t_check:.3f} s")
    manifest_section = "per_layer" if trace else "end_to_end"
    metrics = read_metrics(cell_metrics(manifest, workload, manifest_section),
                           ctx, root)
    limits = cell.workload["limits"]
    correct = (attempted > 0 and failed == 0
               and all(checks[k] <= limits[k] for k in limits))
    dev_info = dict(platform="gpu" if cuda else device.type,
                    kind=(torch.cuda.get_device_name(device) if cuda
                          else "cpu"),
                    count=int(cell.workload.get("chips", 1)),
                    memory_peak_bytes=int(peak))
    result = dict(correct=bool(correct), attempted=attempted, failed=failed,
                  metrics=metrics, device=dev_info)
    if trace:
        dev_info["busy_s"] = yardstick.busy_s(ctx.trace)
        dev_info["window_s"] = ctx.trace.wall_s
        result["breakdown"] = dict(
            device_ops=yardstick.device_ops(ctx.trace),
            idle_gaps=yardstick.idle_gaps(ctx.trace))
    result["checks"] = {k: {"value": checks[k], "limit": limits[k]}
                        for k in limits}
    return result


def check_lines(result) -> list:
    """The compared numbers beside their limits, one line each."""
    return [f"check {k} {v['value']!r} limit {v['limit']!r}"
            for k, v in result["checks"].items()]


def program_home() -> Optional[str]:
    """The directory the program's package would be imported from, or
    None when it cannot be found."""
    spec = importlib.util.find_spec(PROGRAM)
    return None if spec is None or not spec.origin else os.path.dirname(
        os.path.dirname(os.path.abspath(spec.origin)))
