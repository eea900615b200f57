#!/usr/bin/env python
"""Profile two op-path steps of the PyTorch port on one NVIDIA GPU, for one
or more checkouts of the repo in turns.

    python3 scripts/profile_op_steps.py --tree OLD --tree . --order 0110

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
  materials, the RX and TX positions, the frequency and the vertices).

Per step: the host-clock wall of 3 steps after two warm-ups, then one
torch.profiler window over one step: wall, device busy, device operations,
idle share (``1 - busy / wall``), and the device time and operations of the
row gather, the scatter-add and the sorts.  Then single calls of the
scatter-add and the gather at the steps' shapes (``calls``: 2^20 rows of 27
columns, seeded, runs of 64 equal ids): the scatter-add into the canyon's
256 rows with the first 7,699 rows kept (as G's first call) and with every
row kept (as N's payload backward), and into the city's 131,072 rows with
every row kept; the gather of 2^20 rows from 256.  For each, the whole
call's device time and device operations per call, over 20 calls after a
warm-up.  One JSON line per process, then
a summary per tree (the means of its turns), the card's name and power
limit.  Exits non-zero without a CUDA device.
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
NAMED = ("gather", "scatter_add", "sort")


def smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


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

    def ms(e):
        us = getattr(e, "self_device_time_total", None)
        return (e.self_cuda_time_total if us is None else us) / 1e3

    busy = sum(ms(e) for e in rows)
    named = {}
    for name in NAMED:
        ev = [e for e in rows if name in e.key.lower()]
        named[name] = dict(ms=sum(ms(e) for e in ev),
                           ops=sum(e.count for e in ev))
    return dict(wall_ms=wall_ms, device_busy_ms=busy,
                device_ops=sum(e.count for e in rows),
                idle_share=1.0 - busy / wall_ms if rows else None,
                named=named)


def calls(torch, fetch_cuda, dev):
    """Whole-call device time and operations of single scatter-add and
    gather calls (see the module docstring)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        us = sum(getattr(e, "self_device_time_total", None)
                 or e.self_cuda_time_total for e in rows)
        out[name] = dict(call_ms=us / 1e3 / 20,
                         call_ops=sum(e.count for e in rows) / 20)
    return out


def child(tree):
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    import hermespy_rt_tpu_torch as pkg
    from hermespy_rt_tpu_torch import default_materials, trace
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

    def n_step():
        mats = default_materials(dev)
        v0 = tris.v0.detach().clone().requires_grad_(True)
        leaves = [torch.tensor(x, device=dev, requires_grad=True)
                  for x in (RX, TX, FREQ_GHZ)]
        res = trace(dataclasses.replace(tris, v0=v0), leaves[0], leaves[1],
                    carrier_frequency=leaves[2], config=n_cfg,
                    materials=mats)
        grad_loss(res).backward()
        torch.cuda.synchronize()

    out = dict(tree=tree, gpu=smi())
    for name, step in (("phase9", op_step), ("N", n_step)):
        step()
        step()                                                  # warm-ups
        t0 = time.perf_counter()
        for _ in range(3):
            step()
        out[name] = dict(wall_mean_ms=(time.perf_counter() - t0) / 3 * 1e3,
                         profile=window(torch, step))
    out["calls"] = calls(torch, fetch_cuda, dev)
    print(json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=None)
    ap.add_argument("--order", default=None)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        return child(args.child)
    trees = args.tree or ["."]
    order = [int(c) for c in (args.order or "0" * len(trees))]
    runs = []
    for i in order:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--child", trees[i]], capture_output=True,
                              text=True, timeout=900)
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
            sys.exit(f"profile_op_steps: tree {trees[i]} failed")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    summary = {}
    for tree in trees:
        mine = [r for r in runs if r["tree"] == tree]
        if not mine:
            continue

        def mean(get):
            return sum(get(r) for r in mine) / len(mine)

        summary[tree] = {"turns": len(mine)}
        for step in ("phase9", "N"):
            summary[tree][step] = {
                key: mean(lambda r: r[step]["profile"][key])
                for key in ("wall_ms", "device_busy_ms", "device_ops",
                            "idle_share")}
            summary[tree][step]["wall_mean_ms"] = mean(
                lambda r: r[step]["wall_mean_ms"])
        summary[tree]["calls"] = {
            c: {k: mean(lambda r: r["calls"][c][k])
                for k in ("call_ms", "call_ops")}
            for c in mine[0]["calls"]}
    print(json.dumps({"summary": summary}), flush=True)
    print(smi(), flush=True)


if __name__ == "__main__":
    main()
