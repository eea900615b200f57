"""A copy of ``rtbench/`` at sizes a CPU test run holds: 4,096 paths, a
small city, short samples.  Used by the ``test_rtbench_*`` files."""
import json
import os
import shutil
import time

RTBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(RTBENCH)
TINY_CITY = dict(n_buildings=36, sub=2, ground_sub=8, extent=150.0)


def tiny_root(dst, paths=4096) -> str:
    """Copy ``rtbench/`` into ``dst`` with the tiny sizes; returns the
    copy's path."""
    root = os.path.join(str(dst), "rtbench")
    shutil.copytree(RTBENCH, root, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    for name in os.listdir(os.path.join(root, "configs")):
        p = os.path.join(root, "configs", name)
        with open(p) as fh:
            cfg = json.load(fh)
        cfg["tracer"]["num_paths"] = paths
        if cfg["scene"]["generator"] == "city":
            cfg["scene"].update(TINY_CITY)
            cfg["tracer"]["tx"] = [-10.0, 5.0, 25.0]
        with open(p, "w") as fh:
            json.dump(cfg, fh)
    for name in os.listdir(os.path.join(root, "workloads")):
        p = os.path.join(root, "workloads", name)
        with open(p) as fh:
            wl = json.load(fh)
        chk = wl["check"]
        chk["sample_paths"] = 512
        if "of_first_calls" in chk:
            chk.update(of_first_calls=2, calls=2)
        if "reference_rays" in chk:
            chk["reference_rays"] = 16384
        wl["trace_calls"] = 1
        rx = wl["traffic_params"]["rx"]
        if rx["kind"] == "box" and rx.get("avoid_footprints"):
            rx.update(lo=[-140.0, -140.0, 1.5], hi=[140.0, 140.0, 1.5])
        with open(p, "w") as fh:
            json.dump(wl, fh)
    return root


def manifest():
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        return json.load(fh)


def run_tiny(root, workload, seed=2 ** 33 + 5, trace=False, seconds=0.5):
    """One run of ``workload`` on the CPU from the tiny copy ``root``."""
    from rtbench import harness
    return harness.run_cell(workload, seed, seconds, trace, "cpu",
                            time.perf_counter(), manifest(), root=root,
                            log=lambda *a: None)
