"""Read the numbers a cell compares, for the program over many seeds and
for the control, in one process: the readings its limits are set from.

    python3 rtbench/limits.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 4,5,6] [--out rtbench/limits.jsonl]

Per seed: the cell's set-up from that seed, a short window of the cell's
own calls (enough for the check's calls), then the check; for a control
seed the check with the reference in bfloat16 in the program's place; with
``--fault NAME --fault-seeds ...`` the program with that fault planted
under the timed path (:func:`planted`).  One JSON line per reading.  The
benchmark's runs never run this.
"""
import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

FAULTS = ("altered", "half", "stale", "still")
ALTERED = 1.001      # the TE gains of every path, where they are produced


def _te_scaled(chan, factor=1.0, keep=None):
    a_te, a_tm = chan.a_te * factor, chan.a_tm
    if keep is not None:
        a_te, a_tm = a_te * keep, a_tm * keep
    return dataclasses.replace(chan, a_te=a_te, a_tm=a_tm)


@contextlib.contextmanager
def planted(fault):
    """The program broken underneath the timed path while in the block.

    ``altered``: every path's TE gain off by 0.1% as the trace returns it;
    ``half``: a forward drop's every other path left out, a calibration's
    loss the mean over the first half of the RX; ``stale``: every forward
    drop returns the first drop's answer; ``still``: the calibration's
    optimizer step leaves the state unchanged."""
    import torch

    from hermespy_rt_tpu_torch import api
    from rtbench import harness
    saved = [(api, "compute_paths", api.compute_paths),
             (api, "trace", api.trace),
             (harness, "load_module", harness.load_module)]
    real_cp, real_tr, real_load = (x[2] for x in saved)
    first = []

    def compute_paths(*a, **k):
        los, sc = real_cp(*a, **k)
        if fault == "altered":
            sc = _te_scaled(sc, ALTERED)
        elif fault == "half":
            n = sc.a_te.shape[-1]
            keep = (torch.arange(n, device=sc.a_te.device) % 2 == 0)
            sc = _te_scaled(sc, keep=keep.to(torch.float32))
        elif fault == "stale":
            first.append((los, sc))
            los, sc = first[0]
        return los, sc

    def trace(*a, **k):
        res = real_tr(*a, **k)
        if fault == "altered":
            res = dataclasses.replace(res, scatter=_te_scaled(res.scatter,
                                                              ALTERED))
        return res

    def load_module(path, name):
        mod = real_load(path, name)
        if name == "rtbench_entry_calibration":
            if fault == "still":
                class Still(mod.OPTIMIZER):
                    def step(self):
                        return None
                mod.OPTIMIZER = Still
            elif fault == "half":
                loss = mod.calibration_loss
                mod.calibration_loss = lambda p, t, *a: loss(
                    p[:len(p) // 2], t[:len(t) // 2], *a)
        return mod

    api.compute_paths, api.trace = compute_paths, trace
    harness.load_module = load_module
    try:
        yield
    finally:
        for obj, name, val in saved:
            setattr(obj, name, val)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(workload, seeds, control_seeds, device, root=None, calls=None,
             fault=None, fault_seeds=()):
    """Yield one dict per seed: ``kind`` (program, control or the fault's
    name), ``seed`` and the compared numbers."""
    from rtbench import harness
    root = root or harness.RTBENCH
    for kind, seed in ([("program", s) for s in seeds]
                       + [("control", s) for s in control_seeds]
                       + [(fault, s) for s in fault_seeds]):
        with (planted(kind) if kind in FAULTS else contextlib.nullcontext()):
            out, secs = _reading(workload, seed, kind == "control", device,
                                 root, calls)
        yield dict(kind=kind, seed=seed, seconds=secs, **out)


def _reading(workload, seed, control, device, root, calls):
    """One seed's set-up, ``calls`` calls and check; ``(numbers, s)``."""
    import shutil
    import tempfile

    import torch

    from rtbench import harness
    t0 = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="rtbench_scene_")
    try:
        cell = harness.build_cell(workload, seed, torch.device(device), root,
                                  workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    entry = harness.load_module(
        os.path.join(root, "entries", f"{cell.workload['entry']}.py"),
        f"rtbench_entry_{cell.workload['entry']}").Entry(cell)
    entry.warmup()
    n = calls or int(cell.workload["check"].get("of_first_calls", 1))
    entry.plan_check(n)
    for i in range(n):
        entry.call(i)
    return entry.check(control=control), time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault", choices=FAULTS, default=None)
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--calls", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    ints = lambda s: [int(x) for x in s.split(",") if x]
    fh = open(args.out, "a") if args.out else None
    for r in readings(args.workload, ints(args.seeds),
                      ints(args.control_seeds), "cuda:0", calls=args.calls,
                      fault=args.fault, fault_seeds=ints(args.fault_seeds)):
        line = json.dumps(dict(workload=args.workload, **r))
        print(line, flush=True)
        if fh:
            fh.write(line + "\n")
            fh.flush()
    if fh:
        fh.close()


if __name__ == "__main__":
    main()
