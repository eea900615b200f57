"""Faults of the transmission modes that the check of an outdoor-to-indoor
cell must catch, planted under the timed path, and their readings.

    python3 rtbench/o2i_faults.py --workload umi_o2i131k.fwd.nrx5 \
        --fault no_transmission --seeds 1,2,3 [--out rtbench/limits.jsonl]

``no_transmission``: every drop traced with ``transmission=False`` (a
blocked path is zeroed, not attenuated); ``no_spawn``: with
``spawn_transmission=False`` (every ray reflects); ``any_hit``: every
query with a range (the LoS and the shadow rays) answered by the walk with
``any_hit``, which may name any blocker within the range and not the
nearest, whose row the attenuation reads.  Per seed, as
:func:`rtbench.limits.readings` does: the cell's set-up, the calls the
check draws from, the check; one JSON line a reading.  The benchmark's
runs never run this.
"""
import argparse
import contextlib
import json
import os
import sys

FAULTS = ("no_transmission", "no_spawn", "any_hit")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def planted(fault):
    """The program broken underneath the timed path while in the block."""
    from hermespy_rt_tpu_torch import api, tracer
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    real_cp = api.compute_paths
    real_isect = tracer.LocalSceneAccess.intersect
    flags = dict(no_transmission=dict(transmission=False),
                 no_spawn=dict(spawn_transmission=False),
                 any_hit=dict(walk=True))[fault]

    def compute_paths(*a, **k):
        return real_cp(*a, **dict(k, **flags))

    def intersect(self, o, d, t_max=None, exclude=None, live=None,
                  any_hit=False):
        return real_isect(self, o, d, t_max=t_max, exclude=exclude,
                          live=live, any_hit=any_hit or t_max is not None)

    api.compute_paths = compute_paths
    if fault == "any_hit":
        tracer.LocalSceneAccess.intersect = intersect
    try:
        yield
    finally:
        api.compute_paths = real_cp
        tracer.LocalSceneAccess.intersect = real_isect


def readings(workload, fault, seeds, device, root=None, calls=None):
    """Yield one dict per seed: ``kind`` (the fault), ``seed`` and the
    compared numbers."""
    from rtbench import harness, limits
    root = root or harness.RTBENCH
    for seed in seeds:
        with planted(fault):
            out, secs = limits._reading(workload, seed, False, device, root,
                                        calls)
        yield dict(kind=fault, seed=seed, seconds=secs, **out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fault", choices=FAULTS, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--calls", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    seeds = [int(x) for x in args.seeds.split(",") if x]
    with contextlib.ExitStack() as stack:
        fh = stack.enter_context(open(args.out, "a")) if args.out else None
        for r in readings(args.workload, args.fault, seeds, "cuda:0",
                          calls=args.calls):
            line = json.dumps(dict(workload=args.workload, **r))
            print(line, flush=True)
            if fh:
                fh.write(line + "\n")
                fh.flush()


if __name__ == "__main__":
    main()
