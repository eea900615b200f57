"""Command-line entry points of the PyTorch port.

The counterparts of :mod:`hermespy_rt_tpu.cli`'s ``hrt-convert``,
``hrt-trace`` and ``hrt-bench``, with the same flags, npz keys and output
line: ``hrt-torch-convert`` writes a Sionna/Mitsuba XML, PLY or HRT scene as
HRT; ``hrt-torch-trace`` traces one scene and writes the channel as an npz,
optionally a PNG of the rays, a metrics record (on a card with the device
time a trace) and a profiler window with the program's spans
(``--profile DIR``, :func:`.utils.profiling.profile_trace`);
``hrt-torch-bench`` times the material-calibration step of :mod:`.bench`
and prints ``{"rays_per_s", "wall_s", "queries"}``.
``--backend`` takes the port's nearest-hit choices and ``--device`` the
device to run on, the card by default.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

__all__ = ["convert_main", "trace_main", "bench_main"]


def convert_main(argv=None):
    p = argparse.ArgumentParser(
        prog="hrt-torch-convert",
        description="Convert a Sionna/Mitsuba XML scene (or PLY) to HRT.")
    p.add_argument("scene", help="input scene (.xml, .ply or .hrt)")
    p.add_argument("-o", "--output", default="scene.hrt",
                   help="output HRT path (default: scene.hrt, as the "
                        "reference converter)")
    args = p.parse_args(argv)

    from .scene import load_scene, save_hrt
    scene = load_scene(args.scene)
    save_hrt(scene, args.output)
    print(json.dumps({"output": args.output, "num_meshes": scene.num_meshes,
                      "num_triangles": scene.num_triangles}))
    return 0


def _vectors(items, n=None):
    if items is None:
        return np.zeros((n, 3), np.float32)
    return np.array([[float(v) for v in it.split(",")] for it in items],
                    np.float32)


def trace_main(argv=None):
    p = argparse.ArgumentParser(
        prog="hrt-torch-trace",
        description="Trace multipath channels in a scene.")
    p.add_argument("scene", help="scene file (.hrt, .xml, .ply)")
    p.add_argument("--tx", action="append", required=True,
                   help="TX position 'x,y,z' (repeatable)")
    p.add_argument("--rx", action="append", required=True,
                   help="RX position 'x,y,z' (repeatable)")
    p.add_argument("--tx-vel", action="append", default=None,
                   help="TX velocity 'x,y,z' (repeatable, default 0)")
    p.add_argument("--rx-vel", action="append", default=None,
                   help="RX velocity 'x,y,z' (repeatable, default 0)")
    p.add_argument("-f", "--frequency", type=float, default=3.0,
                   help="carrier frequency in GHz (default 3.0)")
    p.add_argument("-p", "--paths", type=int, default=10000)
    p.add_argument("-b", "--bounces", type=int, default=3)
    p.add_argument("--parity", choices=["reference", "physical"],
                   default="reference")
    p.add_argument("--backend", choices=["auto", "torch", "cuda"],
                   default="auto",
                   help="nearest-hit query: the kernel's wrapper ('auto', "
                        "'cuda') or plain torch ('torch')")
    p.add_argument("--device", default="cuda",
                   help="device to trace on (default cuda)")
    p.add_argument("-o", "--output", default=None, help="output .npz path")
    p.add_argument("--render", default=None,
                   help="render scene + rays to this image file")
    p.add_argument("--metrics", default=None, help="append metrics JSONL here")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="trace once more in a profiler window and write it, "
                        "the program's spans in it, as a Chrome trace "
                        "into DIR")
    args = p.parse_args(argv)

    tx = _vectors(args.tx)
    rx = _vectors(args.rx)
    txv = _vectors(args.tx_vel, len(tx))
    rxv = _vectors(args.rx_vel, len(rx))

    import torch

    from .api import trace
    from .config import TracerConfig
    from .scene import load_scene
    from .utils.profiling import (device_to_numpy, log_metrics,
                                  profile_trace, time_trace)

    cfg = TracerConfig(num_paths=args.paths, num_bounces=args.bounces,
                       parity=args.parity, backend=args.backend)
    scene = load_scene(args.scene)

    def run():
        with torch.no_grad():
            return trace(scene, rx, tx, rxv, txv, args.frequency, config=cfg,
                         device=args.device)

    result = run()
    los, scat = result.los, result.scatter
    los_a_te = device_to_numpy(los.a_te)
    scat_a_te = device_to_numpy(scat.a_te)
    summary = {
        "scene": args.scene,
        "num_rx": len(rx), "num_tx": len(tx),
        "num_paths": args.paths, "num_bounces": args.bounces,
        "los_active": int(np.sum(np.abs(los_a_te) > 0)),
        "scatter_nonzero": int(np.sum(np.abs(scat_a_te) > 0)),
        "scatter_slots": int(scat_a_te.size),
    }

    if args.output:
        np.savez(
            args.output,
            los_a_te=los_a_te,
            los_a_tm=device_to_numpy(los.a_tm),
            los_tau=device_to_numpy(los.tau),
            los_freq_shift=device_to_numpy(los.freq_shift),
            los_directions_rx=device_to_numpy(los.directions_rx),
            los_directions_tx=device_to_numpy(los.directions_tx),
            scatter_a_te=scat_a_te,
            scatter_a_tm=device_to_numpy(scat.a_tm),
            scatter_tau=device_to_numpy(scat.tau),
            scatter_freq_shift=device_to_numpy(scat.freq_shift),
            scatter_directions_rx=device_to_numpy(scat.directions_rx),
            scatter_directions_tx=device_to_numpy(scat.directions_tx),
        )
        summary["output"] = args.output

    if args.render:
        from .viz import save_rays_figure
        save_rays_figure(scene, result.rays_scatter, args.render)
        summary["render"] = args.render

    if args.metrics:
        stats = time_trace(run, num_paths=args.paths,
                           num_bounces=args.bounces, num_rx=len(rx),
                           num_tx=len(tx))
        log_metrics(stats, extra={"scene": args.scene,
                                  "device": args.device},
                    path=args.metrics)
        summary["queries_per_s"] = stats.queries_per_s

    if args.profile:
        with profile_trace(args.profile) as prof:
            run()
        summary["profile"] = prof.trace_path

    print(json.dumps(summary))
    return 0


def bench_main(argv=None):
    p = argparse.ArgumentParser(
        prog="hrt-torch-bench",
        description="Throughput of the material-calibration step.")
    p.add_argument("--paths", type=int, default=1 << 21)
    p.add_argument("--bounces", type=int, default=3)
    p.add_argument("--device", default="cuda",
                   help="device to run on (default cuda)")
    args = p.parse_args(argv)

    from .bench import measure
    value, dt, queries = measure(num_paths=args.paths,
                                 num_bounces=args.bounces, device=args.device)
    print(json.dumps({"rays_per_s": value, "wall_s": dt, "queries": queries}))
    return 0


if __name__ == "__main__":
    sys.exit(trace_main())
