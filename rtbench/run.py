"""Run one cell of the benchmark of ``hermespy_rt_tpu_torch`` once.

    python3 rtbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with as many CUDA devices as the
cell asks for.  Prints the result as the last line of standard output (one
JSON object) and the compared numbers beside their limits as the last
lines of standard error.  Exits non-zero, printing no result, without the
devices, without the program's package in the checkout, or when a module
of JAX or of the JAX package is loaded once the window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Where the interpreter keeps no bytecode (PYTHONDONTWRITEBYTECODE, no
# __pycache__ beside the installed packages), every run compiles torch's
# sources again: on the H100 machine `import torch` reads 5.6-6.4 s so and
# 3.7-5.0 s with the bytecode kept.  The bytecode is kept in the checkout,
# at a fixed path, so that only a checkout's first run compiles it.
sys.dont_write_bytecode = False
sys.pycache_prefix = os.path.join(ROOT, "_rtbench_pycache")


def fail(msg):
    print(f"rtbench: {msg}", file=sys.stderr)
    sys.exit(2)


def power_limit():
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e})"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    manifest_path = os.path.join(ROOT, "BENCHMARK.json")
    if not os.path.exists(manifest_path):
        fail(f"no BENCHMARK.json in {ROOT}")
    with open(manifest_path) as fh:
        manifest = json.load(fh)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if args.workload not in cells:
        fail(f"no cell {args.workload!r} in BENCHMARK.json")
    chips = int(cells[args.workload]["chips"])

    import torch
    from rtbench import harness
    if not torch.cuda.is_available():
        fail("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        fail(f"{torch.cuda.device_count()} CUDA devices, the cell asks for "
             f"{chips}")
    home = harness.program_home()
    if home != ROOT:
        fail(f"the program's package is not in this checkout ({home})")

    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda:0", T_START, manifest)
    found = harness.banned_modules()
    if found:
        fail(f"modules of JAX or the JAX package loaded: {found}")
    print(f"rtbench: card {power_limit()}", file=sys.stderr)
    for line in harness.check_lines(result):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))


if __name__ == "__main__":
    main()
