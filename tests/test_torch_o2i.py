"""The outdoor-to-indoor deployment ``umi_o2i131k`` on the CPU.

The port under ``transmission``, ``spawn_transmission`` and
``refraction="straight"`` (physical parity, every other flag at its
default) against the plain reference ``rtbench/reference/transmission.py``
on the box city at ``rtbench/tests/tiny.py``'s sizes, 5 RX a drop (4
indoor, drawn by the cell's entry): every sampled path entry within the
benchmark's tolerances (``compare.mismatch_share`` 0).  The three faults
the cell's limit is set against (``rtbench/o2i_faults.py``) must read
above it.  Then the cell's RX drawer, the span ``hrt.transmit`` with the
counters ``fetch.rows``, ``fetch.values`` and ``transmit.blocker_rows``,
and the byte count behind ``gather.roofline_pct``.
"""
import _torch_threads  # noqa: F401  (first: the thread share)

import ast
import contextlib
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from hermespy_rt_tpu_torch import api  # noqa: E402
from hermespy_rt_tpu_torch.config import TracerConfig  # noqa: E402
from hermespy_rt_tpu_torch.materials import (MATERIAL_FIELDS,  # noqa: E402
                                             MaterialTable)
from hermespy_rt_tpu_torch.utils import profiling  # noqa: E402
from rtbench import compare, gather_work, harness, o2i_faults  # noqa: E402
from rtbench.check import program_sample  # noqa: E402
from rtbench.reference import tracer as ref  # noqa: E402
from rtbench.tests.tiny import RTBENCH, TINY_CITY  # noqa: E402

CELL = "umi_o2i131k.fwd.nrx5"
CFG = harness.load_json(os.path.join(RTBENCH, "configs", "umi_o2i131k.json"))
WL = harness.load_json(os.path.join(RTBENCH, "workloads", f"{CELL}.json"))
ENTRY = harness.load_module(os.path.join(RTBENCH, "entries",
                                         "forward_o2i.py"),
                            "rtbench_entry_forward_o2i")
LIMIT = WL["limits"]["path_mismatch"]
TX = np.array([-10.0, 5.0, 10.0], np.float32)    # a street of the tiny city
B = int(CFG["tracer"]["num_bounces"])
F_GHZ = float(CFG["tracer"]["frequency_ghz"])
FAULT_PATHS = 512
FLAGS = dict(parity="physical", transmission=True, spawn_transmission=True,
             refraction="straight")


@pytest.fixture(scope="module")
def city(tmp_path_factory):
    params = dict(CFG["scene"], **TINY_CITY)
    gen = harness.load_module(os.path.join(RTBENCH, "scenes", "city.py"),
                              "rtbench_scene_city")
    out = gen.generate(params, str(tmp_path_factory.mktemp("city")))
    boxes = ENTRY.building_boxes(out["meshes"], params["n_buildings"])
    rx = ENTRY.draw_drops(WL["traffic_params"], boxes, 1,
                          np.random.default_rng(7), TX)[0]
    return SimpleNamespace(
        meshes=out["meshes"], boxes=boxes, rx=rx, feet=out["footprints"],
        scene=api.prepare_scene(out["file"], sort_triangles=True,
                                device="cpu"),
        ref_scene=ref.scene_from_meshes(out["meshes"], True, "cpu"))


def _reference(city, rows, P, ids):
    dirs = torch.as_tensor(ref.launch_directions(P, "coherent"))
    return ENTRY.reference_sample(city.ref_scene, city.rx, TX, F_GHZ, dirs,
                                  ids, rows, B, torch.float32, "cpu")


def _scaled_rows(seed):
    g = np.random.default_rng(seed)
    return {f: (np.asarray(v) * g.uniform(0.8, 1.25, len(v))).tolist()
            if f in ("a", "b", "c", "d", "s", "s1_alpha") else v
            for f, v in CFG["materials"].items()}


def test_port_equals_the_reference(city):
    """4,096 paths, seeded material rows: every entry of every eighth
    path agrees, the indoor RX see the TX through a wall, and blocked
    shadow rays carry attenuated paths."""
    P = 4096
    ids = torch.arange(3, P, 8)
    rows = _scaled_rows(3)
    mats = MaterialTable({f: rows[f] for f in MATERIAL_FIELDS}, device="cpu")
    with torch.no_grad():
        res = api.trace(city.scene, city.rx, TX[None],
                        carrier_frequency=F_GHZ, materials=mats, device="cpu",
                        config=TracerConfig(num_paths=P, num_bounces=B,
                                            **FLAGS))
    got = program_sample(res.los, res.scatter, ids, B, P)
    want = _reference(city, rows, P, ids)
    bad, live = compare.mismatch_counts(got, want)
    assert bad == 0 and live > 1000, (bad, live)
    assert bool(res.los_blocked[:4, 0].all())            # indoor: a wall
    assert bool((want["los"]["te"][:4].abs() > 0).all())


@pytest.fixture(scope="module")
def fault_reference(city):
    return _reference(city, CFG["materials"], FAULT_PATHS,
                      torch.arange(FAULT_PATHS))


@pytest.mark.parametrize("fault", [None] + list(o2i_faults.FAULTS))
def test_planted_faults_fail_the_limit(city, fault_reference, fault):
    """The sound program reads 0 on the configuration's rows; with each
    fault planted under ``compute_paths`` it reads above the limit."""
    P = FAULT_PATHS
    with (o2i_faults.planted(fault) if fault
          else contextlib.nullcontext()):
        los, sc = api.compute_paths(city.scene, city.rx, TX[None], None,
                                    None, F_GHZ, len(city.rx), 1, P, B,
                                    device="cpu", **FLAGS)
    got = program_sample(los, sc, torch.arange(P), B, P)
    share = compare.mismatch_share([(got, fault_reference)])
    if fault is None:
        assert share == 0.0
    else:
        assert share > LIMIT, share


def test_rx_drawer(city):
    """4 RX inside footprints on floors 38.901 allows and below the roof
    less 1 m, 1 outside every footprint grown by 1 m, all at least 10 m
    from the TX in the plane; the same seed, the same drops."""
    tp = WL["traffic_params"]
    drops = ENTRY.draw_drops(tp, city.boxes, 64, np.random.default_rng(11),
                             TX)
    again = ENTRY.draw_drops(tp, city.boxes, 64, np.random.default_rng(11),
                             TX)
    assert drops.shape == (64, 5, 3) and np.array_equal(drops, again)
    f = city.feet

    def box_of(p, m):
        return np.flatnonzero((p[0] >= f[:, 0] - m) & (p[0] <= f[:, 2] + m)
                              & (p[1] >= f[:, 1] - m)
                              & (p[1] <= f[:, 3] + m))

    for drop in drops:
        assert np.all(np.hypot(drop[:, 0] - TX[0], drop[:, 1] - TX[1])
                      >= 10.0)
        for p in drop[:4]:
            (k,) = box_of(p, -0.999)
            floor = (p[2] - 1.5) / 3.0 + 1
            assert floor == round(floor) and 1 <= floor <= 8
            assert p[2] <= city.boxes[k, 5] - 1.0 + 1e-4
        assert len(box_of(drop[4], 0.999)) == 0 and drop[4, 2] == 1.5
    assert len({tuple(p) for p in drops[:, 0]}) == 64


def _counted(city, **flags):
    profiling.enable()
    c0 = dict(profiling.COUNTERS)
    try:
        api.compute_paths(city.scene, city.rx, TX[None], None, None, F_GHZ,
                          len(city.rx), 1, 256, B, device="cpu",
                          **dict(FLAGS, **flags))
    finally:
        profiling.disable()
    grown = {k: v - c0.get(k, 0) for k, v in profiling.COUNTERS.items()}
    spans = profiling.latest_session().spans
    # each span by its name and its parent's
    return grown, sorted((sp.name, spans[sp.parent].name) for sp in spans
                         if sp.parent is not None)


def test_transmit_span_and_counters(city):
    """Under ``transmission``: the span, and blocker rows for the LoS and
    every bounce's shadow rays; without it neither, and the gather counts
    only the payload rows."""
    nrx, R, T = len(city.rx), 256, city.scene.pad_triangles
    on, names_on = _counted(city)
    off, names_off = _counted(city, transmission=False,
                              spawn_transmission=False)
    transmit = [p for n, p in names_on if n == "hrt.transmit"]
    assert transmit == ["hrt.los"] + ["hrt.shade"] * B
    assert all(n != "hrt.transmit" for n, _ in names_off)
    assert on["transmit.blocker_rows"] == nrx + B * nrx * R
    assert off.get("transmit.blocker_rows", 0) == 0
    # the eta columns of every triangle, then 27-column payload rows: the
    # hits of every bounce, and under transmission the blockers
    assert off["fetch.rows"] == T + B * R
    assert off["fetch.values"] == 12 * T + 27 * B * R
    assert on["fetch.rows"] == T + nrx + B * (R + nrx * R)
    assert on["fetch.values"] == 12 * T + 27 * (nrx + B * (R + nrx * R))


def test_gather_bytes_and_kernel_name():
    """``gather.roofline_pct``'s bytes are the values written times 4, and
    only the program's gather kernel matches its name."""
    assert gather_work.written_bytes(12 * 131072 + 27 * 5) == 4 * (
        12 * 131072 + 27 * 5)
    ours = ["void (anonymous namespace)::gather_kernel<true>(float const*, "
            "int, int, int, int, int const*, long, int, float*)",
            "(anonymous namespace)::gather_kernel<false>(float const*, int, "
            "int, int, int, int const*, long long, int, float*)"]
    torch_ones = [
        "void at::native::vectorized_gather_kernel<16, long>(char*, char*, "
        "long*, at::native::(anonymous namespace)::OffsetCalculator<1, "
        "unsigned int, false>, long, long, long, bool)",
        "void at::native::index_elementwise_kernel<128, 4, at::native::"
        "gpu_index_kernel<at::native::index_kernel_impl<at::native::"
        "OpaqueType<4> >(at::TensorIteratorBase&, c10::ArrayRef<long>, "
        "c10::ArrayRef<long>)::{lambda(char*, char*, long)#1}>(...)",
        "void at::native::(anonymous namespace)::indexSelectLargeIndex<float,"
        " long, unsigned int, 2, 2, -2, true>(...)",
        "void at::native::_scatter_gather_elementwise_kernel<128, 8, ...>",
        "(anonymous namespace)::walk_kernel(float const*, float const*)"]
    assert all(gather_work.is_gather(k) for k in ours)
    assert not any(gather_work.is_gather(k) for k in torch_ones)


def test_reference_imports_nothing_of_the_program():
    tree = ast.parse(open(os.path.join(RTBENCH, "reference",
                                       "transmission.py")).read())
    mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names}
    mods |= {n.module or "" for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom)}
    # `from . import tracer` is the relative import of the frozen reference
    assert {m.split(".")[0] for m in mods} <= {"", "__future__", "typing",
                                               "torch"}


def _metric(name):
    return harness.load_module(os.path.join(RTBENCH, "metrics", f"{name}.py"),
                               "rtbench_metric_" + name.replace(".", "_"))


def test_new_metrics_read_nothing_without_the_programs_records(city):
    """On a program without the counters or the span (an older checkout)
    both readers return nothing; with them, the values their rules give."""
    from rtbench import yardstick
    name = ("void (anonymous namespace)::gather_kernel<true>(float const*, "
            "int, int, int, int, int const*, long, int, float*)")
    trace = yardstick.Trace(2, 1.0, [(name, 0.0, 100.0), ("x", 100.0, 400.0),
                                     (name, 500.0, 600.0)],
                            [("api.compute_paths", 0.0, 1000.0)], 0.0,
                            1000.0, 0, 1)
    gather = _metric("gather.roofline_pct")
    ctx = SimpleNamespace(trace=trace, work=None)
    assert gather.read(ctx) is None
    ctx.work = {"fetch_values": 1e8}
    want = 4e8 / yardstick.HBM_BYTES_PER_S / 100e-6 * 100.0
    assert gather.read(ctx) == pytest.approx(want)
    ctx.trace = trace._replace(device=[("x", 0.0, 1.0)])
    assert gather.read(ctx) is None
    # a session of the recorder without the span: nothing
    profiling.enable()
    try:
        api.compute_paths(city.scene, city.rx, TX[None], None, None, F_GHZ,
                          len(city.rx), 1, 64, 1, device="cpu",
                          parity="physical")
    finally:
        profiling.disable()
    assert _metric("idle_ms.transmit").read(
        SimpleNamespace(trace=trace, calls=2)) is None
