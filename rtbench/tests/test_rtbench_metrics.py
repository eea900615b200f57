"""The yardstick's arithmetic and the metric readers, on synthetic
traces."""
import os
import sys
from types import SimpleNamespace

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from rtbench import harness, yardstick  # noqa: E402
from rtbench.tests.tiny import RTBENCH  # noqa: E402


def reader(name):
    return harness.load_module(os.path.join(RTBENCH, "metrics",
                                            f"{name}.py"), f"m_{name}")


def trace(device, spans=(), calls=2, wall_s=1e-3, start=0.0, end=1000.0):
    return yardstick.Trace(calls, wall_s, list(device), list(spans), start,
                           end, 0, 1)


def test_bounce_shading_bytes_leave_out_the_intermediates():
    # 10 rays, 2 RX, 4 live: the state in and out (53 B a ray each way),
    # the live rays' payload rows and shadow answers, the path rows out
    n_bytes, n_ops = yardstick.bounce_shading_work(10, 2, [4])
    assert n_bytes == 2 * 10 * 53 + 4 * (108 + 2 * 8) + 10 * 2 * 37
    assert n_ops == 4 * (180 + 2 * (30 + 150))
    # the pre stage's shadow origins, distances, self-crossing terms and
    # residuals (~12 + 4 + 4 + 1 B a (ray, RX), 28 B a ray) are not in it
    with_intermediates = n_bytes + 10 * 2 * 21 + 10 * 28
    assert n_bytes < with_intermediates
    b2, _ = yardstick.bounce_shading_work(10, 2, [4, 0])
    assert b2 == n_bytes + 2 * 10 * 53 + 10 * 2 * 37


def test_bound_takes_the_larger_time():
    t, by = yardstick.bound(3.35e12, 1.0)
    assert t == pytest.approx(1.0) and by == "bytes"
    t, by = yardstick.bound(1.0, 134e12)
    assert t == pytest.approx(2.0) and by == "operations"


def test_busy_is_the_union_of_device_intervals():
    tr = trace([("k1", 0, 100), ("k2", 50, 150), ("k3", 300, 400)])
    assert yardstick.busy_s(tr) == pytest.approx(250e-6)


def test_idle_gaps_are_named_by_the_host_span():
    dev = [("k", 100, 200), ("k", 600, 700)]
    spans = [("api.trace", 0, 300), ("to_host", 300, 800)]
    tr = trace(dev, spans, start=0, end=900)
    gaps = dict(yardstick.idle_gaps(tr))
    assert gaps["api.trace"] == pytest.approx(200e-6)      # 0-100, 200-300
    assert gaps["to_host"] == pytest.approx(400e-6)        # 300-600, 700-800
    assert gaps["between_calls"] == pytest.approx(100e-6)  # 800-900
    ops = yardstick.device_ops(tr)
    assert ops == [["k", pytest.approx(200e-6)]]


def test_readers_on_a_synthetic_trace():
    dev = [("nearest_hit_kernel(...)", 0, 100), ("walk_kernel", 100, 300),
           ("walk_prepass_kernel", 300, 350), ("bounce_pre_kernel", 400, 500),
           ("bounce_post_kernel", 500, 600), ("Memset", 600, 610)]
    ctx = SimpleNamespace(trace=trace(dev, calls=2, wall_s=1e-3),
                          peak_bytes=2 ** 31, latencies=[], window_s=None,
                          work=dict(rays=1000, nrx=2, live=[500, 300, 100]))
    assert reader("device_ops_per_call").read(ctx) == 3
    assert reader("device_busy_ms").read(ctx) == pytest.approx(0.28)
    assert reader("device_idle_share").read(ctx) == pytest.approx(0.44)
    assert reader("peak_mem_gib").read(ctx) == 2
    assert reader("kernel_ms.nearest_hit").read(ctx) == pytest.approx(0.05)
    assert reader("kernel_ms.walk").read(ctx) == pytest.approx(0.125)
    b, o = yardstick.bounce_shading_work(1000, 2, [500, 300, 100])
    want = yardstick.bound(b, o)[0] / 100e-6 * 100
    assert reader("bounce_fused.roofline_pct").read(ctx) == pytest.approx(
        want)


def test_readers_find_nothing_where_nothing_ran():
    ctx = SimpleNamespace(trace=trace([("Memset", 0, 10)]), work=None,
                          peak_bytes=0, latencies=[], window_s=None)
    for name in ("kernel_ms.nearest_hit", "kernel_ms.walk",
                 "bounce_fused.roofline_pct", "peak_mem_gib",
                 "queries_per_s", "call_ms_p95"):
        assert reader(name).read(ctx) is None
    ctx.work = dict(rays=10, nrx=1, live=[1])
    assert reader("bounce_fused.roofline_pct").read(ctx) is None


def test_end_to_end_readers():
    ctx = SimpleNamespace(latencies=[i / 1000 for i in range(1, 101)],
                          window_s=2.0, queries=4e9, setup_s=7.5, trace=None)
    assert reader("queries_per_s").read(ctx) == 2e9
    assert reader("call_ms_p95").read(ctx) == pytest.approx(95.05)
    assert reader("setup_s").read(ctx) == 7.5
