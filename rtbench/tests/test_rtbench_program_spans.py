"""The program's spans on the device trace's clock (``program_spans``) and
the ``idle_ms.*`` readers, on synthetic traces and sessions."""
import os
import sys
from types import SimpleNamespace

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from rtbench import harness, program_spans, yardstick  # noqa: E402
from rtbench.tests.tiny import RTBENCH  # noqa: E402


def sp(name, call, parent, start_us, end_us):
    return SimpleNamespace(name=name, call=call, parent=parent,
                           start_ns=int(start_us * 1e3),
                           end_ns=int(end_us * 1e3))


def session(calls, offset_us):
    """Per call ``c`` (the window's API spans start at 1000 c us): a root
    of 400 us, a prepare of 100, one bounce of 200 holding an intersect of
    100, and a backward of 100 after the root, all on a clock
    ``offset_us`` ahead of the trace's."""
    spans = []
    for c in range(calls):
        t = 1000 * c + offset_us
        r = len(spans)
        spans += [sp("hrt.api", c + 1, None, t, t + 400),
                  sp("hrt.prepare", c + 1, r, t + 10, t + 110),
                  sp("hrt.bounce", c + 1, r, t + 150, t + 350),
                  sp("hrt.intersect", c + 1, r + 2, t + 160, t + 260),
                  sp("hrt.backward", c + 1, None, t + 500, t + 600)]
    return SimpleNamespace(spans=spans, finished=lambda: spans)


def trace(calls, device, api="api.trace"):
    spans = [(api, 1000.0 * c, 1000.0 * c + 450) for c in range(calls)]
    return yardstick.Trace(calls, calls * 1e-3, device, spans, 0.0,
                           1000.0 * calls, 0, 1)


def reader(name):
    return harness.load_module(os.path.join(RTBENCH, "metrics",
                                            f"{name}.py"), f"m_{name}")


def test_anchoring_puts_each_call_on_the_trace_clock():
    spans = program_spans.anchored(trace(2, []), session(2, 7.5e6))
    assert spans[0] == ("hrt.api", 0.0, 400.0, None)
    assert spans[3] == ("hrt.intersect", 160.0, 260.0, 2)
    assert spans[4] == ("hrt.backward", 500.0, 600.0, None)
    assert spans[5][:3] == ("hrt.api", 1000.0, 1400.0)
    assert spans[8][3] == 7           # parents index this list


def test_idle_goes_to_the_innermost_span():
    # per call the device is busy 50-120 and 200-300 us: idle 0-10 in the
    # root, 10-50 in its prepare, 120-150 in the root, 150-160 in the
    # bounce, 160-200 in its intersect, 300-350 in the bounce, 350-400 in
    # the root, 400-450 under the benchmark's span alone, 500-600 in the
    # backward
    dev = [k for c in range(2) for k in (("k", 1000 * c + 50, 1000 * c + 120),
                                         ("k", 1000 * c + 200,
                                          1000 * c + 300))]
    tr = trace(2, dev)
    split = program_spans.split_idle(
        tr, program_spans.anchored(tr, session(2, 3e5)))
    inner = {k: v * 1e6 / 2 for k, v in split["innermost"].items()}
    depth = {k: v * 1e6 / 2 for k, v in split["any_depth"].items()}
    assert inner == pytest.approx({"hrt.api": 10 + 30 + 50,
                                   "hrt.prepare": 40,
                                   "hrt.bounce": 10 + 50,
                                   "hrt.intersect": 40,
                                   "hrt.backward": 100})
    assert depth["hrt.api"] == pytest.approx(230)
    assert depth["hrt.bounce"] == pytest.approx(100)
    assert depth["hrt.prepare"] + depth["hrt.bounce"] <= depth["hrt.api"]
    # the whole window's idle, of which the benchmark's own span holds
    # what lies under hrt.api and 400-450 besides
    gaps = dict(yardstick.idle_gaps(tr))
    assert gaps["api.trace"] * 1e6 / 2 == pytest.approx(230 + 50)


def test_readers(monkeypatch):
    dev = [("k", 1000 * c + 50, 1000 * c + 120) for c in range(2)]
    monkeypatch.setattr(program_spans, "latest_session",
                        lambda: session(2, 0.0))
    ctx = SimpleNamespace(trace=trace(2, dev, "api.compute_paths"))
    assert reader("idle_ms.api").read(ctx) == pytest.approx(0.33)
    assert reader("idle_ms.prepare").read(ctx) == pytest.approx(0.04)
    assert reader("idle_ms.bounce").read(ctx) == pytest.approx(0.2)
    assert reader("idle_ms.api").read(SimpleNamespace(trace=None)) is None


def test_nothing_where_the_calls_do_not_pair_up(monkeypatch):
    monkeypatch.setattr(program_spans, "latest_session",
                        lambda: session(3, 0.0))
    ctx = SimpleNamespace(trace=trace(2, [("k", 0, 10)]))
    assert program_spans.idle_ms(ctx, "hrt.api") is None
    monkeypatch.setattr(program_spans, "latest_session", lambda: None)
    ctx = SimpleNamespace(trace=trace(2, [("k", 0, 10)]))
    for m in ("idle_ms.api", "idle_ms.prepare", "idle_ms.bounce"):
        assert reader(m).read(ctx) is None


def test_nothing_where_the_program_has_no_recorder(monkeypatch):
    monkeypatch.setitem(sys.modules, "hermespy_rt_tpu_torch.utils.profiling",
                        None)
    assert program_spans.latest_session() is None
    ctx = SimpleNamespace(trace=trace(2, [("k", 0, 10)]))
    assert reader("idle_ms.api").read(ctx) is None
