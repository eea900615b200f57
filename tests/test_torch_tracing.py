"""The port's recorder (``utils/profiling.py``): spans and counters, on the
CPU.

* off, a span is the shared no-op: nothing is recorded and no
  ``record_function`` is made;
* under a profiler with the benchmark's schedule (one warm-up cycle, one
  recorded) only the recorded cycle is kept, one session a window;
* the span tree and call ids of the op path, of the fused path and through
  its backwards (the whole-loop node and the per-stage nodes);
* the wrappers' ``launches`` and ``COLLECTIVES`` are views of the registry;
* ``queries`` counts every query and ``queries.masked`` those given the
  rays' activity mask: all but the LoS by default, none under
  ``compact_rays=False``;
* ``profile_trace`` writes the spans as ranges with their arguments, and
  ``hrt-torch-trace --profile`` calls it.
"""
import _torch_threads  # noqa: F401  (first: the thread share)

import json
import os
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

from hermespy_rt_tpu_torch import (TracerConfig, api, default_materials,
                                   flatten_scene, save_hrt,
                                   simple_reflector_scene)
from hermespy_rt_tpu_torch.cli import trace_main
from hermespy_rt_tpu_torch.ops import intersect_cuda, walk_cuda
from hermespy_rt_tpu_torch.parallel import sharding
from hermespy_rt_tpu_torch.utils import profiling

RX = [[0.0, 0.0, 0.15], [0.3, -0.2, 0.4]]
TX = [[0.0, 0.0, 0.151]]


@pytest.fixture()
def recorder():
    """The recorder switched off before and after the test."""
    profiling.disable()
    yield profiling
    profiling.disable()


@pytest.fixture(scope="module")
def tris():
    return flatten_scene(simple_reflector_scene(), device="cpu")


def drop(tris, bounces=2, **kw):
    return api.compute_paths(tris, RX, TX, None, None, 3.0, len(RX), 1, 64,
                             bounces, device="cpu", **kw)


def fused_step(tris, **kw):
    """One calibration step through ``api.trace`` on the fused path."""
    mats = default_materials("cpu")
    cfg = TracerConfig(num_paths=64, num_bounces=2, shade="fused",
                       parity="physical", grad_positions=False,
                       grad_geometry=False, **kw)
    res = api.trace(tris, RX, TX, config=cfg, materials=mats, device="cpu")
    loss = (res.scatter.a_te.abs() ** 2).sum() + (
        res.scatter.a_tm.abs() ** 2).sum()
    loss.backward()
    return mats


def children(session, parent):
    return [s.name for s in session.spans if s.parent == parent]


def test_off_records_nothing_and_makes_no_range(recorder, tris, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function made while off")
    monkeypatch.setattr(torch.autograd.profiler.record_function, "__init__",
                        refuse)
    before = recorder.latest_session()
    n = len(before.spans) if before else 0
    assert not recorder.recording()
    assert recorder.span("a") is recorder.span("b", k=1)
    assert recorder.call_span() is recorder.span("c")
    drop(tris)
    fused_step(tris)
    after = recorder.latest_session()
    assert after is before and (len(after.spans) if after else 0) == n


def test_on_leaves_the_results_as_they_are(recorder, tris):
    off = drop(tris)
    recorder.enable()
    on = drop(tris)
    for a, b in zip(off, on):
        for name in ("a_te", "a_tm", "tau", "freq_shift"):
            assert torch.equal(getattr(a, name), getattr(b, name))


def test_only_the_recorded_cycle_is_kept(recorder, tris):
    sessions = []
    for _ in range(2):          # two windows, as the benchmark retries
        with profile(activities=[ProfilerActivity.CPU],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                drop(tris, bounces=1)
            prof.step()
            for _ in range(3):
                drop(tris, bounces=1)
        sessions.append(recorder.latest_session())
    first, second = sessions
    assert first is not second and second.index > first.index
    for s in sessions:
        roots = [sp for sp in s.spans if sp.name == profiling.ROOT]
        assert len(roots) == 3 and len({r.call for r in roots}) == 3
        assert all(sp.end_ns is not None for sp in s.spans)
    assert not recorder.recording()
    drop(tris)
    assert recorder.latest_session() is second
    assert len(second.spans) == len(first.spans)


def test_op_path_span_tree(recorder, tris):
    recorder.enable()
    drop(tris, bounces=2)
    s = recorder.latest_session()
    root = s.spans[0]
    assert root.name == "hrt.api" and root.parent is None
    assert all(sp.call == root.call for sp in s.spans)
    assert Counter(children(s, 0)) == Counter(
        {"hrt.prepare": 3, "hrt.los": 1, "hrt.assemble": 2,
         "hrt.bounce": 2})
    bounces = [i for i, sp in enumerate(s.spans) if sp.name == "hrt.bounce"]
    assert [s.spans[i].attrs for i in bounces] == [{"k": 0}, {"k": 1}]
    for i in bounces:
        assert children(s, i) == ["hrt.intersect", "hrt.shade"]
        shade = s.spans.index(next(sp for sp in s.spans
                                   if sp.parent == i
                                   and sp.name == "hrt.shade"))
        assert children(s, shade) == ["hrt.shadow"]
    for sp in s.spans:
        assert sp.start_ns <= sp.end_ns and sp.launches == 0
        if sp.parent is not None:
            up = s.spans[sp.parent]
            assert up.start_ns <= sp.start_ns and sp.end_ns <= up.end_ns
    drop(tris, bounces=2)
    roots = [sp for sp in s.spans if sp.name == "hrt.api"]
    assert len(roots) == 2 and roots[1].call == roots[0].call + 1


@pytest.mark.parametrize("unroll, backwards", [(True, 1), (False, 4)])
def test_fused_path_and_its_backward_share_the_call(recorder, tris, unroll,
                                                    backwards):
    recorder.enable()
    mats = fused_step(tris, unroll_bounces=unroll)
    assert any(p.grad is not None for p in mats.parameters())
    s = recorder.latest_session()
    root = next(sp for sp in s.spans if sp.name == "hrt.api")
    bounces = [i for i, sp in enumerate(s.spans) if sp.name == "hrt.bounce"]
    assert len(bounces) == 2
    for i in bounces:
        assert children(s, i) == ["hrt.intersect", "hrt.shade", "hrt.shadow",
                                  "hrt.shade_post"]
    back = [sp for sp in s.spans if sp.name == "hrt.backward"]
    assert len(back) == backwards
    for sp in back:
        assert sp.call == root.call and sp.parent is None
        assert sp.start_ns >= root.end_ns


def test_launches_count_through_the_registry(recorder):
    nh, wk = intersect_cuda.nearest_hit, walk_cuda.walk
    nh.launches = 5
    assert profiling.COUNTERS["launches.nearest_hit"] == 5
    total = profiling.COUNTERS["launches"]
    recorder.enable()
    with recorder.span("outer") as outer:
        nh.launched()
        with recorder.span("inner") as inner:
            wk.launched(2)
    assert nh.launches == 6 and profiling.COUNTERS["launches"] == total + 3
    assert (outer.launches, inner.launches) == (3, 2)
    assert recorder.latest_session().counters["launches"] == 3
    wk.launches = 0
    assert profiling.COUNTERS["launches.walk"] == 0


@pytest.mark.parametrize("kw,masked", [({}, 1), (dict(compact_rays=False),
                                                  0)])
def test_queries_count_the_masked_ones(tris, kw, masked):
    """Every query is counted; by default all but the LoS take the mask."""
    c0 = dict(profiling.COUNTERS)
    drop(tris, **kw)
    grew = {k: profiling.COUNTERS.get(k, 0) - c0.get(k, 0)
            for k in ("queries", "queries.masked")}
    assert grew["queries"] == 5              # LoS + 2 x (bounce, shadow)
    assert grew["queries.masked"] == masked * (grew["queries"] - 1)


def test_collectives_are_a_view_of_the_registry(recorder):
    class Group:
        def size(self):
            return 2

    sharding.reset_collectives()
    assert dict(sharding.COLLECTIVES) == dict(calls=0, bytes=0, seconds=0.0)
    recorder.enable()
    out = sharding._counted(lambda y: y * 2, torch.ones(4), Group())
    assert torch.equal(out, torch.full((4,), 2.0))
    assert sharding.COLLECTIVES["calls"] == 1
    assert profiling.COUNTERS["collective.bytes"] == 4 * 4 * 2
    assert sharding.COLLECTIVES["seconds"] == profiling.COUNTERS[
        "collective.seconds"] > 0
    assert recorder.latest_session().spans[-1].name == "hrt.collective"
    sharding.COLLECTIVES["calls"] += 1
    assert profiling.COUNTERS["collective.calls"] == 2
    sharding.reset_collectives()
    assert profiling.COUNTERS["collective.calls"] == 0


def test_profile_trace_writes_the_spans_with_their_arguments(recorder, tris,
                                                             tmp_path):
    with profiling.profile_trace(str(tmp_path)) as prof:
        drop(tris, bounces=1)
    assert not recorder.recording()
    with open(prof.trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    ranges = [e for e in events if e.get("cat") == "user_annotation"
              and e["name"].startswith("hrt.")]
    names = Counter(e["name"] for e in ranges)
    assert names["hrt.api"] == 1 and names["hrt.bounce"] == 1
    assert all("launches" in e["args"] and "call" in e["args"]
               for e in ranges)
    assert next(e for e in ranges
                if e["name"] == "hrt.bounce")["args"]["k"] == 0


def test_trace_cli_writes_a_profile(recorder, tmp_path, capsys):
    scene = str(tmp_path / "s.hrt")
    save_hrt(simple_reflector_scene(), scene)
    assert trace_main([scene, "--tx", "0,0,0.151", "--rx", "0,0,0.15",
                       "-p", "64", "-b", "1", "--device", "cpu",
                       "--profile", str(tmp_path / "prof")]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert os.path.dirname(out["profile"]) == str(tmp_path / "prof")
    with open(out["profile"]) as fh:
        assert any(e.get("name") == "hrt.api"
                   for e in json.load(fh)["traceEvents"])
