"""Which bounce loop a trace takes (``tracer.plan_bounce_loop``), on the
CPU, where each kernel wrapper runs its plain version and the routes are
decided as on the card.  Under ``shade="fused"``:

- Past ``MAX_MATERIALS`` (4842) materials the whole-loop backward's per-warp
  ``[M, 12]`` shared-memory tables do not fit: a ``grad_positions=False``
  trace takes the per-stage nodes (slim backwards and the table
  scatter-add), whose material gradients equal the op path's within
  ``tests/test_torch_fused.py``'s tier (3e-5 of each leaf's largest
  magnitude plus 1e-16), rows past 4842 included.
- Past ``PRE_BWD_MAX_RX`` (340) RX the full pre backward's sums do not fit
  its shared memory: a ``grad_positions`` trace warns and runs the op path,
  whose outputs and gradients it then gives bit for bit.

And where the default, ``shade="auto"``, goes: the fused forward only
where no gradient can be asked for, the refraction is straight (either
transmission mode may be set), the access is the whole scene's, the rays
are on a card and the fused kernels take their shapes; the op path,
silently, everywhere else.  The device type is a value of the plan, so the
card's route is taken here too by handing it ``"cuda"``: it gives the
explicit ``shade="fused"`` forward's bits and keeps no residuals, and under
the transmission modes the op path's decisions and its values within the
fused tier."""
import _torch_threads  # noqa: F401  (first: the thread share)

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from hermespy_rt_tpu_torch import TracerConfig, api, default_materials
from hermespy_rt_tpu_torch import testing as checks
from hermespy_rt_tpu_torch import tracer as tracer_module
from hermespy_rt_tpu_torch.ops import bounce_fused_cuda as fused_ops
from hermespy_rt_tpu_torch.scene import flatten_scene, random_soup_scene
from hermespy_rt_tpu_torch.tracer import (BouncePlan, plan_bounce_loop,
                                          trace_paths)
from hermespy_rt_tpu_torch.utils import profiling

FREQ = 3.0
# a dense soup around the TX (tests/test_torch_fused.py's), so rays hit,
# die and are occluded
RX = np.array([[4.0, 3.0, 1.0], [-6.0, 2.0, -1.0]], np.float32)
TX = np.array([[0.5, 0.0, 0.0]], np.float32)
OUTPUTS = ("a_te", "a_tm", "tau", "freq_shift", "directions_rx")


def _soup(n_materials, seed=0):
    """The soup with triangle ids drawn over an ``n_materials``-row table
    (half of them past ``MAX_MATERIALS`` where the table has such rows),
    and that table."""
    tris = flatten_scene(random_soup_scene(120, seed=5, extent=10.0,
                                           tri_size=2.0), device="cpu")
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n_materials, tris.pad_triangles)
    if n_materials > fused_ops.MAX_MATERIALS:
        ids[::2] = rng.integers(fused_ops.MAX_MATERIALS, n_materials,
                                ids[::2].shape)
    return (dataclasses.replace(tris, material=torch.as_tensor(ids)),
            lambda: checks.material_table(n_materials,
                                          np.random.default_rng(seed), "cpu"))


def _cfg(**kw):
    base = dict(num_paths=512, num_bounces=2, shade="fused",
                grad_positions=False, grad_geometry=False, keep_rays=False,
                compact_rays=True)
    return TracerConfig(**{**base, **kw})


def _loss(res):
    return (res.scatter.a_te.abs().square().sum()
            + res.scatter.a_tm.abs().square().sum()) * 1e9


@pytest.fixture()
def routes(monkeypatch):
    """The fused loops the traces took, by name, in order."""
    taken = []
    for name in ("run_fused_loop_slim", "run_fused_loop_stages"):
        real = getattr(tracer_module, name)

        def spy(*args, _real=real, _name=name, **kw):
            taken.append(_name)
            return _real(*args, **kw)
        monkeypatch.setattr(tracer_module, name, spy)
    return taken


def test_5000_materials_take_the_stage_path(routes, monkeypatch):
    """A 5,000-row table with ids over all of it, under the default
    ``unroll_bounces``: the per-stage nodes (never the whole-loop backward),
    material gradients within the tier of the op path's, nonzero on rows
    past MAX_MATERIALS; outputs equal to the op path's bit for bit."""
    def whole_loop(*_args, **_kw):
        raise AssertionError("loop_bwd_slim ran on a 5,000-row table")

    monkeypatch.setattr(fused_ops, "loop_bwd_slim", whole_loop)
    tris, table = _soup(5000)
    grads, outs = {}, {}
    for shade in ("xla", "fused"):
        mats = table()
        assert mats.num_materials == 5000
        res = trace_paths(tris, mats, RX, TX, np.zeros_like(RX),
                          np.zeros_like(TX), FREQ, _cfg(shade=shade))
        _loss(res).backward()
        grads[shade], outs[shade] = checks.grads_of(mats), res.scatter
    assert routes == ["run_fused_loop_stages"]
    past = {f: g[fused_ops.MAX_MATERIALS:] for f, g in grads["fused"].items()}
    assert float(past["a"].abs().max()) > 0
    checks.leaves_close(grads["fused"], grads["xla"], checks.LEAF_RTOL,
                        checks.LEAF_ATOL, "5,000 materials")
    for f in OUTPUTS:
        assert torch.equal(getattr(outs["fused"], f),
                           getattr(outs["xla"], f)), f


def test_4842_materials_take_the_whole_loop(routes):
    """At MAX_MATERIALS rows the whole-loop node still runs, and its one
    backward call gives the op path's material gradients."""
    tris, table = _soup(fused_ops.MAX_MATERIALS)
    grads = {}
    for shade in ("xla", "fused"):
        mats = table()
        with checks.recording_fused() as calls:
            res = trace_paths(tris, mats, RX, TX, np.zeros_like(RX),
                              np.zeros_like(TX), FREQ,
                              _cfg(shade=shade, num_paths=256))
            _loss(res).backward()
        grads[shade] = checks.grads_of(mats)
    assert routes == ["run_fused_loop_slim"]
    assert len(calls["loop_bwd_slim"]) == 1
    checks.leaves_close(grads["fused"], grads["xla"], checks.LEAF_RTOL,
                        checks.LEAF_ATOL, "4,842 materials")


def test_341_rx_full_gradient_falls_back_to_op_path(routes):
    """341 RX with gradients to the materials, the RX and TX positions,
    the frequency and the vertices: ``shade="fused"`` warns, naming the
    340-RX limit, and gives the op path's outputs and gradients bit for
    bit."""
    tris = flatten_scene(random_soup_scene(120, seed=5, extent=10.0,
                                           tri_size=2.0), device="cpu")
    k = np.arange(341, dtype=np.float32)[:, None]
    rx = np.float32([[4.0, 3.0, 1.0]]) + k * np.float32([[-0.03, 0.02, 0.01]])
    outs, grads = {}, {}
    for shade in ("xla", "fused"):
        mats = default_materials("cpu")
        v0 = tris.v0.clone().requires_grad_()
        leaves = dict(rx=torch.tensor(rx, requires_grad=True),
                      tx=torch.tensor(TX, requires_grad=True),
                      f=torch.tensor(FREQ, requires_grad=True))
        cfg = TracerConfig(num_paths=64, num_bounces=2, shade=shade,
                           keep_rays=False, compact_rays=True)
        args = (dataclasses.replace(tris, v0=v0), mats, leaves["rx"],
                leaves["tx"], np.zeros_like(rx), np.zeros_like(TX),
                leaves["f"], cfg)
        if shade == "fused":
            with pytest.warns(UserWarning, match="340"):
                res = trace_paths(*args)
        else:
            res = trace_paths(*args)
        checks.grad_loss(res).backward()
        outs[shade] = res.scatter
        grads[shade] = {**checks.grads_of(mats), "v0": v0.grad,
                        **{n: x.grad for n, x in leaves.items()}}
    assert routes == []
    assert (outs["xla"].a_te.abs() > 0).any()
    for f in OUTPUTS:
        assert torch.equal(getattr(outs["fused"], f),
                           getattr(outs["xla"], f)), f
    for name, g in grads["xla"].items():
        assert g is not None and torch.equal(grads["fused"][name], g), name
    assert float(grads["xla"]["rx"].abs().max()) > 0


_R, _NRX = 1 << 20, 4          # the box-city drop's rays and RX
_M = fused_ops.MAX_MATERIALS
# the three fallbacks' warnings, word for word
_TRI = "shade='fused' falling back to the op path: tri-sharded scene access"
_TRANS = ("shade='fused' falling back to the op path: transmission modes "
          "run on the op path only")
_RX341 = ("shade='fused' falling back to the op path: nrx=341 > 340, the "
          "most RX the full pre-stage backward takes")
_FUSED = dict(shade="fused", grad_positions=False, grad_geometry=False)
# the O2I cell's flags
_O2I = dict(transmission=True, spawn_transmission=True, refraction="straight")


@pytest.mark.parametrize("kw,grad,device,tri_sharded,rays,nrx,M,want", [
    # "auto": the fused forward only with no gradient, no transmission
    # mode, the whole scene, a card and shapes its kernels take
    ({}, False, "cuda", False, _R, _NRX, 17, BouncePlan("fused_forward")),
    ({}, True, "cuda", False, _R, _NRX, 17, BouncePlan("op")),
    ({}, False, "cpu", False, _R, _NRX, 17, BouncePlan("op")),
    ({}, True, "cpu", False, _R, _NRX, 17, BouncePlan("op")),
    (dict(transmission=True), False, "cuda", False, _R, _NRX, 17,
     BouncePlan("fused_forward")),
    (dict(spawn_transmission=True), False, "cuda", False, _R, _NRX, 17,
     BouncePlan("fused_forward")),
    ({}, False, "cuda", True, _R, _NRX, 17, BouncePlan("op")),
    ({}, False, "cuda", False, fused_ops.FWD_MAX_RAYS, 1, 17,
     BouncePlan("fused_forward")),
    ({}, False, "cuda", False, fused_ops.FWD_MAX_RAYS + 1, 1, 17,
     BouncePlan("op")),
    ({}, False, "cuda", False, _R, 0, 17, BouncePlan("op")),
    # "xla" and "pallas": the op path whatever the trace looks like
    (dict(shade="xla"), False, "cuda", False, _R, _NRX, 17,
     BouncePlan("op")),
    (dict(shade="pallas"), False, "cuda", False, _R, _NRX, 17,
     BouncePlan("op")),
    (dict(shade="pallas", transmission=True), True, "cuda", True, _R, 341,
     _M + 1, BouncePlan("op")),
    # "fused": the fallbacks, in their order, with their warnings
    (dict(transmission=True, shade="fused"), True, "cuda", True, _R, _NRX,
     17, BouncePlan("op", _TRI)),
    (dict(shade="fused"), False, "cpu", True, _R, _NRX, 17,
     BouncePlan("op", _TRI)),
    (dict(shade="fused", transmission=True), True, "cuda", False, _R, _NRX,
     17, BouncePlan("op", _TRANS)),
    (dict(shade="fused", spawn_transmission=True), True, "cuda", False, _R,
     341, 17, BouncePlan("op", _TRANS)),
    (dict(grad_positions=True, grad_geometry=True, shade="fused"), True,
     "cuda", False, 512, fused_ops.PRE_BWD_MAX_RX + 1, 17,
     BouncePlan("op", _RX341)),
    # "fused" without a fallback: per-stage nodes with grad_positions up to
    # 340 RX, whatever the device; the slim loop up to MAX_MATERIALS
    # materials under unroll_bounces; the per-stage nodes past it or
    # without unrolling
    (dict(shade="fused"), False, "cpu", False, _R, _NRX, 17,
     BouncePlan("fused_stages")),
    (dict(_FUSED, grad_positions=True), True, "cuda", False, 512,
     fused_ops.PRE_BWD_MAX_RX, 5000, BouncePlan("fused_stages")),
    (_FUSED, True, "cuda", False, 512, 1, _M, BouncePlan("fused_slim")),
    (_FUSED, False, "cuda", False, 512, 341, _M, BouncePlan("fused_slim")),
    (_FUSED, True, "cuda", False, 512, 1, _M + 1,
     BouncePlan("fused_stages")),
    (dict(_FUSED, unroll_bounces=False), True, "cuda", False, 512, 1, 17,
     BouncePlan("fused_stages")),
    (dict(_FUSED, unroll_bounces=False), True, "cuda", False, 512, 341,
     5000, BouncePlan("fused_stages")),
    # "auto" under the transmission modes: the fused forward with both
    # modes and straight refraction; the op path, silently, with snell
    # refraction, a gradient, a tri-sharded access or on the CPU
    (_O2I, False, "cuda", False, _R, 5, 17, BouncePlan("fused_forward")),
    (dict(_O2I, refraction="snell"), False, "cuda", False, _R, 5, 17,
     BouncePlan("op")),
    (dict(spawn_transmission=True, refraction="snell"), False, "cuda",
     False, _R, 5, 17, BouncePlan("op")),
    (_O2I, True, "cuda", False, _R, 5, 17, BouncePlan("op")),
    (dict(transmission=True), True, "cuda", False, _R, 5, 17,
     BouncePlan("op")),
    (_O2I, False, "cuda", True, _R, 5, 17, BouncePlan("op")),
    (_O2I, False, "cpu", False, _R, 5, 17, BouncePlan("op")),
    (dict(spawn_transmission=True), False, "cpu", False, _R, 5, 17,
     BouncePlan("op")),
    # "fused" under a transmission mode: its warning and the op path, with
    # a gradient or without (its backwards reflect only)
    (dict(_O2I, shade="fused"), True, "cuda", False, _R, 5, 17,
     BouncePlan("op", _TRANS)),
    (dict(_O2I, shade="fused"), False, "cuda", False, _R, 5, 17,
     BouncePlan("op", _TRANS))])
def test_plan_bounce_loop(kw, grad, device, tri_sharded, rays, nrx, M,
                          want):
    """Each row of the rule: the route and the fallback's warning, which
    the plan returns and never emits itself."""
    cfg = TracerConfig(parity="physical", **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        plan = plan_bounce_loop(cfg, grad=grad, device=device,
                                tri_sharded=tri_sharded, rays=rays, nrx=nrx,
                                n_materials=M)
    assert plan == want


@pytest.mark.parametrize("kw,route", [
    (_FUSED, "fused_slim"), (dict(shade="xla"), "op"),
    (dict(shade="fused"), "fused_stages"),
    (dict(_FUSED, unroll_bounces=False), "fused_stages")])
def test_calibration_launches_count_the_plan(kw, route):
    """``testing.calibration_launches`` counts a step on the route the
    plan gives it: the whole-loop backward once on ``"fused_slim"``, the
    scatter-adds of the op path on ``"op"``, and no count (ValueError) for
    the per-stage nodes, whose launches it does not know."""
    cfg = TracerConfig(num_paths=1 << 20, num_bounces=3, **kw)
    if route == "fused_stages":
        with pytest.raises(ValueError, match="fused_stages"):
            checks.calibration_launches(cfg, 4)
        return
    got = checks.calibration_launches(cfg, 4)
    slim = route == "fused_slim"
    assert got["loop_bwd_slim"] == slim and got["bounce_pre"] == 3 * slim
    assert got["scatter_add"] == (0 if slim else 4)


def test_default_shade_is_auto():
    assert TracerConfig().shade == "auto"


def _grew(c0):
    return {k: profiling.COUNTERS.get(k, 0) - c0.get(k, 0)
            for k in ("trace.fused", "trace.op")}


def _drop(parity="physical", **kw):
    """``compute_paths`` on the dense soup, two RX, 512 paths, 2 bounces;
    returns the outputs and the bounce loops it counted."""
    tris, _ = _soup(17)
    c0 = dict(profiling.COUNTERS)
    los, sc = api.compute_paths(tris, RX, TX, None, None, FREQ, len(RX), 1,
                                512, 2, device="cpu", parity=parity, **kw)
    return (los, sc), _grew(c0)


def _same_bits(a, b):
    for part in (0, 1):
        for f in OUTPUTS:
            assert torch.equal(getattr(a[part], f), getattr(b[part], f)), (
                part, f)


@pytest.mark.parametrize("parity", ["reference", "physical"])
def test_default_drop_on_cpu_is_the_op_path(parity):
    """On the CPU the default ``compute_paths`` runs the op path:
    ``shade="xla"``'s bits, one ``trace.op``."""
    out, grew = _drop(parity)
    want, grew_x = _drop(parity, shade="xla")
    assert (out[1].a_te.abs() > 0).any()
    _same_bits(out, want)
    assert grew == grew_x == {"trace.fused": 0, "trace.op": 1}


@pytest.fixture()
def card_route(monkeypatch):
    """``plan_bounce_loop`` told that the rays are on a card; the
    ``_fused_forward`` calls' ``save`` flags, in order."""
    real_plan, real_forward = plan_bounce_loop, tracer_module._fused_forward
    saves = []

    def forward(*args, save, **kw):
        saves.append(save)
        return real_forward(*args, save=save, **kw)
    monkeypatch.setattr(tracer_module, "plan_bounce_loop",
                        lambda cfg, *, device, **kw: real_plan(
                            cfg, device="cuda", **kw))
    monkeypatch.setattr(tracer_module, "_fused_forward", forward)
    return saves


@pytest.mark.parametrize("parity", ["reference", "physical"])
def test_card_route_runs_the_fused_forward(card_route, routes, parity):
    """Where the rays are on a card, the default drop runs the fused
    forward once with no residuals, whatever ``grad_positions`` and
    ``unroll_bounces`` say, and gives the explicit ``shade="fused"``
    trace's bits; ``trace.fused`` counts it."""
    out, grew = _drop(parity)
    assert routes == ["run_fused_loop_slim"] and card_route == [False]
    assert grew == {"trace.fused": 1, "trace.op": 0}
    del routes[:], card_route[:]
    want, _ = _drop(parity, shade="fused")
    assert routes == ["run_fused_loop_stages"] and card_route == []
    _same_bits(out, want)
    assert (out[1].a_te.abs() > 0).any()


@pytest.mark.parametrize("kw", [
    dict(transmission=True), dict(spawn_transmission=True),
    dict(transmission=True, spawn_transmission=True)])
def test_card_route_under_transmission_is_the_silent_op_path(card_route,
                                                             routes, kw):
    """Under either transmission mode, on a card too, a trace of which a
    gradient can be asked for (``api.trace`` with a material table that
    requires grad), and under ``spawn_transmission`` the default drop with
    snell refraction, run the op path with no warning (warnings are errors
    here) and give ``shade="xla"``'s bits; ``trace.op`` counts each."""
    tris, table = _soup(17)
    out = {}
    for shade in ("auto", "xla"):
        mats = table()
        c0 = dict(profiling.COUNTERS)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            res = api.trace(tris, RX, TX, config=TracerConfig(
                num_paths=512, num_bounces=2, parity="physical",
                keep_rays=False, shade=shade, **kw), materials=mats,
                device="cpu")
        _loss(res).backward()
        out[shade] = (res.scatter, checks.grads_of(mats))
        assert _grew(c0) == {"trace.fused": 0, "trace.op": 1}
    for f in OUTPUTS:
        assert torch.equal(getattr(out["auto"][0], f),
                           getattr(out["xla"][0], f)), f
    for f, g in out["xla"][1].items():
        assert torch.equal(out["auto"][1][f], g), f
    if kw.get("spawn_transmission"):
        snell = dict(kw, refraction="snell")
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            drop, grew = _drop(**snell)
        want, _ = _drop(shade="xla", **snell)
        assert grew == {"trace.fused": 0, "trace.op": 1}
        _same_bits(drop, want)
    assert routes == [] and card_route == []


@pytest.mark.parametrize("kw", [
    dict(transmission=True), dict(spawn_transmission=True), _O2I])
def test_card_route_under_transmission_runs_the_fused_forward(card_route,
                                                              routes, kw):
    """Under either transmission mode with straight refraction the
    default drop on a card runs the fused forward once, with no residuals
    and no warning, and gives ``shade="xla"``'s decisions (the written
    slots) and its values within the fused tier (:data:`checks.ROW_RTOL`
    of each row's largest); ``trace.fused`` counts it, and under
    ``transmission`` the LoS pass's blocker fetch keeps ``hrt.transmit``."""
    rows = {}
    for shade in ("auto", "xla"):
        profiling.enable()
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("error")
                drop, grew = _drop(shade=shade, **kw)
        finally:
            profiling.disable()
        rows[shade] = drop
        assert grew == ({"trace.fused": 1, "trace.op": 0} if shade == "auto"
                        else {"trace.fused": 0, "trace.op": 1})
        names = {sp.name for sp in profiling.latest_session().spans}
        assert ("hrt.transmit" in names) == bool(kw.get("transmission"))
    assert routes == ["run_fused_loop_slim"] and card_route == [False]
    assert (rows["auto"][1].a_te.abs() > 0).any()
    for part in (0, 1):
        for f in OUTPUTS:
            a, b = getattr(rows["auto"][part], f), getattr(rows["xla"][part],
                                                          f)
            assert torch.equal(a.abs() > 0, b.abs() > 0), (part, f)
            if a.is_complex():
                a, b = torch.stack([a.real, a.imag]), torch.stack([b.real,
                                                                   b.imag])
            checks.rows_close(a.reshape(-1, a.shape[-1]),
                              b.reshape(-1, b.shape[-1]), checks.ROW_RTOL,
                              f"{part} {f}")


def test_fused_forward_gathers_no_blocker_rows(card_route):
    """Under ``transmission`` the fused forward's post stage reads each
    shadow ray's blocker from the payload table itself: the drop gathers
    only the LoS pass's nrx blocker rows, and ``transmit.blocker_rows``
    counts those alone, where the op path gathers nrx x R more a bounce."""
    nrx, R = len(RX), 512
    for shade, want in (("auto", nrx), ("xla", nrx + 2 * nrx * R)):
        c0 = dict(profiling.COUNTERS)
        with checks.recording_fused() as calls:
            _drop(shade=shade, **_O2I)
        assert (profiling.COUNTERS.get("transmit.blocker_rows", 0)
                - c0.get("transmit.blocker_rows", 0)) == want, shade
        sizes = [args[1].numel() for args, _ in calls["gather"]]
        assert nrx in sizes, (shade, sizes)
        assert sizes.count(nrx * R) == (0 if shade == "auto" else 2), \
            (shade, sizes)
        assert len(calls["bounce_post"]) == (2 if shade == "auto" else 0)


def test_card_route_with_a_gradient_is_the_op_path(card_route, routes):
    """``api.trace`` with grad mode on and a material table that requires
    grad: the op path, on a card too, and the gradient reaches the
    table."""
    tris, table = _soup(17)
    mats = table()
    c0 = dict(profiling.COUNTERS)
    res = api.trace(tris, RX, TX, config=TracerConfig(
        num_paths=512, num_bounces=2, parity="physical", keep_rays=False),
        materials=mats, device="cpu")
    _loss(res).backward()
    assert routes == [] and card_route == []
    assert _grew(c0) == {"trace.fused": 0, "trace.op": 1}
    assert float(mats.a.grad.abs().max()) > 0
