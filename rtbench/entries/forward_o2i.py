"""Entry ``forward_o2i``: outdoor-to-indoor ``compute_paths`` drops in a
closed loop.

Each call is one HermesPy drop, as in :mod:`rtbench.entries.forward`:
``api.compute_paths`` on the prepared scene with the configuration's
counts, parity and transmission flags (``transmission``,
``spawn_transmission``, ``refraction``) and every other ``TracerConfig``
field at the port's default, then each RX's received power (its scatter
paths) reduced on the device and copied to the host, where the drop ends.
A query is one nearest-hit ray, ``B P (1 + nrx)`` a call.

The RX of a drop, after 3GPP TR 38.901's UMi-Street Canyon (Table 7.2-1):
``indoor.count`` indoor, then ``rx.count`` outdoor, every one at least
``min_distance_2d`` from the TX in the plane; a pool of drops drawn from
the seed.  An indoor RX lies uniformly over the union of the building
footprints, each shrunk by ``indoor.margin``, on floor ``n_fl`` of
``N_fl`` (``N_fl`` uniform over ``indoor.floors``, ``n_fl`` uniform over
``1 .. N_fl``), at ``floor_height (n_fl - 1) + ue_height``; a floor above
the box's roof less ``roof_clearance`` is drawn again among that box's
floors that fit.  An outdoor RX is drawn as the ``box`` kind of
:mod:`rtbench.traffic` draws it: uniform over ``rx.lo .. rx.hi``, outside
every footprint grown by ``rx.margin``.  The boxes (footprint, floor and
roof) come from the building mesh the scene generator returns, whose
vertices are written box after box in runs of equal length.

The check: on calls drawn from the seed among the window's first ones, the
entries of paths drawn from the seed, against
:mod:`rtbench.reference.transmission` at the same RX positions
(:func:`rtbench.compare.mismatch_share`); with ``control`` the reference
in bfloat16 in the program's place.
"""
from __future__ import annotations

import numpy as np
import torch

from rtbench import compare, traffic
from rtbench.check import Reference, launch_order, on_host
from rtbench.entries.forward import Entry as Forward
from rtbench.reference import tracer as ref
from rtbench.reference import transmission

TRANSMISSION_FLAGS = ("transmission", "spawn_transmission", "refraction")
# the program's counters the work reads, by the work's key
WORK_COUNTERS = {"fetch.rows": "fetch_rows", "fetch.values": "fetch_values",
                 "transmit.blocker_rows": "blocker_rows"}


def building_boxes(meshes, n_buildings: int) -> np.ndarray:
    """``[n, 6]`` boxes ``(x0, y0, x1, y1, floor z, roof z)`` of the
    building mesh: of ``meshes`` the one with the largest height, its
    vertices split into ``n_buildings`` runs of equal length."""
    verts = max((np.asarray(v, np.float64) for v, _, _ in meshes),
                key=lambda v: np.ptp(v[:, 2]))
    if len(verts) % n_buildings:
        raise ValueError(f"{len(verts)} vertices do not split into "
                         f"{n_buildings} boxes")
    v = verts.reshape(n_buildings, -1, 3)
    return np.concatenate([v[..., :2].min(axis=1), v[..., :2].max(axis=1),
                           v[..., 2:].min(axis=1), v[..., 2:].max(axis=1)],
                          axis=1)


def _far(p, tx, dmin):
    return np.hypot(p[:, 0] - tx[0], p[:, 1] - tx[1]) >= dmin


def draw_indoor(params: dict, boxes, n: int, gen, tx, dmin) -> np.ndarray:
    """``n`` indoor RX, f64[n, 3] (see the module docstring)."""
    m = float(params["margin"])
    lo_fl, hi_fl = (int(x) for x in params["floors"])
    h_fl, h_ue = float(params["floor_height"]), float(params["ue_height"])
    top = boxes[:, 5] - float(params["roof_clearance"])
    x0, y0, x1, y1 = (boxes[:, k] + s * m
                      for k, s in ((0, 1), (1, 1), (2, -1), (3, -1)))
    area = (x1 - x0) * (y1 - y0)
    if np.any(area <= 0) or np.any(top < h_ue):
        raise ValueError("a box holds no indoor RX")
    fits = np.floor((top - h_ue) / h_fl).astype(np.int64) + 1
    out = np.zeros((0, 3))
    while len(out) < n:
        k = gen.choice(len(boxes), size=2 * n, p=area / area.sum())
        x = gen.uniform(x0[k], x1[k])
        y = gen.uniform(y0[k], y1[k])
        n_fl = gen.integers(lo_fl, hi_fl + 1, size=2 * n)
        floor = gen.integers(1, n_fl + 1)
        again = gen.integers(1, np.minimum(n_fl, fits[k]) + 1)
        floor = np.where(floor > fits[k], again, floor)
        p = np.stack([x, y, h_fl * (floor - 1) + h_ue], axis=1)
        out = np.concatenate([out, p[_far(p, tx, dmin)]])
    return out[:n]


def draw_outdoor(params: dict, boxes, n: int, gen, tx, dmin) -> np.ndarray:
    """``n`` outdoor RX, f64[n, 3] (see the module docstring)."""
    lo, hi = np.asarray(params["lo"], float), np.asarray(params["hi"], float)
    m = float(params.get("margin", 0.0))
    out = np.zeros((0, 3))
    while len(out) < n:
        p = gen.uniform(lo, hi, size=(2 * n, 3))
        inside = ((p[:, None, 0] >= boxes[None, :, 0] - m)
                  & (p[:, None, 0] <= boxes[None, :, 2] + m)
                  & (p[:, None, 1] >= boxes[None, :, 1] - m)
                  & (p[:, None, 1] <= boxes[None, :, 3] + m)).any(axis=1)
        p = p[~inside]
        out = np.concatenate([out, p[_far(p, tx, dmin)]])
    return out[:n]


def draw_drops(traffic_params: dict, boxes, n_sets: int, gen, tx
               ) -> np.ndarray:
    """``n_sets`` drops of RX, f32[n_sets, indoor + outdoor, 3]: each
    drop's indoor RX first, then its outdoor RX."""
    dmin = float(traffic_params["min_distance_2d"])
    ind, outd = traffic_params["indoor"], traffic_params["rx"]
    a = draw_indoor(ind, boxes, n_sets * int(ind["count"]), gen, tx, dmin)
    b = draw_outdoor(outd, boxes, n_sets * int(outd["count"]), gen, tx, dmin)
    return np.concatenate([a.reshape(n_sets, -1, 3),
                           b.reshape(n_sets, -1, 3)], axis=1
                          ).astype(np.float32)


def reference_sample(scene, rx, tx, f_ghz: float, dirs: torch.Tensor,
                     ids: torch.Tensor, rows, num_bounces: int, dtype,
                     device) -> dict:
    """The transmission reference's entries of paths ``ids`` (rows of the
    launch set ``dirs``) at RX positions ``rx``, as
    :func:`rtbench.check.program_sample` lays them out, on the host."""
    mats = Reference.materials(rows, device, dtype)
    rx = torch.as_tensor(np.asarray(rx, np.float32), device=device)
    tx = torch.as_tensor(np.asarray(tx, np.float32).reshape(3),
                         device=device)
    su = ref.Setup(scene.to(dtype), rx.to(dtype), tx.to(dtype), f_ghz,
                   "physical")
    ids = ids.to(device)
    with torch.no_grad():
        eta = ref.precompute_eta(mats, f_ghz)
        outs = transmission.trace_rays(
            su, eta, dirs[ids].to(dtype),
            transmission.patterns(ids, num_bounces), num_bounces)
        los = transmission.los_pass(su, eta)
    f = lambda x: x.float().cpu()
    cplx = lambda re, im: torch.complex(f(re), f(im))
    stack = lambda k: torch.stack([o[k] for o in outs])
    return dict(
        scatter=dict(te=cplx(stack("te_re"), stack("te_im")),
                     tm=cplx(stack("tm_re"), stack("tm_im")),
                     tau=f(stack("tau")), freq=f(stack("freq")),
                     dir_rx=f(stack("dir_rx")), dir_tx=f(dirs[ids])),
        los=dict(te=cplx(los["te_re"], los["te_im"]),
                 tm=cplx(los["tm_re"], los["tm_im"]), tau=f(los["tau"]),
                 freq=f(los["freq"]), dir_rx=f(los["dir_rx"]),
                 dir_tx=f(los["dir_tx"])))


def _counters():
    """The program's counters the entry's work reads, or None where the
    program has none of them."""
    try:
        from hermespy_rt_tpu_torch.utils.profiling import COUNTERS
    except ImportError:
        return None
    return {k: COUNTERS.get(k) for k in WORK_COUNTERS}


class Entry(Forward):
    def __init__(self, cell):
        super().__init__(cell)
        tr = cell.tracer
        self.kw = {"parity": tr["parity"],
                   **{k: tr[k] for k in TRANSMISSION_FLAGS},
                   **cell.workload.get("flags", {})}
        tp = cell.workload["traffic_params"]
        boxes = building_boxes(cell.meshes,
                               int(cell.config["scene"]["n_buildings"]))
        tx = self.tx[0]
        self.rx_sets = draw_drops(tp, boxes, int(tp.get("pool", 4096)),
                                  traffic.rng(cell.seed, "rx"), tx)
        self.warm = draw_drops(tp, boxes, int(tp.get("warmup_calls", 2)),
                               traffic.rng(cell.seed, "warmup"), tx)
        self.nrx = self.rx_sets.shape[1]
        self.queries_per_call = self.B * self.P * (1 + self.nrx)
        self.grown, self.calls = {}, 0

    def warmup(self):
        for rx in self.warm:
            self._drop(rx)

    def call(self, i):
        before = _counters()
        out = super().call(i)
        after = _counters()
        if before is not None:
            for k in WORK_COUNTERS:
                if before[k] is not None and after[k] is not None:
                    self.grown[k] = self.grown.get(k, 0) + after[k] - before[k]
        self.calls += 1
        return out

    def work(self):
        """The program's counts a call (``fetch_rows``, ``fetch_values``,
        ``blocker_rows``) over the calls made since the warm-up; None
        where the program counts none of them."""
        if not self.grown or not self.calls:
            return None
        return {WORK_COUNTERS[k]: v / self.calls
                for k, v in self.grown.items()}

    def check(self, control=False):
        """``path_mismatch`` over the kept calls (1 where none was kept)."""
        cell, ids = self.cell, self.ids
        samples = {i: (rx, on_host(s)) for i, (rx, s) in self.kept.items()}
        self.kept.clear()
        if not samples:
            return dict(path_mismatch=1.0)
        dev = cell.device
        scene = ref.scene_from_meshes(cell.meshes, cell.sort_triangles, dev)
        dirs = torch.as_tensor(ref.launch_directions(
            self.P, launch_order(cell.tracer["parity"],
                                 cell.workload.get("flags", {}))),
            device=dev)
        rows = cell.config["materials"]
        sample = lambda rx, dt: reference_sample(
            scene, rx, self.tx, self.f, dirs, ids, rows, self.B, dt, dev)
        pairs = []
        for rx, prog in samples.values():
            want = sample(rx, torch.float32)
            if control:
                prog = sample(rx, torch.bfloat16)
            pairs.append((prog, want))
        return dict(path_mismatch=compare.mismatch_share(pairs))
