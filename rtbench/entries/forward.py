"""Entry ``forward``: ``compute_paths`` drops in a closed loop.

Each call is one HermesPy drop: ``api.compute_paths`` on the prepared scene
with this drop's RX positions, the configuration's counts and parity and
every other ``TracerConfig`` field at the port's default (the cell's
``flags`` may pin some), then each RX's received power (its scatter paths) reduced on
the device and copied to the host, where the drop ends.  A query is one
nearest-hit ray, ``B P (1 + nrx)`` a call.

The check: on calls drawn from the seed among the window's first ones, the
entries of paths drawn from the seed, against the reference at the same
RX positions (:func:`rtbench.compare.mismatch_share`).
"""
from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from rtbench import compare, traffic
from rtbench.check import (Reference, launch_order, on_host,
                           program_sample)
from rtbench.loss import path_power

SPANS = ("api.compute_paths", "power", "to_host")


def received_power(sc):
    """Per RX, ``sum |a_te|^2 + |a_tm|^2`` over its scatter paths [nrx],
    in float64 (:mod:`rtbench.loss`): the paths the materials shape (the
    LoS path is its own output)."""
    p = lambda a: path_power(a.real, a.imag).sum(dim=(1, 2))
    return p(sc.a_te) + p(sc.a_tm)


class Entry:
    spans = SPANS

    def __init__(self, cell):
        from hermespy_rt_tpu_torch import api
        self.api, self.cell = api, cell
        tr = cell.tracer
        self.P, self.B = int(tr["num_paths"]), int(tr["num_bounces"])
        self.tx = np.asarray(tr["tx"], np.float32).reshape(1, 3)
        self.f = float(tr["frequency_ghz"])
        self.kw = dict(parity=tr["parity"], **cell.workload.get("flags", {}))
        self.rx_sets = cell.inputs["rx"]
        self.nrx = self.rx_sets.shape[1]
        self.queries_per_call = self.B * self.P * (1 + self.nrx)
        chk = cell.workload["check"]
        self.ids = torch.as_tensor(np.sort(traffic.rng(
            cell.seed, "paths").choice(
                self.P, min(int(chk["sample_paths"]), self.P),
                replace=False)))
        self.keep_ids, self.kept = set(), {}

    def _drop(self, rx):
        with record_function("api.compute_paths"):
            los, sc = self.api.compute_paths(
                self.cell.scene, rx, self.tx, None, None, self.f, self.nrx,
                1, self.P, self.B, device=self.cell.device, **self.kw)
        with record_function("power"):
            p = received_power(sc)
        with record_function("to_host"):
            out = p.cpu().numpy()
        return out, los, sc

    def warmup(self):
        for rx in self.cell.inputs["warmup"]:
            self._drop(rx)

    def call(self, i):
        rx = self.rx_sets[i % len(self.rx_sets)]
        out, los, sc = self._drop(rx)
        if i in self.keep_ids:
            self.kept[i] = (rx, program_sample(los, sc, self.ids, self.B,
                                               self.P))
        return out

    def plan_check(self, n_calls):
        chk = self.cell.workload["check"]
        g = traffic.rng(self.cell.seed, "check_calls")
        n = min(int(chk["calls"]), n_calls)
        self.keep_ids = set(int(i) for i in g.choice(n_calls, n,
                                                     replace=False))

    def work(self):
        return None

    def check(self, control=False):
        """``path_mismatch`` over the kept calls (1 where none was kept);
        with ``control`` the reference in bfloat16 in the program's
        place."""
        cell, ids = self.cell, self.ids
        samples = {i: (rx, on_host(s)) for i, (rx, s) in self.kept.items()}
        self.kept.clear()
        if not samples:
            return dict(path_mismatch=1.0)
        r = Reference(cell.meshes, cell.sort_triangles, self.tx, self.f,
                      cell.tracer["parity"], self.P, self.B,
                      launch_order(cell.tracer["parity"],
                                   cell.workload.get("flags", {})),
                      cell.device)
        mats = Reference.materials(cell.config["materials"], cell.device,
                                   torch.float32)
        pairs = []
        for rx, prog in samples.values():
            want = r.sample(rx, ids, mats, torch.float32)
            if control:
                low = Reference.materials(cell.config["materials"],
                                          cell.device, torch.bfloat16)
                prog = r.sample(rx, ids, low, torch.bfloat16)
            pairs.append((prog, want))
        return dict(path_mismatch=compare.mismatch_share(pairs))
