"""Entry ``calibration``: a material-calibration loop, closed, one step
after another.

One object, built in set-up, holds the trace's flags, the material table
(its calibrated columns the Adam optimizer's parameters) and the optimizer
state; the set-up drives its first three steps through the same call the
window times, and the window goes on from there.  A step: ``api.trace`` of
the RX, which are the measurement points drawn once from the seed, the
calibration loss against the targets drawn from the seed
(:mod:`rtbench.loss`), ``backward`` to the material table, an
:class:`Adam` step and ``loss.item()`` on the host.  A query is one
nearest-hit ray, ``B P (1 + nrx)`` a step.

The check: the three set-up steps against the reference's three steps of
the whole launch set from the same material rows (each step's loss, the
first gradient as Adam holds it after step one, the change after three),
and step one's sampled paths.
"""
from __future__ import annotations

import sys
import time
import warnings

import numpy as np
import torch
from torch.profiler import record_function

from rtbench import compare, traffic
from rtbench.check import (Reference, launch_order, on_host,
                           program_sample)
from rtbench.entries.forward import received_power
from rtbench.loss import calibration_loss

SPANS = ("api.trace", "loss", "backward", "optimizer.step", "to_host")
SETUP_STEPS = 3


class Adam:
    """Adam (Kingma and Ba, arXiv:1412.6980) as ``torch.optim.Adam``
    computes it by default on the card (foreach; no weight decay, no
    amsgrad), written out.  Building ``torch.optim.Adam`` imports
    ``torch._dynamo``: 6.4-8.0 s of host work in every run's set-up on the
    H100 machine, and much of its spread.  The reference keeps
    ``torch.optim.Adam``."""

    def __init__(self, groups, betas=(0.9, 0.999), eps=1e-8):
        self.param_groups = [dict(g, betas=betas, eps=eps) for g in groups]
        self.state = {}

    def zero_grad(self, set_to_none=True):
        for g in self.param_groups:
            for p in g["params"]:
                p.grad = None

    @torch.no_grad()
    def step(self):
        for g in self.param_groups:
            b1, b2 = g["betas"]
            for p in g["params"]:
                if p.grad is None:
                    continue
                st = self.state.setdefault(p, dict(
                    step=0, exp_avg=torch.zeros_like(p),
                    exp_avg_sq=torch.zeros_like(p)))
                st["step"] += 1
                t = st["step"]
                st["exp_avg"].lerp_(p.grad, 1 - b1)
                st["exp_avg_sq"].mul_(b2).addcmul_(p.grad, p.grad,
                                                   value=1 - b2)
                denom = (st["exp_avg_sq"].sqrt() / (1 - b2 ** t) ** 0.5
                         ).add_(g["eps"])
                p.addcdiv_(st["exp_avg"], denom,
                           value=-g["lr"] / (1 - b1 ** t))


OPTIMIZER = Adam


class Entry:
    spans = SPANS

    def __init__(self, cell):
        from hermespy_rt_tpu_torch import api
        from hermespy_rt_tpu_torch.config import TracerConfig
        from hermespy_rt_tpu_torch.materials import MaterialTable
        self.api, self.cell = api, cell
        tr, wl = cell.tracer, cell.workload
        self.P, self.B = int(tr["num_paths"]), int(tr["num_bounces"])
        self.f = float(tr["frequency_ghz"])
        with warnings.catch_warnings():   # coherent order, reference parity
            warnings.simplefilter("ignore")
            self.cfg = TracerConfig(num_paths=self.P, num_bounces=self.B,
                                    parity=tr["parity"], **wl["flags"])
        dev = cell.device
        self.tx = torch.tensor([tr["tx"]], dtype=torch.float32, device=dev)
        self.rx_np = cell.inputs["rx"][0]
        self.rx = torch.as_tensor(self.rx_np, device=dev)
        self.nrx = self.rx.shape[0]
        self.target_np = cell.inputs["targets_db"]
        self.target = torch.as_tensor(self.target_np, device=dev)
        self.mats = MaterialTable(cell.config["materials"], device=dev)
        cal = wl["calibrate"]
        self.leaves, self.lrs = list(cal["leaves"]), list(cal["lr"])
        for name, p in self.mats.named_parameters():
            p.requires_grad_(name in self.leaves)
        self.opt = OPTIMIZER([{"params": [getattr(self.mats, k)], "lr": lr}
                              for k, lr in zip(self.leaves, self.lrs)])
        self.queries_per_call = self.B * self.P * (1 + self.nrx)
        self.setup_losses, self.g1, self.change = [], None, None
        self.sample = None
        self.ref_live = None

    def _step(self):
        self.opt.zero_grad(set_to_none=True)
        with record_function("api.trace"):
            res = self.api.trace(self.cell.scene, self.rx, self.tx,
                                 carrier_frequency=self.f, config=self.cfg,
                                 materials=self.mats)
        with record_function("loss"):
            loss = calibration_loss(received_power(res.scatter),
                                    self.target)
        with record_function("backward"):
            loss.backward()
        with record_function("optimizer.step"):
            self.opt.step()
        with record_function("to_host"):
            value = loss.item()
        return value, res

    def _ids(self):
        chk = self.cell.workload["check"]
        return torch.as_tensor(np.sort(traffic.rng(
            self.cell.seed, "paths").choice(
                self.P, min(int(chk["sample_paths"]), self.P),
                replace=False)))

    def warmup(self):
        """The first three steps, through the window's own call, recorded
        for the check: each loss, the first gradient from Adam's first
        moment after step one, the sampled paths of step one, and the
        change of the calibrated leaves after step three."""
        params = {k: getattr(self.mats, k) for k in self.leaves}
        theta0 = {k: p.detach().clone() for k, p in params.items()}
        beta1 = self.opt.param_groups[0]["betas"][0]
        for step in range(SETUP_STEPS):
            t0 = time.perf_counter()
            value, res = self._step()
            print(f"rtbench: set-up step {step + 1} "
                  f"{time.perf_counter() - t0:.3f} s", file=sys.stderr)
            self.setup_losses.append(value)
            if step == 0:
                with torch.no_grad():
                    db = 10 * torch.log10(received_power(res.scatter))
                print(f"rtbench: received power at step 1 (dB): "
                      f"{db.cpu().numpy().round(2).tolist()}",
                      file=sys.stderr)
                self.g1 = {k: (self.opt.state[p]["exp_avg"] / (1 - beta1))
                           .detach().float().cpu()
                           if p in self.opt.state else torch.zeros_like(
                               p.detach()).cpu()
                           for k, p in params.items()}
                self.sample = on_host(program_sample(
                    res.los, res.scatter, self._ids(), self.B, self.P))
            del res
        self.change = {k: (p.detach() - theta0[k]).float().cpu()
                       for k, p in params.items()}

    def call(self, i):
        return self._step()[0]

    def plan_check(self, n_calls):
        pass

    def work(self):
        """The bounce shading's work a step, for its roofline: the live
        rays of each bounce come from the reference's queries."""
        if self.ref_live is None:
            return None
        return dict(rays=self.P, nrx=self.nrx, live=self.ref_live)

    def check(self, control=False):
        """``loss_gap``, ``grad_gap``, ``change_gap`` and
        ``path_mismatch``; with ``control`` the reference in bfloat16 in
        the program's place."""
        cell, chk = self.cell, self.cell.workload["check"]
        r = Reference(cell.meshes, cell.sort_triangles, cell.tracer["tx"],
                      self.f, cell.tracer["parity"], self.P, self.B,
                      launch_order(cell.tracer["parity"],
                                   cell.workload["flags"]), cell.device)
        rows = cell.config["materials"]
        chunk = max(1, int(chk["reference_rays"]) // self.nrx)
        want = r.calibration(self.rx_np, self.target_np, rows, self.leaves,
                             self.lrs, SETUP_STEPS, torch.float32, chunk)
        self.ref_live = want["live"]
        ids = self._ids()
        ref_sample = r.sample(self.rx_np, ids, Reference.materials(
            rows, cell.device, torch.float32), torch.float32)
        if control:
            got = r.calibration(self.rx_np, self.target_np, rows,
                                self.leaves, self.lrs, SETUP_STEPS,
                                torch.bfloat16, chunk)
            losses, g1, change = got["losses"], got["g1"], got["change"]
            sample = r.sample(self.rx_np, ids, Reference.materials(
                rows, cell.device, torch.bfloat16), torch.bfloat16)
        else:
            losses, g1, change = self.setup_losses, self.g1, self.change
            sample = self.sample
        moved = compare.moved_leaves(want["g1"])
        return dict(
            loss_gap=compare.loss_gap(losses, want["losses"]),
            grad_gap=compare.norm_gap(g1, want["g1"]),
            change_gap=compare.norm_gap(change, want["change"], moved),
            path_mismatch=compare.mismatch_share([(sample, ref_sample)]))
