"""The check of a run's outputs against the plain reference.

Program side: the sampled paths of a call's result, read once the window
has closed.  Reference side: the same paths, or the whole launch set for a
calibration's gradients, traced by :mod:`rtbench.reference.tracer` from the
benchmark's own scene arrays, material rows, positions and launch
directions, in ``dtype`` (float32; bfloat16 for the control).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .loss import calibration_loss, path_power
from .reference import tracer as ref

REF_FIELDS = ("a", "b", "c", "d", "s", "s1_alpha")


def launch_order(parity: str, flags: dict) -> str:
    """The launch order a trace uses: the flag, or ``auto``'s documented
    choice (Fibonacci order under reference parity, else coherent)."""
    order = flags.get("launch_order", "auto")
    if order == "auto":
        return "fibonacci" if parity == "reference" else "coherent"
    return order


def program_sample(los, sc, ids: torch.Tensor, num_bounces: int,
                   num_paths: int) -> dict:
    """The entries of paths ``ids`` in a result's ChannelInfo (``los``,
    ``sc``, one TX), left on the result's device: scatter ``[B, nrx, K]``
    and LoS ``[nrx]``.  A few index_selects, so a call can keep its sample
    and let the full result go."""
    dev = sc.tau.device
    ids = ids.to(dev)
    cols = (torch.arange(num_bounces, device=dev)[:, None] * num_paths
            + ids[None]).reshape(-1)
    nrx, K = sc.tau.shape[0], ids.shape[0]

    def pick(x):        # [nrx, 1, B*P(, 3)] -> [B, nrx, K(, 3)]
        y = x[:, 0].index_select(1, cols)
        return y.reshape(nrx, num_bounces, K, *x.shape[3:]).transpose(0, 1)

    scatter = dict(te=pick(sc.a_te), tm=pick(sc.a_tm), tau=pick(sc.tau),
                   freq=pick(sc.freq_shift), dir_rx=pick(sc.directions_rx),
                   dir_tx=sc.directions_tx[0, 0, :num_paths].index_select(
                       0, ids))
    los_d = dict(te=los.a_te[:, 0, 0], tm=los.a_tm[:, 0, 0],
                 tau=los.tau[:, 0, 0], freq=los.freq_shift[:, 0, 0],
                 dir_rx=los.directions_rx[:, 0, 0],
                 dir_tx=los.directions_tx[:, 0, 0])
    det = lambda d: {k: v.detach().clone() for k, v in d.items()}
    return dict(scatter=det(scatter), los=det(los_d))


def on_host(sample: dict) -> dict:
    """A :func:`program_sample` copied to the host."""
    return {part: {k: v.cpu() for k, v in d.items()}
            for part, d in sample.items()}


def received_power(outs) -> torch.Tensor:
    """The reference's per-RX sum over bounces and rays of ``|a_te|^2 +
    |a_tm|^2`` [nrx], in float64 (:mod:`.loss`)."""
    total = 0
    for o in outs:
        total = total + (path_power(o["te_re"], o["te_im"])
                         + path_power(o["tm_re"], o["tm_im"])).sum(dim=1)
    return total


class Reference:
    """The reference side of one cell: its scene (from the generator's
    meshes), TX, frequency, parity and launch directions, on ``device``."""

    def __init__(self, meshes, sort_triangles: bool, tx, f_ghz: float,
                 parity: str, num_paths: int, num_bounces: int, order: str,
                 device):
        self.scene = ref.scene_from_meshes(meshes, sort_triangles, device)
        self.tx = torch.as_tensor(np.asarray(tx, np.float32).reshape(3),
                                  device=device)
        self.f_ghz, self.parity = f_ghz, parity
        self.P, self.B = num_paths, num_bounces
        self.dirs = torch.as_tensor(ref.launch_directions(num_paths, order),
                                    device=device)
        self.device = device

    def setup(self, rx, dtype) -> ref.Setup:
        rx = torch.as_tensor(np.asarray(rx, np.float32), device=self.device)
        return ref.Setup(self.scene.to(dtype), rx.to(dtype),
                         self.tx.to(dtype), self.f_ghz, self.parity)

    @staticmethod
    def materials(rows: Dict[str, list], device, dtype,
                  grad=()) -> Dict[str, torch.Tensor]:
        """The configuration's material rows as leaf tensors; those named
        in ``grad`` require a gradient."""
        return {f: torch.tensor(rows[f], dtype=torch.float32, device=device
                                ).to(dtype).requires_grad_(f in grad)
                for f in REF_FIELDS}

    def sample(self, rx, ids: torch.Tensor, mats, dtype) -> dict:
        """The reference's entries of paths ``ids`` at RX positions
        ``rx``, as :func:`program_sample` lays them out."""
        su = self.setup(rx, dtype)
        with torch.no_grad():
            eta = ref.precompute_eta(mats, self.f_ghz)
            outs, _ = ref.trace_rays(su, eta, self.dirs[ids.to(self.device)]
                                     .to(dtype), self.B)
            a, tau, freq, dir_rx, dir_tx = ref.los_pass(su)
        f = lambda x: x.float().cpu()
        cplx = lambda re, im: torch.complex(f(re), f(im))
        stack = lambda k: torch.stack([o[k] for o in outs])
        a = f(a)
        return dict(
            scatter=dict(te=cplx(stack("te_re"), stack("te_im")),
                         tm=cplx(stack("tm_re"), stack("tm_im")),
                         tau=f(stack("tau")), freq=f(stack("freq")),
                         dir_rx=f(stack("dir_rx")),
                         dir_tx=f(self.dirs[ids.to(self.device)])),
            los=dict(te=torch.complex(a, torch.zeros_like(a)),
                     tm=torch.complex(a, torch.zeros_like(a)), tau=f(tau),
                     freq=f(freq), dir_rx=f(dir_rx), dir_tx=f(dir_tx)))

    def calibration(self, rx, target_db, rows, leaves, lrs, steps: int,
                    dtype, chunk: int) -> dict:
        """``steps`` calibration steps of the whole launch set from the
        configuration's material rows: per step the received power of
        every RX (its scatter paths), the loss, its gradient to the
        ``leaves`` by two passes over blocks of ``chunk`` rays (powers
        first, then each block's backward against the loss's gradient to
        the powers) and an Adam step.  The blocks' query answers are kept
        from the first pass (they do not depend on the materials).
        Returns the losses, the first gradient, the change of the leaves
        after the steps and the live rays of each bounce."""
        su = self.setup(rx, dtype)
        mats = self.materials(rows, self.device, dtype, grad=leaves)
        opt = torch.optim.Adam([{"params": [mats[k]], "lr": lr}
                                for k, lr in zip(leaves, lrs)])
        theta0 = {k: mats[k].detach().clone() for k in leaves}
        target = torch.as_tensor(target_db, device=self.device).to(dtype)
        blocks = [(s, min(s + chunk, self.P)) for s in range(0, self.P, chunk)]
        hits: List = [None] * len(blocks)
        losses, g1 = [], None
        for step in range(steps):
            opt.zero_grad(set_to_none=True)
            with torch.no_grad():
                eta = ref.precompute_eta(mats, self.f_ghz)
                power = torch.zeros(len(target), dtype=torch.float64,
                                    device=self.device)
                for j, (s, e) in enumerate(blocks):
                    outs, hits[j] = ref.trace_rays(su, eta, self.dirs[s:e]
                                                   .to(dtype), self.B,
                                                   hits[j])
                    power = power + received_power(outs)
            p_leaf = power.detach().requires_grad_(True)
            loss = calibration_loss(p_leaf, target)
            loss.backward()
            w = p_leaf.grad.detach()
            losses.append(loss.item())
            for j, (s, e) in enumerate(blocks):
                eta = ref.precompute_eta(mats, self.f_ghz)
                outs, _ = ref.trace_rays(su, eta, self.dirs[s:e].to(dtype),
                                         self.B, hits[j])
                (w * received_power(outs)).sum().backward()
            if step == 0:
                g1 = {k: mats[k].grad.detach().float().cpu() for k in leaves}
            opt.step()
        live = [sum(int((h[b]["idx"] >= 0).sum()) for h in hits)
                for b in range(self.B)]
        return dict(losses=losses, g1=g1,
                    change={k: (mats[k].detach() - theta0[k]).float().cpu()
                            for k in leaves}, live=live)
