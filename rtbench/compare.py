"""The comparisons that decide ``correct``.

Path outputs are compared entry by entry, an entry being one (bounce, RX,
path) of the scatter or one RX's LoS path: an entry mismatches when any of
its gains, delay, Doppler shift or directions lies beyond the tolerances
below, which are set from float32 rounding over three bounces with room to
spare.  The number compared with its limit is the share of mismatching
entries among those where either side has a path (a nonzero gain), so a
rare flip of a nearest hit at a triangle edge, where two float32 orders of
operation may disagree, costs one entry and not the run.

Training numbers are gaps of norms, leaf by leaf (each calibrated material
column is a leaf): ``| |prog| - |ref| |`` over the larger of the
reference's norm of that leaf and of the median leaf.
"""
from __future__ import annotations

import torch

RTOL_GAIN = 1e-4      # of the reference entry's |a|
ATOL_GAIN = 1e-6      # of the RX's strongest scatter gain
RTOL_TAU, ATOL_TAU = 1e-5, 1e-15          # s
RTOL_FREQ, ATOL_FREQ = 1e-4, 1e-3         # Hz
ATOL_DIR = 1e-4       # unit vectors, per component
MIN_GRAD_SHARE = 1e-3   # a leaf whose reference gradient is below this
#                         share of the median leaf's is left out of the
#                         change: it moves under Adam by round-off alone


def _gain_bad(p, r, scale):
    return (p - r).abs() > RTOL_GAIN * r.abs() + ATOL_GAIN * scale


def _close(p, r, rtol, atol):
    return (p - r).abs() <= rtol * r.abs() + atol


def mismatch_counts(prog: dict, ref: dict):
    """(mismatching entries, entries with a path) of one call's sample.
    Both dicts hold ``los`` and ``scatter`` as made by
    :func:`rtbench.check.program_sample` / ``reference_sample``: gains
    ``te``/``tm`` complex, ``tau``, ``freq``, ``dir_rx`` and ``dir_tx``."""
    bad_n = live_n = 0
    for part in ("los", "scatter"):
        p, r = prog[part], ref[part]
        te_r, tm_r = r["te"], r["tm"]
        if part == "scatter":    # [B, nrx, K]: per RX its strongest path
            scale = torch.maximum(te_r.abs(), tm_r.abs()).amax(dim=(0, 2),
                                                              keepdim=True)
        else:
            scale = torch.zeros_like(te_r.abs())
        bad = (_gain_bad(p["te"], te_r, scale) | _gain_bad(p["tm"], tm_r,
                                                           scale)
               | ~_close(p["tau"], r["tau"], RTOL_TAU, ATOL_TAU)
               | ~_close(p["freq"], r["freq"], RTOL_FREQ, ATOL_FREQ)
               | ((p["dir_rx"] - r["dir_rx"]).abs().amax(-1) > ATOL_DIR))
        dtx = (p["dir_tx"] - r["dir_tx"]).abs().amax(-1) > ATOL_DIR
        bad = bad | dtx.expand_as(bad)
        has = ((te_r.abs() + tm_r.abs() + p["te"].abs() + p["tm"].abs()) > 0)
        nonfinite = ~torch.isfinite(p["te"].abs() + p["tm"].abs()
                                    + p["tau"] + p["freq"])
        bad_n += int((bad & has | nonfinite).sum())
        live_n += int((has | nonfinite).sum())
    return bad_n, live_n


def mismatch_share(pairs) -> float:
    """The share of mismatching entries over ``pairs`` of (program,
    reference) samples; 1 where no entry has a path (nothing was
    compared)."""
    bad = live = 0
    for prog, ref in pairs:
        b, n = mismatch_counts(prog, ref)
        bad += b
        live += n
    return bad / live if live else 1.0


def loss_gap(prog_losses, ref_losses) -> float:
    """The worst relative gap of the steps' losses (inf on a missing or
    non-finite one)."""
    if len(prog_losses) != len(ref_losses):
        return float("inf")
    gaps = [abs(p - r) / abs(r) if r else abs(p - r)
            for p, r in zip(prog_losses, ref_losses)]
    return max((g if g == g else float("inf")) for g in gaps)


def norm_gap(prog: dict, ref: dict, keep=None) -> float:
    """The worst leaf's gap of norms, over the leaves in ``keep`` (all when
    None): ``| |prog[k]| - |ref[k]| |`` over the larger of ``|ref[k]|`` and
    the median leaf's reference norm."""
    norms = {k: float(v.double().norm()) for k, v in ref.items()}
    med = float(torch.tensor(sorted(norms.values())).median())
    worst = 0.0
    for k in (keep if keep is not None else norms):
        diff = abs(float(prog[k].double().norm()) - norms[k])
        den = max(norms[k], med)
        g = diff / den if den > 0 else (0.0 if diff == 0 else float("inf"))
        worst = max(worst, g if g == g else float("inf"))
    return worst


def moved_leaves(ref_grad: dict):
    """The leaves the change is compared on: those whose reference
    gradient is at least :data:`MIN_GRAD_SHARE` of the median leaf's."""
    norms = {k: float(v.double().norm()) for k, v in ref_grad.items()}
    med = float(torch.tensor(sorted(norms.values())).median())
    return [k for k, n in norms.items() if n >= MIN_GRAD_SHARE * med]
