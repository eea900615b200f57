"""The calibration loss of the benchmark's calibration cells: the mean over
RX of the squared gap between the received power in dB and its target, as
a user fits materials to measured powers.  Received power is the sum over
the RX's scatter paths of ``|a_te|^2 + |a_tm|^2``: the paths the
materials shape.  Shared by the timed path and the reference, so neither
can change it alone.

The gains are squared in float64: exact for float32 and bfloat16 gains,
and no underflow where a scene's powers reach 1e-39 (the city's), nor an
overflow of the loss's gradient to the power, ``~1/P``.
"""
from __future__ import annotations

import torch

POWER_FLOOR = 1e-37   # an RX that receives nothing reads -370 dB, not -inf


def path_power(re, im):
    """``|a|^2`` of the gains ``re + j im``, in float64."""
    re, im = re.double(), im.double()
    return re * re + im * im


def calibration_loss(power: torch.Tensor, target_db: torch.Tensor):
    """``power``: per RX, summed :func:`path_power`."""
    db = 10.0 * torch.log10(power + POWER_FLOOR)
    return ((db - target_db) ** 2).mean()
