"""Channel models on a :class:`~hermespy_rt_tpu_torch.tracer.PathsResult`.

The counterpart of :mod:`hermespy_rt_tpu.models.channel` in torch ops:
band-limited channel impulse responses (tapped delay lines), narrowband
coefficients with Doppler evolution, and summary statistics.  Each runs on
the device that holds the result, and autograd flows through it to whatever
the trace was differentiated against.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from ..tracer import PathsResult

__all__ = ["combine_paths", "cir", "narrowband_coefficients", "path_gain_db",
           "rms_delay_spread"]


def combine_paths(result: PathsResult, polarization: str = "te"
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """LoS and scatter paths concatenated into per-link tensors ``(a, tau,
    freq_shift)`` of shape ``[nrx, ntx, 1 + K]``, complex64 / f32;
    ``polarization`` selects the "te" or "tm" gains."""
    los, scat = result.los, result.scatter
    a = torch.cat([getattr(los, f"a_{polarization}"),
                   getattr(scat, f"a_{polarization}")], dim=-1)
    tau = torch.cat([los.tau, scat.tau], dim=-1)
    nu = torch.cat([los.freq_shift, scat.freq_shift], dim=-1)
    return a, tau, nu


def cir(result: PathsResult, sampling_rate: float, num_taps: int,
        time: float = 0.0, polarization: str = "te") -> torch.Tensor:
    """Band-limited channel impulse response: each path contributes ``a
    exp(j 2 pi nu t) sinc(tap - tau fs)`` on a uniform tap grid at
    ``sampling_rate``.  Returns complex64 ``[nrx, ntx, num_taps]``."""
    a, tau, nu = combine_paths(result, polarization)
    phase = torch.exp(2j * math.pi * (nu * float(time)))
    taps = torch.arange(num_taps, dtype=torch.float32, device=tau.device)
    kernel = torch.sinc(taps - (tau * float(sampling_rate))[..., None])
    return ((a * phase)[..., None] * kernel).sum(dim=-2)


def narrowband_coefficients(result: PathsResult, carrier_frequency_ghz,
                            times, polarization: str = "te") -> torch.Tensor:
    """Time-evolving narrowband coefficient ``h(t) = sum_p a_p exp(-j 2 pi
    f tau_p) exp(j 2 pi nu_p t)``; ``times`` [T] in seconds.  Returns
    complex64 ``[nrx, ntx, T]``."""
    a, tau, nu = combine_paths(result, polarization)
    f_hz = torch.tensor(float(carrier_frequency_ghz), dtype=torch.float32,
                        device=tau.device) * 1e9
    static = a * torch.exp(-2j * math.pi * (f_hz * tau))
    t = torch.as_tensor(times, dtype=torch.float32, device=tau.device)
    rot = torch.exp(2j * math.pi * nu[..., None] * t)
    return (static[..., None] * rot).sum(dim=-2)


def path_gain_db(result: PathsResult, polarization: str = "te"
                 ) -> torch.Tensor:
    """Total received power over all paths, in dB, per (rx, tx) link."""
    a, _, _ = combine_paths(result, polarization)
    p = a.abs().square().sum(dim=-1)
    return 10.0 * torch.log10(torch.clamp(p, min=1e-30))


def rms_delay_spread(result: PathsResult, polarization: str = "te"
                     ) -> torch.Tensor:
    """Power-weighted RMS delay spread per (rx, tx) link, in seconds."""
    a, tau, _ = combine_paths(result, polarization)
    p = a.abs().square()
    w = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    mean = (w * tau).sum(dim=-1, keepdim=True)
    return torch.sqrt((w * (tau - mean).square()).sum(dim=-1))
