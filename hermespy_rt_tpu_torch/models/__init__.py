"""Channel models on top of the tracer: channel realisations, coverage maps
and resumable sweeps."""
from .channel import (cir, combine_paths, narrowband_coefficients,
                      path_gain_db, rms_delay_spread)
from .sweep import SweepConfig, run_sweep, load_sweep_results
from .coverage import CoverageGrid, coverage_map

__all__ = ["cir", "combine_paths", "narrowband_coefficients", "path_gain_db",
           "rms_delay_spread", "SweepConfig", "run_sweep",
           "load_sweep_results", "CoverageGrid", "coverage_map"]
