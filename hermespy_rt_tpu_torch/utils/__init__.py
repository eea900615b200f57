"""Utilities: profiling, metric records, input validation and numeric
failure detection."""
from .profiling import TraceStats, time_trace, profile_trace, log_metrics
from .validation import (validate_scene, validate_inputs, check_finite,
                         SceneValidationError)

__all__ = ["TraceStats", "time_trace", "profile_trace", "log_metrics",
           "validate_scene", "validate_inputs", "check_finite",
           "SceneValidationError"]
