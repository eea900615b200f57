"""Utilities: input validation and numeric failure detection."""
from .validation import (validate_scene, validate_inputs, check_finite,
                         SceneValidationError)

__all__ = ["validate_scene", "validate_inputs", "check_finite",
           "SceneValidationError"]
