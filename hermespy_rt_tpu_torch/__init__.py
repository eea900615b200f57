"""hermespy_rt_tpu_torch — the differentiable RF ray tracer in PyTorch + CUDA.

The port of :mod:`hermespy_rt_tpu` (JAX on a TPU) to PyTorch on an NVIDIA
H100.  It covers the forward trace (LoS pass, specular bounces, scatter to
every RX, both parity modes) with material gradients through autograd, and
the material-calibration path (``shade="fused"``): each bounce as two fused
kernels and the whole loop's material backward as one
(``csrc/bounce_fused.cu``).  The nearest-hit query is a hand-written CUDA
kernel too (``csrc/intersect.cu``).  Every kernel has a plain torch version
that CPU tensors use.  Entry points run on the card unless the caller asks
for the CPU.  This package imports torch and never JAX.
"""
from .api import compute_paths, trace, prepare_scene, load_scene
from .config import TracerConfig
from .materials import MaterialTable, default_materials, get_material_index
from .scene import (HostMesh, HostScene, TriangleSoA, flatten_scene, load_hrt,
                    box_scene, simple_reflector_scene, ground_plane_scene,
                    random_soup_scene)
from .tracer import ChannelInfo, PathsResult, RaysInfo, trace_paths

__version__ = "0.1.0"

__all__ = [
    "compute_paths", "trace", "prepare_scene", "load_scene", "TracerConfig",
    "MaterialTable", "default_materials", "get_material_index",
    "HostMesh", "HostScene", "TriangleSoA", "flatten_scene", "load_hrt",
    "box_scene", "simple_reflector_scene", "ground_plane_scene",
    "random_soup_scene",
    "ChannelInfo", "PathsResult", "RaysInfo", "trace_paths",
    "__version__",
]
