"""Scene data model, HRT reader and procedural builders."""
from .model import HostMesh, HostScene, TriangleSoA, flatten_scene
from .hrt import load_hrt, HrtFormatError
from .builders import (box_scene, simple_reflector_scene, ground_plane_scene,
                       random_soup_scene)

__all__ = [
    "HostMesh", "HostScene", "TriangleSoA", "flatten_scene",
    "load_hrt", "HrtFormatError",
    "box_scene", "simple_reflector_scene", "ground_plane_scene",
    "random_soup_scene",
]
