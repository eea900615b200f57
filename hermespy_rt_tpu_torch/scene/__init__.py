"""Scene data model, HRT reader and writer, Sionna readers and procedural
scenes; ``native`` holds the C++ HRT reader and writer."""
from .model import HostMesh, HostScene, TriangleSoA, flatten_scene
from .hrt import load_hrt, save_hrt, HrtFormatError
from .builders import (box_scene, simple_reflector_scene, ground_plane_scene,
                       random_soup_scene, make_city, write_ply)
from .sionna import load_ply, load_scene, load_sionna_xml, SionnaImportError

__all__ = [
    "HostMesh", "HostScene", "TriangleSoA", "flatten_scene",
    "load_hrt", "save_hrt", "HrtFormatError",
    "box_scene", "simple_reflector_scene", "ground_plane_scene",
    "random_soup_scene", "make_city", "write_ply",
    "load_ply", "load_scene", "load_sionna_xml", "SionnaImportError",
]
