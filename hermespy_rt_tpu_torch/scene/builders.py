"""Procedural scenes (numpy), identical to :mod:`hermespy_rt_tpu.scene.builders`:
the reference's 10x10x5 m concrete box and 1x1 m reflector plate, a ground
plane and a seeded random triangle soup; and the config-5 city of
``benchmarks/config5_scene.py`` written as a Sionna scene (XML + binary PLY),
byte for byte as that script writes it."""
from __future__ import annotations

import os

import numpy as np

from ..materials import MATERIAL_CONCRETE
from .model import HostMesh, HostScene

__all__ = ["box_scene", "simple_reflector_scene", "ground_plane_scene",
           "random_soup_scene", "make_city", "write_ply"]


def box_scene() -> HostScene:
    """10x10x5 m concrete box, winding as in the reference."""
    vs = np.array([
        [5, 5, 0], [-5, 5, 0], [-5, -5, 0], [5, -5, 0],
        [5, 5, 5], [-5, 5, 5], [-5, -5, 5], [5, -5, 5],
    ], np.float32)
    idx = np.array([
        [0, 1, 2], [0, 2, 3], [0, 4, 5], [0, 5, 1], [1, 5, 6], [1, 6, 2],
        [2, 6, 7], [2, 7, 3], [3, 7, 4], [3, 4, 0], [4, 7, 6], [4, 6, 5],
    ], np.uint32)
    return HostScene([HostMesh(vs, idx, material_index=MATERIAL_CONCRETE, name="box")])


def simple_reflector_scene() -> HostScene:
    """1x1 m concrete plate at z=0."""
    vs = np.array([[-0.5, -0.5, 0], [0.5, -0.5, 0], [0.5, 0.5, 0], [-0.5, 0.5, 0]],
                  np.float32)
    idx = np.array([[0, 1, 2], [0, 2, 3]], np.uint32)
    return HostScene([HostMesh(vs, idx, material_index=MATERIAL_CONCRETE,
                               name="reflector")])


def ground_plane_scene(half_extent: float = 100.0,
                       material_index: int = MATERIAL_CONCRETE) -> HostScene:
    vs = np.array([[-half_extent, -half_extent, 0], [half_extent, -half_extent, 0],
                   [half_extent, half_extent, 0], [-half_extent, half_extent, 0]],
                  np.float32)
    idx = np.array([[0, 1, 2], [0, 2, 3]], np.uint32)
    return HostScene([HostMesh(vs, idx, material_index=material_index, name="ground")])


def random_soup_scene(num_triangles: int, seed: int = 0, extent: float = 50.0,
                      tri_size: float = 2.0) -> HostScene:
    """Random triangle soup for kernel stress tests and benchmarks."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-extent, extent, size=(num_triangles, 1, 3))
    offsets = rng.normal(scale=tri_size, size=(num_triangles, 3, 3))
    verts = (centers + offsets).astype(np.float32).reshape(-1, 3)
    idx = np.arange(num_triangles * 3, dtype=np.uint32).reshape(-1, 3)
    return HostScene([HostMesh(verts, idx, material_index=MATERIAL_CONCRETE,
                               name="soup")])


def write_ply(path: str, vertices: np.ndarray, faces: np.ndarray) -> None:
    """Binary little-endian PLY: x,y,z float32 vertices and uchar-counted
    triangle faces, the layout the reference's converter reads."""
    v = np.asarray(vertices, np.float32)
    f = np.asarray(faces, np.uint32)
    with open(path, "wb") as fh:
        fh.write(b"ply\nformat binary_little_endian 1.0\n")
        fh.write(f"element vertex {len(v)}\n".encode())
        fh.write(b"property float x\nproperty float y\nproperty float z\n")
        fh.write(f"element face {len(f)}\n".encode())
        fh.write(b"property list uchar int vertex_indices\nend_header\n")
        fh.write(v.astype("<f4").tobytes())
        rec = np.empty((len(f), 13), np.uint8)
        rec[:, 0] = 3
        rec[:, 1:] = f.astype("<u4").view(np.uint8).reshape(len(f), 12)
        fh.write(rec.tobytes())


def _grid_quads(nx: int, ny: int):
    """Subdivided unit-square triangulation: verts [(nx+1)*(ny+1), 2] in
    [0,1]^2 and faces [nx*ny*2, 3]."""
    xs = np.linspace(0.0, 1.0, nx + 1)
    ys = np.linspace(0.0, 1.0, ny + 1)
    vv = np.stack(np.meshgrid(xs, ys, indexing="ij"), -1).reshape(-1, 2)
    i, j = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    v00 = (i * (ny + 1) + j).ravel()
    v01 = v00 + 1
    v10 = v00 + (ny + 1)
    v11 = v10 + 1
    f = np.concatenate([np.stack([v00, v10, v11], -1),
                        np.stack([v00, v11, v01], -1)])
    return vv, f.astype(np.uint32)


def _box(cx, cy, w, d, h, sub):
    """Box with each face subdivided sub x sub; returns (verts, faces)."""
    verts, faces = [], []
    off = 0
    vv, ff = _grid_quads(sub, sub)

    def face(origin, eu, ev):
        nonlocal off
        p = (np.asarray(origin)[None, :]
             + vv[:, :1] * np.asarray(eu)[None, :]
             + vv[:, 1:2] * np.asarray(ev)[None, :])
        verts.append(p)
        faces.append(ff + off)
        off += len(vv)

    x0, x1 = cx - w / 2, cx + w / 2
    y0, y1 = cy - d / 2, cy + d / 2
    face([x0, y0, 0], [w, 0, 0], [0, d, 0])      # bottom
    face([x0, y0, h], [w, 0, 0], [0, d, 0])      # top
    face([x0, y0, 0], [w, 0, 0], [0, 0, h])      # -y
    face([x0, y1, 0], [w, 0, 0], [0, 0, h])      # +y
    face([x0, y0, 0], [0, d, 0], [0, 0, h])      # -x
    face([x1, y0, 0], [0, d, 0], [0, 0, h])      # +x
    return np.concatenate(verts), np.concatenate(faces)


_CITY_XML = """<scene version="2.1.0">
  <bsdf type="twosided" id="mat-itu_medium_dry_ground"/>
  <bsdf type="twosided" id="mat-itu_concrete"/>
  <shape type="ply" id="mesh-ground" name="ground">
    <string name="filename" value="meshes/ground.ply"/>
    <ref id="mat-itu_medium_dry_ground" name="bsdf"/>
  </shape>
  <shape type="ply" id="mesh-buildings" name="buildings">
    <string name="filename" value="meshes/buildings.ply"/>
    <ref id="mat-itu_concrete" name="bsdf"/>
    <transform name="to_world">
      <translate x="0" y="0" z="{zlift}"/>
    </transform>
  </shape>
</scene>
"""


def make_city(out_dir: str, n_buildings: int = 160, sub: int = 8,
              ground_sub: int = 64, extent: float = 400.0, seed: int = 0,
              zlift: float = 0.05) -> str:
    """Write the procedural city (a subdivided ground plane and a grid of
    box buildings with subdivided faces) as ``out_dir/city.xml`` plus
    ``meshes/{ground,buildings}.ply``; returns the XML's path.

    Triangle count = n_buildings * 12 * sub^2 + 2 * ground_sub^2: 131,072 at
    the defaults.  The building mesh carries a ``to_world`` translate, which
    the importer bakes into its vertices.
    """
    os.makedirs(os.path.join(out_dir, "meshes"), exist_ok=True)
    rng = np.random.default_rng(seed)

    gv, gf = _grid_quads(ground_sub, ground_sub)
    gverts = np.concatenate(
        [(gv - 0.5) * 2 * extent, np.zeros((len(gv), 1))], axis=1)
    write_ply(os.path.join(out_dir, "meshes", "ground.ply"), gverts, gf)

    side = int(np.ceil(np.sqrt(n_buildings)))
    pitch = 2 * extent * 0.9 / side
    verts, faces = [], []
    off = 0
    for b in range(n_buildings):
        gx, gy = b % side, b // side
        cx = -extent * 0.9 + (gx + 0.5) * pitch + rng.uniform(-2, 2)
        cy = -extent * 0.9 + (gy + 0.5) * pitch + rng.uniform(-2, 2)
        w = rng.uniform(0.35, 0.6) * pitch
        d = rng.uniform(0.35, 0.6) * pitch
        h = rng.uniform(8.0, 60.0)
        v, f = _box(cx, cy, w, d, h, sub)
        verts.append(v)
        faces.append(f + off)
        off += len(v)
    write_ply(os.path.join(out_dir, "meshes", "buildings.ply"),
              np.concatenate(verts), np.concatenate(faces))

    xml_path = os.path.join(out_dir, "city.xml")
    with open(xml_path, "w") as fh:
        fh.write(_CITY_XML.format(zlift=zlift))
    return xml_path
