"""A synthetic scene: a procedural city of boxes, written as a Sionna
scene (XML + binary PLY) for the program to read back.

A frozen copy of ``hermespy_rt_tpu_torch/scene/builders.py::make_city``
(with ``_grid_quads``, ``_box`` and ``write_ply``) at commit 4304014e, so
that a change to the program's builders cannot move the yardstick.  Beside
the files it returns the meshes as the reader must see them: the PLY's
float32 vertices, the building mesh's ``to_world`` translate baked in
float64 and cast to float32, and the material ids of the XML's ITU names
(``medium_dry_ground`` 15, ``concrete`` 1).
"""
from __future__ import annotations

import os

import numpy as np

GROUND_MATERIAL, BUILDING_MATERIAL = 15, 1

_XML = """<scene version="2.1.0">
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


def write_ply(path, vertices, faces):
    """Binary little-endian PLY: float32 x, y, z and uchar-counted faces."""
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


def _grid_quads(nx, ny):
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
    verts, faces, off = [], [], 0
    vv, ff = _grid_quads(sub, sub)
    x0, y0, y1, x1 = cx - w / 2, cy - d / 2, cy + d / 2, cx + w / 2
    for origin, eu, ev in (([x0, y0, 0], [w, 0, 0], [0, d, 0]),
                           ([x0, y0, h], [w, 0, 0], [0, d, 0]),
                           ([x0, y0, 0], [w, 0, 0], [0, 0, h]),
                           ([x0, y1, 0], [w, 0, 0], [0, 0, h]),
                           ([x0, y0, 0], [0, d, 0], [0, 0, h]),
                           ([x1, y0, 0], [0, d, 0], [0, 0, h])):
        p = (np.asarray(origin)[None, :]
             + vv[:, :1] * np.asarray(eu)[None, :]
             + vv[:, 1:2] * np.asarray(ev)[None, :])
        verts.append(p)
        faces.append(ff + off)
        off += len(vv)
    return np.concatenate(verts), np.concatenate(faces)


def generate(params: dict, workdir: str) -> dict:
    """``params``: ``n_buildings``, ``sub``, ``ground_sub``, ``extent``,
    ``seed``, ``zlift``.  Writes ``workdir/city.xml`` and its meshes;
    returns the meshes, the XML's path and the building footprints
    ``[n, 4]`` (x0, y0, x1, y1)."""
    n_b, sub = int(params["n_buildings"]), int(params["sub"])
    gsub, extent = int(params["ground_sub"]), float(params["extent"])
    zlift = float(params["zlift"])
    os.makedirs(os.path.join(workdir, "meshes"), exist_ok=True)
    rng = np.random.default_rng(int(params["seed"]))

    gv, gf = _grid_quads(gsub, gsub)
    gverts = np.concatenate([(gv - 0.5) * 2 * extent,
                             np.zeros((len(gv), 1))], axis=1)
    write_ply(os.path.join(workdir, "meshes", "ground.ply"), gverts, gf)

    side = int(np.ceil(np.sqrt(n_b)))
    pitch = 2 * extent * 0.9 / side
    verts, faces, feet, off = [], [], [], 0
    for b in range(n_b):
        gx, gy = b % side, b // side
        cx = -extent * 0.9 + (gx + 0.5) * pitch + rng.uniform(-2, 2)
        cy = -extent * 0.9 + (gy + 0.5) * pitch + rng.uniform(-2, 2)
        w = rng.uniform(0.35, 0.6) * pitch
        d = rng.uniform(0.35, 0.6) * pitch
        h = rng.uniform(8.0, 60.0)
        v, f = _box(cx, cy, w, d, h, sub)
        verts.append(v)
        faces.append(f + off)
        feet.append((cx - w / 2, cy - d / 2, cx + w / 2, cy + d / 2))
        off += len(v)
    bverts, bfaces = np.concatenate(verts), np.concatenate(faces)
    write_ply(os.path.join(workdir, "meshes", "buildings.ply"), bverts,
              bfaces)
    xml = os.path.join(workdir, "city.xml")
    with open(xml, "w") as fh:
        fh.write(_XML.format(zlift=zlift))

    lifted = (bverts.astype(np.float32).astype(np.float64)
              + np.array([0.0, 0.0, zlift])).astype(np.float32)
    return dict(meshes=[(gverts.astype(np.float32), gf, GROUND_MATERIAL),
                        (lifted, bfaces, BUILDING_MATERIAL)],
                file=xml, footprints=np.array(feet))
