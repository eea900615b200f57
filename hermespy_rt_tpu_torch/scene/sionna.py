"""Sionna / Mitsuba scene importer (XML + binary PLY + optional CSV sidecar).

The port's own copy of :mod:`hermespy_rt_tpu.scene.sionna` (numpy host
code; the port imports nothing of the JAX package).  It reads a
Mitsuba-style scene XML, loads each ``<shape>``'s binary little-endian PLY
mesh, assigns materials from ``id="mat-itu_<name>"`` BSDF references, bakes
``<transform name="to_world">`` blocks (``<matrix>``, ``<translate>``,
``<rotate>``, ``<scale>``) into the vertices in float64, and applies
per-mesh material/velocity overrides from a ``<scene>.csv`` sidecar, as the C
reference's converter (``scene_fromSionna.c``) does.  XML that is not well
formed falls back to a tolerant regex scan in the manner of that converter
(no transforms there).  ``box.xml`` and ``simple_reflector.xml`` are served
from the procedural builders, as the reference hard-codes them.
"""
from __future__ import annotations

import math
import os
import re
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..materials import get_material_index
from .builders import box_scene, simple_reflector_scene
from .model import HostMesh, HostScene

__all__ = ["load_ply", "load_sionna_xml", "load_scene", "SionnaImportError"]

MAX_PLY_ELEMENTS = 1_000_000  # the reference converter's limit


class SionnaImportError(ValueError):
    pass


def load_ply(path: str) -> HostMesh:
    """Read a binary little-endian PLY with float x,y,z[,...] vertex properties
    and uchar-counted integer face lists.

    Any number of float/double vertex properties is accepted; the first three
    are taken as x,y,z.  Faces must be triangles.
    """
    with open(path, "rb") as f:
        header_lines = []
        while True:
            line = f.readline()
            if not line:
                raise SionnaImportError(f"{path}: truncated PLY header")
            text = line.decode("ascii", errors="replace").strip()
            header_lines.append(text)
            if text == "end_header":
                break

        if not header_lines or header_lines[0] != "ply":
            raise SionnaImportError(f"{path}: not a PLY file")
        fmt = next((ln for ln in header_lines if ln.startswith("format ")), "")
        if "binary_little_endian" not in fmt:
            raise SionnaImportError(
                f"{path}: only binary_little_endian PLY supported")

        num_vertices = num_faces = 0
        vertex_props: List[str] = []
        cur_element = None
        sizes = {"float": 4, "float32": 4, "double": 8, "float64": 8,
                 "uchar": 1, "uint8": 1, "char": 1, "int8": 1,
                 "ushort": 2, "uint16": 2, "short": 2, "int16": 2,
                 "uint": 4, "uint32": 4, "int": 4, "int32": 4}
        for ln in header_lines:
            parts = ln.split()
            if not parts:
                continue
            if parts[0] == "element":
                cur_element = parts[1]
                if cur_element == "vertex":
                    num_vertices = int(parts[2])
                elif cur_element == "face":
                    num_faces = int(parts[2])
            elif parts[0] == "property" and cur_element == "vertex":
                if parts[1] == "list":
                    raise SionnaImportError(
                        f"{path}: list vertex properties unsupported")
                vertex_props.append(parts[1])

        if num_vertices == 0 or num_faces == 0:
            raise SionnaImportError(
                f"{path}: PLY vertex or face element missing")
        if num_vertices > MAX_PLY_ELEMENTS or num_faces > MAX_PLY_ELEMENTS:
            raise SionnaImportError(f"{path}: PLY element too big")
        if len(vertex_props) < 3 or any(
                p not in ("float", "float32", "double", "float64")
                for p in vertex_props[:3]):
            raise SionnaImportError(
                f"{path}: first 3 vertex properties must be float x,y,z")

        stride = sum(sizes[p] for p in vertex_props)
        vdata = f.read(stride * num_vertices)
        if len(vdata) != stride * num_vertices:
            raise SionnaImportError(f"{path}: truncated vertex data")
        raw = np.frombuffer(vdata, dtype=np.uint8).reshape(num_vertices,
                                                           stride)
        cols = []
        off = 0
        for p in vertex_props[:3]:
            dt = "<f4" if sizes[p] == 4 else "<f8"
            cols.append(raw[:, off:off + sizes[p]].copy().view(dt)[:, 0])
            off += sizes[p]
        vertices = np.stack(cols, axis=-1).astype(np.float32)

        # faces: a uchar count then three int32 indices, a fixed 13-byte
        # stride, decoded at once
        fdata = f.read(13 * num_faces)
        if len(fdata) != 13 * num_faces:
            raise SionnaImportError(f"{path}: truncated face data")
        fraw = np.frombuffer(fdata, dtype=np.uint8).reshape(num_faces, 13)
        if not np.all(fraw[:, 0] == 3):
            raise SionnaImportError(f"{path}: non-triangle face found")
        indices = fraw[:, 1:].copy().view("<u4").reshape(num_faces, 3)

    return HostMesh(vertices=vertices, indices=indices.astype(np.uint32))


_SHAPE_RE = re.compile(r"<shape\b", re.S)
_NAME_RE = re.compile(r'name="([^"]*)"')
_FILENAME_RE = re.compile(r'<string\s+name="filename"\s+value="([^"]*)"')
_MATERIAL_RE = re.compile(r'id="mat-itu_([^"]*)"')


def _parse_shapes_regex(xml_text: str) -> List[Tuple[str, str, str]]:
    """Tolerant shape extraction, as the reference's ``strstr`` scanner: per
    ``<shape`` block the first ``name="..."``, the ``filename`` string value
    after it, and the first ``id="mat-itu_..."`` after that."""
    out = []
    starts = [m.start() for m in _SHAPE_RE.finditer(xml_text)]
    if not starts:
        raise SionnaImportError("no shapes found in the xml file")
    for start in starts:
        block = xml_text[start:]
        name_m = _NAME_RE.search(block)
        if not name_m:
            raise SionnaImportError("cannot find mesh name")
        file_m = _FILENAME_RE.search(block, name_m.end())
        if not file_m:
            raise SionnaImportError("cannot find mesh file path")
        mat_m = _MATERIAL_RE.search(block, file_m.end())
        if not mat_m:
            raise SionnaImportError("cannot find mesh material")
        out.append((name_m.group(1), file_m.group(1), mat_m.group(1)))
    return out


def _vec3_attr(el, default=0.0) -> np.ndarray:
    """x/y/z attributes (Mitsuba also allows ``value="x y z"`` and
    ``value=s``)."""
    if "value" in el.attrib:
        parts = el.attrib["value"].replace(",", " ").split()
        if len(parts) == 1:
            return np.full(3, float(parts[0]), np.float64)
        return np.array([float(p) for p in parts[:3]], np.float64)
    return np.array([float(el.attrib.get(a, default)) for a in "xyz"],
                    np.float64)


def _transform_matrix(tr_el) -> np.ndarray:
    """Compose a Mitsuba ``<transform>`` block into one 4x4 float64 matrix.

    Children are applied in document order, each acting *after* the previous
    ones (Mitsuba semantics), i.e. ``M = M_last @ ... @ M_first``.
    """
    m = np.eye(4, dtype=np.float64)
    for child in tr_el:
        tag = child.tag.lower()
        step = np.eye(4, dtype=np.float64)
        if tag == "matrix":
            vals = [float(v) for v in child.attrib["value"].split()]
            if len(vals) == 16:
                step = np.array(vals, np.float64).reshape(4, 4)
            elif len(vals) == 9:
                step[:3, :3] = np.array(vals, np.float64).reshape(3, 3)
            else:
                raise SionnaImportError(
                    f"<matrix> needs 9 or 16 values, got {len(vals)}")
        elif tag == "translate":
            step[:3, 3] = _vec3_attr(child)
        elif tag == "scale":
            step[:3, :3] = np.diag(_vec3_attr(child, default=1.0))
        elif tag == "rotate":
            axis = _vec3_attr(child)
            n = np.linalg.norm(axis)
            if n == 0:
                raise SionnaImportError("<rotate> needs a nonzero axis")
            x, y, z = axis / n
            a = math.radians(float(child.attrib.get("angle", 0.0)))
            c, s = math.cos(a), math.sin(a)
            cc = 1.0 - c
            step[:3, :3] = np.array([
                [c + x * x * cc, x * y * cc - z * s, x * z * cc + y * s],
                [y * x * cc + z * s, c + y * y * cc, y * z * cc - x * s],
                [z * x * cc - y * s, z * y * cc + x * s, c + z * z * cc]])
        elif tag == "lookat":
            # camera-style; irrelevant for shape geometry but accepted
            continue
        else:
            raise SionnaImportError(f"unsupported transform child <{tag}>")
        m = step @ m
    return m


def _parse_shapes_etree(xml_text: str):
    """Structured shape extraction via ``xml.etree``: per ``<shape>`` element
    the name (``name``, else ``id`` attribute, raw so that CSV sidecar names
    match), the ``filename`` string value, the ITU material (any
    ``mat-itu_*`` reference inside the shape; none means ``air``, the
    reference's default for an unknown name) and the composed ``to_world``
    transform (None if absent or the identity)."""
    root = ET.fromstring(xml_text)
    out = []
    for i, sh in enumerate(root.iter("shape")):
        name = sh.attrib.get("name", sh.attrib.get("id", f"shape{i}"))
        filename = None
        for st in sh.iter("string"):
            if st.attrib.get("name") == "filename":
                filename = st.attrib.get("value")
                break
        if filename is None:
            raise SionnaImportError(f"shape {name!r}: no filename")
        material = "air"
        for el in sh.iter():
            for v in el.attrib.values():
                if isinstance(v, str) and v.startswith("mat-itu_"):
                    material = v[len("mat-itu_"):]
                    break
            else:
                continue
            break
        transform: Optional[np.ndarray] = None
        for tr in sh.iter("transform"):
            if tr.attrib.get("name", "to_world") == "to_world":
                mat = _transform_matrix(tr)
                if not np.allclose(mat, np.eye(4)):
                    transform = mat
                break
        out.append((name, filename, material, transform))
    if not out:
        raise SionnaImportError("no shapes found in the xml file")
    return out


def _read_csv_overrides(path: str) -> Dict[str, Tuple[int, np.ndarray]]:
    """Sidecar CSV ``name,material_index,velocity_x,velocity_y,velocity_z``
    overriding per-mesh material and velocity."""
    overrides: Dict[str, Tuple[int, np.ndarray]] = {}
    with open(path, "r") as f:
        header = f.readline()
        if not header.startswith(
                "name,material_index,velocity_x,velocity_y,velocity_z"):
            raise SionnaImportError(f"{path}: invalid CSV header")
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split(",")
            if len(parts) != 5:
                raise SionnaImportError(f"{path}: cannot parse line {line!r}")
            vel = np.array([float(parts[2]), float(parts[3]),
                            float(parts[4])], np.float32)
            overrides[parts[0]] = (int(parts[1]), vel)
    return overrides


def load_sionna_xml(xml_path: str) -> HostScene:
    """Load a Sionna/Mitsuba scene: XML shapes -> PLY meshes (resolved
    relative to the XML's directory, ``to_world`` transforms baked into the
    vertices in float64, then cast to float32) + ITU materials + the
    optional CSV overrides."""
    with open(xml_path, "r") as f:
        xml_text = f.read()
    try:
        shapes = _parse_shapes_etree(xml_text)
    except ET.ParseError:
        shapes = [(n, p, m, None)
                  for n, p, m in _parse_shapes_regex(xml_text)]

    csv_path = os.path.splitext(xml_path)[0] + ".csv"
    overrides = (_read_csv_overrides(csv_path) if os.path.exists(csv_path)
                 else {})

    scene_dir = os.path.dirname(os.path.abspath(xml_path))
    meshes = []
    for name, rel_path, material_name, transform in shapes:
        mesh = load_ply(os.path.join(scene_dir, rel_path))
        mesh.name = name
        mesh.material_index = get_material_index(material_name)
        if transform is not None:
            v = mesh.vertices.astype(np.float64)
            v = v @ transform[:3, :3].T + transform[:3, 3]
            mesh.vertices = v.astype(np.float32)
        if name in overrides:
            mesh.material_index, mesh.velocity = overrides[name]
        meshes.append(mesh)
    return HostScene(meshes=meshes)


def load_scene(path: str) -> HostScene:
    """Load any supported scene: ``.hrt``, Sionna ``.xml`` (the reference's
    two hard-coded names ``box.xml`` and ``simple_reflector.xml`` served by
    the builders) or a single ``.ply``; other extensions raise
    :class:`SionnaImportError` (a ``ValueError``)."""
    base = os.path.basename(str(path))
    if base == "box.xml":
        return box_scene()
    if base == "simple_reflector.xml":
        return simple_reflector_scene()
    ext = os.path.splitext(str(path))[1].lower()
    if ext == ".hrt":
        from .hrt import load_hrt
        return load_hrt(path)
    if ext == ".xml":
        return load_sionna_xml(path)
    if ext == ".ply":
        return HostScene([load_ply(path)])
    raise SionnaImportError(f"unsupported scene file type: {path}")
