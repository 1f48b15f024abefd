"""Triangle meshes: the `MeshData` container and the PLY reader (port of
mitsuba_tpu/io/meshes.py; the OBJ and `.serialized` readers are not
ported yet).

PLY: ascii and binary in both byte orders, with vertex normals, texture
coordinates and colours (`red green blue`, over 255) when present
(reference src/shapes/ply/*).
Polygons are fan-triangulated.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class MeshData:
    positions: np.ndarray  # [V, 3] float32
    indices: np.ndarray  # [T, 3] uint32
    normals: np.ndarray | None = None  # [V, 3]
    texcoords: np.ndarray | None = None  # [V, 2]
    colors: np.ndarray | None = None  # [V, 3], read by the vertexcolors texture
    face_normals: bool = False
    name: str = ""


_PLY_TYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def _read_header(f, path):
    """-> (format, [(element, count, [(prop, dtype, is_list, count_dtype)])])"""
    if f.readline().strip() != b"ply":
        raise ValueError(f"{path}: not a PLY file")
    fmt = None
    elements = []
    while True:
        raw = f.readline()
        if not raw:
            raise ValueError(f"{path}: PLY header has no end_header")
        line = raw.decode("latin1").strip()
        if line.startswith("comment") or not line:
            continue
        parts = line.split()
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append(
                    (parts[4], _PLY_TYPES[parts[3]], True, _PLY_TYPES[parts[2]])
                )
            else:
                elements[-1][2].append((parts[2], _PLY_TYPES[parts[1]], False, None))
        elif parts[0] == "end_header":
            return fmt, elements


def _read_ascii(f, elements):
    data = {}
    for name, count, props in elements:
        rows = {p[0]: [] for p in props}
        for _ in range(count):
            toks = f.readline().split()
            t = 0
            for pname, _, is_list, _ in props:
                if is_list:
                    n = int(toks[t])
                    t += 1
                    rows[pname].append([float(x) for x in toks[t:t + n]])
                    t += n
                else:
                    rows[pname].append(float(toks[t]))
                    t += 1
        data[name] = rows
    return data


def _read_binary(f, elements, endian):
    data = {}
    for name, count, props in elements:
        rows = {p[0]: [] for p in props}
        if all(not p[2] for p in props):
            dt = np.dtype([(p[0], endian + p[1]) for p in props])
            arr = np.frombuffer(f.read(dt.itemsize * count), dt)
            for pname, *_ in props:
                rows[pname] = arr[pname]
        else:
            for _ in range(count):
                for pname, dt, is_list, cdt in props:
                    it = np.dtype(endian + dt)
                    if is_list:
                        cs = np.dtype(endian + cdt)
                        n = int(np.frombuffer(f.read(cs.itemsize), cs)[0])
                        rows[pname].append(
                            np.frombuffer(f.read(it.itemsize * n), it).astype(np.int64)
                        )
                    else:
                        rows[pname].append(np.frombuffer(f.read(it.itemsize), it)[0])
        data[name] = rows
    return data


def load_ply(path) -> list[MeshData]:
    """Read a PLY file into one MeshData (positions, fan-triangulated
    faces, and normals, uv and colours when the vertex element has them)."""
    with open(path, "rb") as f:
        fmt, elements = _read_header(f, path)
        if fmt == "ascii":
            data = _read_ascii(f, elements)
        else:
            endian = {"binary_little_endian": "<", "binary_big_endian": ">"}.get(fmt)
            if endian is None:
                raise ValueError(f"{path}: unknown PLY format {fmt!r}")
            data = _read_binary(f, elements, endian)

    v = data["vertex"]

    def stack(*keys):
        return np.stack([np.asarray(v[k]) for k in keys], axis=-1).astype(np.float32)

    positions = stack("x", "y", "z")
    normals = stack("nx", "ny", "nz") if "nx" in v else None
    texcoords = None
    for ukey, vkey in (("u", "v"), ("s", "t")):
        if ukey in v:
            texcoords = stack(ukey, vkey)
            break
    colors = stack("red", "green", "blue") / 255.0 if "red" in v else None

    face_el = data.get("face", data.get("faces"))
    key = "vertex_indices" if "vertex_indices" in face_el else "vertex_index"
    tris = []
    for poly in face_el[key]:
        poly = np.asarray(poly, np.int64)
        for k in range(1, len(poly) - 1):
            tris.append([poly[0], poly[k], poly[k + 1]])
    return [
        MeshData(
            positions=positions,
            indices=np.asarray(tris, np.uint32).reshape(-1, 3),
            normals=normals,
            texcoords=texcoords,
            colors=colors,
        )
    ]
