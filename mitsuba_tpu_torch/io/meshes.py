"""Triangle meshes: the `MeshData` container and the OBJ, PLY and
Mitsuba `.serialized` readers, and the `.serialized` writer (port of
mitsuba_tpu/io/meshes.py).

* OBJ: v/vn/vt/f with negative indices, one mesh per `usemtl` group,
  corners re-indexed by their (position, uv, normal) triple (reference
  src/shapes/obj.cpp).
* PLY: ascii and binary in both byte orders, with vertex normals, texture
  coordinates and colours (`red green blue`, over 255) when present
  (reference src/shapes/ply/*).
* `.serialized`: little-endian, magic 0x041C, version 3 or 4, one
  zlib-deflated mesh per chunk and a trailing offset table, the flags
  word's normals / texcoords / colours / face-normals / precision bits
  (reference src/librender/trimesh.cpp:34-36, 89-96, 180-300).

Polygons are fan-triangulated.
"""

from __future__ import annotations

import struct
import zlib
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


def load_obj(path) -> list[MeshData]:
    """Read an OBJ file: one MeshData per material group, in the order the
    groups first appear (reference io/meshes.py:41-135)."""
    positions, normals, texcoords = [], [], []
    # (position, uv, normal) index triples per corner, by material group
    groups: dict[str, list] = {}
    current = "default"

    def resolve(idx, n):
        i = int(idx)
        return i - 1 if i > 0 else n + i

    with open(path, "r", errors="replace") as f:
        for line in f:
            if not line or line[0] in "#\n":
                continue
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            if tag == "v":
                positions.append([float(x) for x in parts[1:4]])
            elif tag == "vn":
                normals.append([float(x) for x in parts[1:4]])
            elif tag == "vt":
                texcoords.append([float(x) for x in parts[1:3]])
            elif tag == "usemtl":
                current = parts[1] if len(parts) > 1 else "default"
            elif tag == "f":
                corners = []
                for tok in parts[1:]:
                    sub = tok.split("/")
                    pi = resolve(sub[0], len(positions))
                    ti = resolve(sub[1], len(texcoords)) if len(sub) > 1 and sub[1] else -1
                    ni = resolve(sub[2], len(normals)) if len(sub) > 2 and sub[2] else -1
                    corners.append((pi, ti, ni))
                tris = groups.setdefault(current, [])
                for k in range(1, len(corners) - 1):
                    tris.append((corners[0], corners[k], corners[k + 1]))

    positions = np.asarray(positions, np.float32)
    normals = np.asarray(normals, np.float32) if normals else None
    texcoords = np.asarray(texcoords, np.float32) if texcoords else None
    meshes = []
    for name, tris in groups.items():
        if not tris:
            continue
        corner_map: dict[tuple, int] = {}
        v_pos, v_nrm, v_uv, idx = [], [], [], []
        has_n = any(c[2] >= 0 for tri in tris for c in tri)
        has_t = any(c[1] >= 0 for tri in tris for c in tri)
        for tri in tris:
            face = []
            for c in tri:
                if c not in corner_map:
                    corner_map[c] = len(v_pos)
                    v_pos.append(positions[c[0]])
                    if has_t:
                        v_uv.append(texcoords[c[1]] if c[1] >= 0 else np.zeros(2))
                    if has_n:
                        v_nrm.append(normals[c[2]] if c[2] >= 0 else np.zeros(3))
                face.append(corner_map[c])
            idx.append(face)
        meshes.append(MeshData(
            positions=np.asarray(v_pos, np.float32),
            indices=np.asarray(idx, np.uint32),
            normals=np.asarray(v_nrm, np.float32) if has_n else None,
            texcoords=np.asarray(v_uv, np.float32) if has_t else None,
            name=name,
        ))
    return meshes


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


# the .serialized flags word (reference trimesh.cpp:89-96)
_EHasNormals = 0x0001
_EHasTexcoords = 0x0002
_EHasColors = 0x0008
_EFaceNormals = 0x0010
_ESinglePrecision = 0x1000
_EDoublePrecision = 0x2000


def load_serialized(path, shape_index=0) -> list[MeshData]:
    """Read mesh `shape_index` of a .serialized container (reference
    io/meshes.py:287-360): the chunk's offset comes from the table at the
    file's end (64-bit in version 4, 32-bit in version 3)."""
    with open(path, "rb") as f:
        blob = f.read()
    fmt, version = struct.unpack_from("<hh", blob, 0)
    if fmt != 0x041C:
        raise ValueError(f"{path}: bad magic 0x{fmt:04x}")
    if version not in (3, 4):
        raise ValueError(f"{path}: unsupported version {version}")
    offset = 4
    if shape_index != 0:
        (count,) = struct.unpack_from("<I", blob, len(blob) - 4)
        if shape_index >= count:
            raise IndexError(f"{path}: shape index {shape_index} out of range 0..{count - 1}")
        if version == 4:
            (offset,) = struct.unpack_from("<Q", blob, len(blob) - 4 - 8 * (count - shape_index))
        else:
            (offset,) = struct.unpack_from("<I", blob, len(blob) - 4 * (count - shape_index + 1))
        offset += 4  # the chunk's own header
    raw = zlib.decompressobj().decompress(blob[offset:])
    pos = 0
    (flags,) = struct.unpack_from("<I", raw, pos)
    pos += 4
    name = ""
    if version == 4:
        end = raw.index(b"\x00", pos)
        name = raw[pos:end].decode("latin1")
        pos = end + 1
    vcount, tcount = struct.unpack_from("<QQ", raw, pos)
    pos += 16
    ft = np.dtype("<f8" if flags & _EDoublePrecision else "<f4")

    def take(n):
        nonlocal pos
        arr = np.frombuffer(raw, ft, count=n, offset=pos)
        pos += n * ft.itemsize
        return arr.astype(np.float32)

    positions = take(vcount * 3).reshape(vcount, 3)
    normals = take(vcount * 3).reshape(vcount, 3) if flags & _EHasNormals else None
    texcoords = take(vcount * 2).reshape(vcount, 2) if flags & _EHasTexcoords else None
    colors = take(vcount * 3).reshape(vcount, 3) if flags & _EHasColors else None
    indices = np.frombuffer(raw, np.dtype("<u4"), count=tcount * 3, offset=pos).reshape(tcount, 3)
    return [MeshData(
        positions=positions,
        indices=indices.astype(np.uint32),
        normals=normals,
        texcoords=texcoords,
        colors=colors,
        face_normals=bool(flags & _EFaceNormals),
        name=name,
    )]


def save_serialized(path, meshes: list[MeshData]):
    """Write meshes to a version-4 .serialized container, single
    precision, each chunk deflated by zlib at its default level (the
    reference's bytes, io/meshes.py:363-395)."""
    offsets = []
    with open(path, "wb") as f:
        for mesh in meshes:
            offsets.append(f.tell())
            f.write(struct.pack("<hh", 0x041C, 4))
            flags = _ESinglePrecision
            if mesh.normals is not None:
                flags |= _EHasNormals
            if mesh.texcoords is not None:
                flags |= _EHasTexcoords
            if mesh.colors is not None:
                flags |= _EHasColors
            if mesh.face_normals:
                flags |= _EFaceNormals
            raw = struct.pack("<I", flags)
            raw += mesh.name.encode("latin1") + b"\x00"
            raw += struct.pack("<QQ", len(mesh.positions), len(mesh.indices))
            raw += mesh.positions.astype("<f4").tobytes()
            for extra in (mesh.normals, mesh.texcoords, mesh.colors):
                if extra is not None:
                    raw += extra.astype("<f4").tobytes()
            raw += mesh.indices.astype("<u4").tobytes()
            f.write(zlib.compress(raw))
        for off in offsets:
            f.write(struct.pack("<Q", off))
        f.write(struct.pack("<I", len(offsets)))
