"""OpenEXR reading (port of the read side of mitsuba_tpu/io/exr.py; the
reference links IlmImf, src/libcore/bitmap.cpp readOpenEXR).

Scanline images with UINT, HALF or FLOAT channels and NONE (0), ZIPS (2)
or ZIP (3) compression.  PIZ (4) and tiled files raise.  Format: "OpenEXR
File Layout" (openexr.com), public spec.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = 20000630
_PIXELTYPE = {0: np.uint32, 1: np.float16, 2: np.float32}
_PT_SIZE = {0: 4, 1: 2, 2: 4}
# compression id -> scanlines per chunk
_COMPRESSION_LINES = {0: 1, 2: 1, 3: 16}


def _zip_decompress(data: bytes, expected: int) -> bytes:
    """Inverse of the EXR ZIP predictor (ImfZip.cpp): inflate, undo the
    byte deltas, then interleave the two halves."""
    arr = np.frombuffer(zlib.decompress(data), np.uint8)
    n = len(arr)
    # un-delta over the whole buffer: t[i] = t[i-1] + d[i] - 128 (mod 256)
    deltas = arr.astype(np.int64)
    deltas[1:] -= 128
    flat = (np.cumsum(deltas) & 0xFF).astype(np.uint8)
    # first half to even positions, second half to odd
    half = (n + 1) // 2
    out = np.empty(n, np.uint8)
    out[0::2] = flat[:half]
    out[1::2] = flat[half:]
    return out.tobytes()[:expected]


def _header(data: bytes, path):
    """(attributes {name: (type, bytes)}, offset past the header)."""
    magic, version = struct.unpack_from("<ii", data, 0)
    if magic != _MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    if version & 0x200:
        raise NotImplementedError("tiled EXR not supported")
    pos = 8

    def read_cstr(p):
        end = data.index(b"\x00", p)
        return data[p:end].decode("latin1"), end + 1

    attrs = {}
    while data[pos] != 0:
        name, pos = read_cstr(pos)
        typ, pos = read_cstr(pos)
        (size,) = struct.unpack_from("<i", data, pos)
        pos += 4
        attrs[name] = (typ, data[pos:pos + size])
        pos += size
    return attrs, pos + 1


def _channels(chlist: bytes):
    """[(name, pixel type)] of a chlist attribute, in file order."""
    out, cpos = [], 0
    while chlist[cpos] != 0:
        end = chlist.index(b"\x00", cpos)
        name = chlist[cpos:end].decode("latin1")
        pt = struct.unpack_from("<i", chlist, end + 1)[0]
        cpos = end + 1 + 16  # pixel type, pLinear, 3 reserved, x/y sampling
        out.append((name, pt))
    return out


def read_exr(path):
    """Read a scanline EXR -> (float32 [H, W, C] array, channel names),
    with R, G, B, A first where present, then the rest in file order."""
    with open(path, "rb") as f:
        data = f.read()
    attrs, pos = _header(data, path)
    channels = _channels(attrs["channels"][1])
    comp = attrs["compression"][1][0]
    if comp == 4:
        raise NotImplementedError("EXR compression 4 (PIZ) not yet ported")
    if comp not in _COMPRESSION_LINES:
        raise NotImplementedError(f"EXR compression {comp} not supported")
    xmin, ymin, xmax, ymax = struct.unpack("<iiii", attrs["dataWindow"][1])
    w, h = xmax - xmin + 1, ymax - ymin + 1

    lines_per_chunk = _COMPRESSION_LINES[comp]
    nchunks = (h + lines_per_chunk - 1) // lines_per_chunk
    offsets = struct.unpack_from("<%dQ" % nchunks, data, pos)

    planes = {name: np.zeros((h, w), np.float32) for name, _ in channels}
    bytes_per_line = sum(_PT_SIZE[pt] * w for _, pt in channels)
    for off in offsets:
        y, sz = struct.unpack_from("<ii", data, off)
        chunk = data[off + 8:off + 8 + sz]
        ln = min(lines_per_chunk, ymax - y + 1)
        expected = bytes_per_line * ln
        if comp in (2, 3) and sz != expected:  # stored raw when not smaller
            chunk = _zip_decompress(chunk, expected)
        cp = 0
        for line in range(ln):
            for name, pt in channels:
                nbytes = _PT_SIZE[pt] * w
                planes[name][y - ymin + line] = np.frombuffer(
                    chunk[cp:cp + nbytes], _PIXELTYPE[pt]
                ).astype(np.float32)
                cp += nbytes

    names = [c for c, _ in channels]
    pref = [n for n in ("R", "G", "B", "A") if n in names]
    if pref:
        names = pref + [n for n in names if n not in pref]
    return np.stack([planes[n] for n in names], axis=-1), names
