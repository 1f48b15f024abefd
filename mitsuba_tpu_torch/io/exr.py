"""OpenEXR reading and writing (port of mitsuba_tpu/io/exr.py; the
reference links IlmImf, src/libcore/bitmap.cpp readOpenEXR/writeOpenEXR).

* write: scanline images, HALF or FLOAT channels, NONE or ZIPS
  compression, byte for byte the reference's file;
* read: scanline images with UINT, HALF or FLOAT channels and NONE (0),
  ZIPS (2), ZIP (3) or PIZ (4, io/piz.py) compression.  Tiled files raise.

Format: "OpenEXR File Layout" (openexr.com), public spec.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from mitsuba_tpu_torch.io.piz import piz_uncompress

_MAGIC = 20000630
_PIXELTYPE = {0: np.uint32, 1: np.float16, 2: np.float32}
_PT_SIZE = {0: 4, 1: 2, 2: 4}
# compression id -> scanlines per chunk
_COMPRESSION_LINES = {0: 1, 2: 1, 3: 16, 4: 32}


def _write_attr(f, name: bytes, typ: bytes, data: bytes):
    f.write(name + b"\x00" + typ + b"\x00")
    f.write(struct.pack("<i", len(data)))
    f.write(data)


def write_exr(path, image, half=True, compression="zips"):
    """Write an [H, W, C] float array (C = 1, 3 or 4: Y, RGB or RGBA) as
    a scanline EXR of HALF (or FLOAT) channels, one scanline a chunk,
    ZIPS-compressed ("zips") or raw ("none")."""
    img = np.asarray(image, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    names = {1: ["Y"], 3: ["R", "G", "B"], 4: ["R", "G", "B", "A"]}[c]
    # EXR requires channels sorted by name
    order = sorted(range(c), key=lambda i: names[i])
    pt = 1 if half else 2
    dtype = np.float16 if half else np.float32
    comp_id = {"none": 0, "zips": 2}[compression]

    with open(path, "wb") as f:
        f.write(struct.pack("<ii", _MAGIC, 2))
        chan = b""
        for i in order:
            chan += names[i].encode() + b"\x00"
            chan += struct.pack("<iBBBBii", pt, 0, 0, 0, 0, 1, 1)
        chan += b"\x00"
        _write_attr(f, b"channels", b"chlist", chan)
        _write_attr(f, b"compression", b"compression", bytes([comp_id]))
        box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
        _write_attr(f, b"dataWindow", b"box2i", box)
        _write_attr(f, b"displayWindow", b"box2i", box)
        _write_attr(f, b"lineOrder", b"lineOrder", b"\x00")
        _write_attr(f, b"pixelAspectRatio", b"float", struct.pack("<f", 1.0))
        _write_attr(f, b"screenWindowCenter", b"v2f", struct.pack("<ff", 0.0, 0.0))
        _write_attr(f, b"screenWindowWidth", b"float", struct.pack("<f", 1.0))
        f.write(b"\x00")  # end of header

        offset_table_pos = f.tell()
        f.write(b"\x00" * 8 * h)  # placeholder offsets

        offsets = []
        for y in range(h):
            offsets.append(f.tell())
            scan = np.concatenate(
                [np.ascontiguousarray(img[y, :, i].astype(dtype)).view(np.uint8)
                 for i in order]
            ).tobytes()
            packed = _zip_compress(scan) if comp_id == 2 else scan
            if len(packed) >= len(scan):
                packed = scan  # spec: store raw if not smaller
            f.write(struct.pack("<ii", y, len(packed)))
            f.write(packed)

        f.seek(offset_table_pos)
        f.write(struct.pack("<%dQ" % h, *offsets))


def _zip_compress(raw: bytes) -> bytes:
    """EXR ZIP predictor (ImfZip.cpp): reorder-split, delta-encode, deflate."""
    arr = np.frombuffer(raw, np.uint8)
    n = len(arr)
    half = (n + 1) // 2
    split = np.empty(n, np.uint8)
    split[:half] = arr[0::2]
    split[half:] = arr[1::2]
    delta = split.astype(np.int64)
    delta[1:] = delta[1:] - split[:-1].astype(np.int64) + 128
    return zlib.compress((delta & 0xFF).astype(np.uint8).tobytes())


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
        elif comp == 4 and sz != expected:
            chunk = piz_uncompress(chunk, channels, w, ln)
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
