"""PNG reading with zlib alone (port of mitsuba_tpu/io/png.py read_png;
the reference links libpng, src/libcore/bitmap.cpp readPNG): 8- and
16-bit grey, grey-alpha, RGB, RGBA and palette images, not interlaced."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline filters -> uint8 [h, stride]."""
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    p = 0
    for y in range(h):
        ftype = raw[p]
        line = np.frombuffer(raw[p + 1:p + 1 + stride], np.uint8).astype(np.int32)
        p += 1 + stride
        if ftype == 0:
            cur = line
        elif ftype == 1:  # sub
            cur = line.copy()
            for i in range(bpp, stride):
                cur[i] = (cur[i] + cur[i - bpp]) & 0xFF
        elif ftype == 2:  # up
            cur = (line + prev) & 0xFF
        elif ftype == 3:  # average
            cur = line.copy()
            for i in range(stride):
                left = cur[i - bpp] if i >= bpp else 0
                cur[i] = (cur[i] + ((left + prev[i]) >> 1)) & 0xFF
        elif ftype == 4:  # Paeth
            cur = line.copy()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = prev[i]
                c = prev[i - bpp] if i >= bpp else 0
                pp = a + b - c
                pa, pb, pc = abs(pp - a), abs(pp - b), abs(pp - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
        else:
            raise ValueError(f"bad PNG filter {ftype}")
        out[y] = cur.astype(np.uint8)
        prev = cur
    return out


def read_png(path):
    """Read a PNG -> float32 [H, W, C] in [0, 1] (no gamma applied)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos = 8
    idat = b""
    w = h = depth = color_type = None
    palette = None
    while pos < len(data):
        (ln,) = struct.unpack_from(">I", data, pos)
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + ln]
        pos += 12 + ln
        if tag == b"IHDR":
            w, h, depth, color_type, _, _, interlace = struct.unpack(">IIBBBBB", body)
            if interlace:
                raise NotImplementedError("interlaced PNG")
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat += body
        elif tag == b"IEND":
            break
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color_type]
    bpp = max(1, channels * depth // 8)
    stride = (w * channels * depth + 7) // 8
    out = _unfilter(zlib.decompress(idat), h, stride, bpp)
    if depth == 8:
        arr = out[:, :w * channels].reshape(h, w, channels).astype(np.float32) / 255.0
    elif depth == 16:
        img = out.view(">u2")[:, :w * channels].reshape(h, w, channels)
        arr = img.astype(np.float32) / 65535.0
    else:
        raise NotImplementedError(f"PNG bit depth {depth}")
    if color_type == 3:
        idx = (arr * 255.0 + 0.5).astype(np.int32)[..., 0]
        arr = palette[idx].astype(np.float32) / 255.0
    return arr
