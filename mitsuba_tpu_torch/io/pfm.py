"""Portable FloatMap reading (port of mitsuba_tpu/io/pfm.py read_pfm;
reference src/libcore/bitmap.cpp readPFM)."""

from __future__ import annotations

import numpy as np


def read_pfm(path):
    """-> float32 [H, W, C], C = 3 ("PF") or 1 ("Pf"), top row first."""
    with open(path, "rb") as f:
        kind = f.readline().strip()
        c = 3 if kind == b"PF" else 1
        dims = f.readline().split()
        w, h = int(dims[0]), int(dims[1])
        scale = float(f.readline().strip())
        dt = "<f4" if scale < 0 else ">f4"
        data = np.frombuffer(f.read(w * h * c * 4), dt).reshape(h, w, c)
    return np.flipud(data).astype(np.float32)
