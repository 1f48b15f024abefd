"""Portable FloatMap I/O (port of mitsuba_tpu/io/pfm.py; reference
src/libcore/bitmap.cpp readPFM/writePFM)."""

from __future__ import annotations

import numpy as np


def write_pfm(path, image):
    """[H, W, C] float, C = 1 ("Pf") or 3 ("PF"); little endian, bottom
    row first."""
    img = np.asarray(image, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if c not in (1, 3):
        raise ValueError("PFM supports 1 or 3 channels")
    data = img[..., 0] if c == 1 else img
    with open(path, "wb") as f:
        f.write(b"Pf\n" if c == 1 else b"PF\n")
        f.write(f"{w} {h}\n".encode())
        f.write(b"-1.0\n")  # little endian
        f.write(np.flipud(data).astype("<f4").tobytes())


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
