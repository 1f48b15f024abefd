"""Image reading by file extension (port of the read side of
mitsuba_tpu/io/images.py; the format dispatch of reference
src/libcore/bitmap.cpp).  `read_image` returns (float32 [H, W, C],
is_ldr): LDR formats come in their stored (gamma) space and the caller
de-gammas them.  The writers are not ported yet."""

from __future__ import annotations

import os

import numpy as np

_PIL_FORMATS = (".jpg", ".jpeg", ".tga", ".bmp", ".gif", ".webp")


def read_image(path):
    ext = os.path.splitext(path)[1].lower()
    if ext == ".exr":
        from mitsuba_tpu_torch.io.exr import read_exr

        return read_exr(path)[0], False
    if ext == ".pfm":
        from mitsuba_tpu_torch.io.pfm import read_pfm

        return read_pfm(path), False
    if ext == ".png":
        from mitsuba_tpu_torch.io.png import read_png

        return read_png(path), True
    if ext in (".hdr", ".rgbe"):
        return read_rgbe(path), False
    if ext in _PIL_FORMATS:
        # LDR formats decoded by PIL (the reference links libjpeg and
        # others, bitmap.cpp readJPEG/readTGA/readBMP)
        try:
            from PIL import Image
        except ImportError as e:
            raise NotImplementedError(
                f"{ext} support requires PIL, which is unavailable: {path}"
            ) from e
        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"), np.float32) / 255.0, True
    raise ValueError(f"unsupported image format: {path}")


def read_rgbe(path):
    """Radiance RGBE (reference bitmap.cpp readRGBE), flat or
    run-length-encoded scanlines -> float32 [H, W, 3]."""
    with open(path, "rb") as f:
        if not f.readline().startswith(b"#?"):
            raise ValueError(f"{path}: not an RGBE file")
        while f.readline().strip():
            pass
        dims = f.readline().split()
        h, w = int(dims[1]), int(dims[3])
        data = f.read()
    rows = []
    pos = 0
    for _ in range(h):
        if (
            pos + 4 <= len(data)
            and data[pos] == 2
            and data[pos + 1] == 2
            and (data[pos + 2] << 8 | data[pos + 3]) == w
        ):
            pos += 4
            row = np.empty((4, w), np.uint8)
            for c in range(4):
                x = 0
                while x < w:
                    count = data[pos]
                    pos += 1
                    if count > 128:  # a run
                        row[c, x:x + count - 128] = data[pos]
                        pos += 1
                        x += count - 128
                    else:
                        row[c, x:x + count] = np.frombuffer(data[pos:pos + count], np.uint8)
                        pos += count
                        x += count
            rows.append(row.T)
        else:
            rows.append(np.frombuffer(data[pos:pos + 4 * w], np.uint8).reshape(w, 4))
            pos += 4 * w
    rgbe = np.stack(rows)  # [h, w, 4]
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e > 0, np.exp2(e - 136.0), 0.0)
    return (rgbe[..., :3].astype(np.float32) + 0.5) * scale[..., None]
