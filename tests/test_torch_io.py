"""The port's image readers (mitsuba_tpu_torch/io) against the JAX
package's, array for array: scenes/assets/sky.exr, and small files the
reference's writers produce (EXR without compression, ZIPS and ZIP, half
and float channels; PFM; RGBE; PNG), read by both.  No tolerance: every
comparison is exact.  PIZ and tiled EXR raise by name."""

import os
import struct

import numpy as np
import pytest

from mitsuba_tpu.io import exr as jexr
from mitsuba_tpu.io import images as jimages
from mitsuba_tpu.io import pfm as jpfm
from mitsuba_tpu.io import png as jpng
from mitsuba_tpu_torch.io import exr, images, pfm, png
from tests.torch_meshes import ROOT

SKY = os.path.join(ROOT, "scenes", "assets", "sky.exr")


def _image(shape, seed=0, lo=0.0, hi=4.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _write_zip_exr(path, img, half):
    """A scanline EXR with ZIP compression (id 3, 16 lines per chunk):
    the reference writes only NONE and ZIPS, so this is its writer with
    the chunking of ZIP, deflating through its own `_zip_compress`."""
    h, w, c = img.shape
    names = {1: ["Y"], 3: ["R", "G", "B"], 4: ["R", "G", "B", "A"]}[c]
    order = sorted(range(c), key=lambda i: names[i])
    dtype = np.float16 if half else np.float32
    with open(path, "wb") as f:
        f.write(struct.pack("<ii", jexr._MAGIC, 2))
        chan = b"".join(names[i].encode() + b"\x00"
                        + struct.pack("<iBBBBii", 1 if half else 2, 0, 0, 0, 0, 1, 1)
                        for i in order) + b"\x00"
        jexr._write_attr(f, b"channels", b"chlist", chan)
        jexr._write_attr(f, b"compression", b"compression", bytes([3]))
        box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
        jexr._write_attr(f, b"dataWindow", b"box2i", box)
        jexr._write_attr(f, b"displayWindow", b"box2i", box)
        jexr._write_attr(f, b"lineOrder", b"lineOrder", b"\x00")
        f.write(b"\x00")
        n_chunks = (h + 15) // 16
        table = f.tell()
        f.write(b"\x00" * 8 * n_chunks)
        offsets = []
        for y in range(0, h, 16):
            offsets.append(f.tell())
            raw = b"".join(
                np.ascontiguousarray(img[yy, :, i].astype(dtype)).tobytes()
                for yy in range(y, min(y + 16, h)) for i in order
            )
            packed = jexr._zip_compress(raw)
            if len(packed) >= len(raw):
                packed = raw
            f.write(struct.pack("<ii", y, len(packed)))
            f.write(packed)
        f.seek(table)
        f.write(struct.pack("<%dQ" % n_chunks, *offsets))


def test_sky_exr_equals_reference():
    img, names = exr.read_exr(SKY)
    ref, ref_names = jexr.read_exr(SKY)
    assert names == ref_names == ["R", "G", "B"]
    assert img.shape == (256, 512, 3) and img.dtype == np.float32
    np.testing.assert_array_equal(img, ref)


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("half", [True, False], ids=["half", "float"])
@pytest.mark.parametrize("compression", ["none", "zips", "zip"])
def test_exr_written_by_reference(tmp_path, compression, half, channels):
    src = _image((37, 21, channels), seed=channels)
    src[0, :4] = 0.0  # runs that deflate well
    path = str(tmp_path / "a.exr")
    if compression == "zip":
        _write_zip_exr(path, src, half)
    else:
        jexr.write_exr(path, src, half=half, compression=compression)
    img, names = exr.read_exr(path)
    ref, ref_names = jexr.read_exr(path)
    assert names == ref_names
    assert img.dtype == np.float32
    np.testing.assert_array_equal(img, ref)
    np.testing.assert_array_equal(img, src.astype(np.float16) if half else src)


def test_exr_uint_channel(tmp_path):
    """UINT channels (pixel type 0) come back as float32."""
    path = str(tmp_path / "u.exr")
    jexr.write_exr(path, _image((5, 7, 1)), half=False, compression="none")
    data = bytearray(open(path, "rb").read())
    data[data.index(b"Y\x00") + 2] = 0  # pixel type FLOAT -> UINT, same width
    open(path, "wb").write(bytes(data))
    img, _ = exr.read_exr(path)
    np.testing.assert_array_equal(img, jexr.read_exr(path)[0])


def test_exr_piz_and_tiled_raise(tmp_path):
    path = str(tmp_path / "p.exr")
    jexr.write_exr(path, _image((4, 4, 3)), compression="none")
    data = bytearray(open(path, "rb").read())
    comp = data.index(b"compression\x00compression\x00") + len("compression\x00compression\x00") + 4
    data[comp] = 4
    open(path, "wb").write(bytes(data))
    with pytest.raises(NotImplementedError, match="PIZ"):
        exr.read_exr(path)
    data[comp] = 0
    data[4:8] = struct.pack("<i", 2 | 0x200)
    open(path, "wb").write(bytes(data))
    with pytest.raises(NotImplementedError, match="tiled"):
        exr.read_exr(path)


@pytest.mark.parametrize("channels", [1, 3])
def test_pfm(tmp_path, channels):
    path = str(tmp_path / "a.pfm")
    jpfm.write_pfm(path, _image((9, 13, channels)))
    np.testing.assert_array_equal(pfm.read_pfm(path), jpfm.read_pfm(path))


def _rle_rgbe(path, img):
    """The reference's flat RGBE bytes, re-encoded as run-length
    scanlines (the form most tools write)."""
    jimages.write_rgbe(path, img)
    data = open(path, "rb").read()
    head, body = data.split(b"+X %d\n" % img.shape[1], 1)
    h, w = img.shape[:2]
    px = np.frombuffer(body, np.uint8).reshape(h, w, 4)
    out = bytearray(head + b"+X %d\n" % w)
    for y in range(h):
        out += bytes([2, 2, w >> 8, w & 0xFF])
        for c in range(4):
            row, x = px[y, :, c], 0
            while x < w:
                run = 1
                while x + run < w and run < 127 and row[x + run] == row[x]:
                    run += 1
                if run >= 3:
                    out += bytes([128 + run, row[x]])
                    x += run
                else:
                    n = min(w - x, 128)
                    out += bytes([n]) + row[x:x + n].tobytes()
                    x += n
    open(path, "wb").write(bytes(out))


@pytest.mark.parametrize("rle", [False, True], ids=["flat", "rle"])
def test_rgbe(tmp_path, rle):
    img = _image((11, 17, 3), hi=20.0)
    img[2] = 0.5  # runs
    path = str(tmp_path / "a.hdr")
    if rle:
        _rle_rgbe(path, img)
    else:
        jimages.write_rgbe(path, img)
    out, is_ldr = images.read_image(path)
    assert not is_ldr
    np.testing.assert_array_equal(out, jimages.read_rgbe(path))
    np.testing.assert_array_equal(out, jimages.read_image(path)[0])


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("depth", [8, 16])
def test_png(tmp_path, channels, depth):
    r = np.random.default_rng(channels)
    src = r.integers(0, 2 ** depth, (13, 10, channels)).astype(np.uint8 if depth == 8 else np.uint16)
    path = str(tmp_path / "a.png")
    jpng.write_png(path, src)
    out, is_ldr = images.read_image(path)
    assert is_ldr
    np.testing.assert_array_equal(out, jpng.read_png(path))
    np.testing.assert_array_equal(png.read_png(path), jimages.read_image(path)[0])


def test_png_filters(tmp_path):
    """Scanlines with each of the five PNG filters (the reference writes
    only filter 0): the same bytes as the reference's reader."""
    import zlib

    r = np.random.default_rng(5)
    w, h, c = 9, 10, 3
    rows = r.integers(0, 256, (h, w * c)).astype(np.uint8)
    raw = b"".join(bytes([y % 5]) + rows[y].tobytes() for y in range(h))
    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(jpng._chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(jpng._chunk(b"IDAT", zlib.compress(raw)))
        f.write(jpng._chunk(b"IEND", b""))
    np.testing.assert_array_equal(png.read_png(path), jpng.read_png(path))


def test_read_image_dispatch(tmp_path):
    """EXR and PFM are HDR, PNG is LDR; unknown extensions raise."""
    for name, write in (("a.exr", lambda p, x: jexr.write_exr(p, x)),
                        ("a.pfm", jpfm.write_pfm)):
        path = str(tmp_path / name)
        write(path, _image((3, 5, 3)))
        out, is_ldr = images.read_image(path)
        ref, ref_ldr = jimages.read_image(path)
        assert is_ldr == ref_ldr is False
        np.testing.assert_array_equal(out, ref)
    with pytest.raises(ValueError, match="unsupported"):
        images.read_image(str(tmp_path / "a.xyz"))


def test_pil_formats_raise_without_pil(tmp_path, monkeypatch):
    """JPEG and the other PIL formats need PIL; without it they raise by
    name, as in the reference."""
    import sys

    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(NotImplementedError, match="requires PIL"):
        images.read_image(str(tmp_path / "a.jpg"))
