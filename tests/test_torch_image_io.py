"""The port's image writers and PIZ decoder (mitsuba_tpu_torch/io) against
the JAX package's.  Each writer's file is byte for byte the reference's
for the same image (.exr ZIPS and raw, .pfm, .png, .hdr, .npy, .m), and
each package reads the other's files to equal arrays.  The PIZ decoder's
parts (the Huffman table and decode, the wavelet, the LUT) and a whole
PIZ chunk and EXR file are built here by a small encoder of the format
the reference decodes, and the two decoders must agree exactly."""

import heapq
import struct

import numpy as np
import pytest

from mitsuba_tpu.io import exr as jexr
from mitsuba_tpu.io import images as jimages
from mitsuba_tpu.io import piz as jpiz
from mitsuba_tpu_torch.io import exr, images, piz


def _image(shape, seed=0, lo=0.0, hi=4.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _hdr_image(shape, seed=0):
    """Values over six decades, zeros and a run, as renders hold them."""
    img = np.exp(np.random.default_rng(seed).uniform(-9.0, 5.0, shape)).astype(np.float32)
    img[0, :3] = 0.0
    return img


FORMATS = [(".exr", 3), (".exr", 1), (".exr", 4), (".pfm", 3), (".pfm", 1), (".png", 3),
           (".png", 4), (".hdr", 3), (".rgbe", 3), (".npy", 3), (".m", 3), (".m", 1)]


@pytest.mark.parametrize("ext,channels", FORMATS, ids=[f"{e[1:]}{c}" for e, c in FORMATS])
def test_writers_byte_equal(tmp_path, ext, channels):
    img = _hdr_image((19, 23, channels), seed=channels)
    if ext == ".png":
        img = np.clip(img / 8.0, 0.0, 1.0)
    if channels == 1 and ext != ".m":
        img = img[..., 0] if ext != ".exr" else img
    ours, ref = str(tmp_path / f"port{ext}"), str(tmp_path / f"ref{ext}")
    images.write_image(ours, img)
    jimages.write_image(ref, img)
    assert open(ours, "rb").read() == open(ref, "rb").read()


@pytest.mark.parametrize("ext", [".exr", ".pfm", ".png", ".hdr"])
def test_each_reads_the_others_files(tmp_path, ext):
    img = _hdr_image((17, 29, 3), seed=5)
    if ext == ".png":
        img = np.clip(img / 8.0, 0.0, 1.0)
    ours, ref = str(tmp_path / f"port{ext}"), str(tmp_path / f"ref{ext}")
    images.write_image(ours, img)
    jimages.write_image(ref, img)
    a, a_ldr = jimages.read_image(ours)  # the reference reads the port's file
    b, b_ldr = images.read_image(ref)  # the port reads the reference's
    assert a_ldr == b_ldr == (ext == ".png")
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, images.read_image(ours)[0])


@pytest.mark.parametrize("half", [True, False], ids=["half", "float"])
@pytest.mark.parametrize("compression", ["none", "zips"])
def test_write_exr_options(tmp_path, half, compression):
    img = _hdr_image((11, 7, 4), seed=2)
    ours, ref = str(tmp_path / "p.exr"), str(tmp_path / "r.exr")
    exr.write_exr(ours, img, half=half, compression=compression)
    jexr.write_exr(ref, img, half=half, compression=compression)
    assert open(ours, "rb").read() == open(ref, "rb").read()
    back, names = exr.read_exr(ours)
    assert names == ["R", "G", "B", "A"]
    np.testing.assert_array_equal(back, img.astype(np.float16) if half else img)


def test_zip_compress_equal():
    raw = _hdr_image((3, 64, 3), seed=9).astype(np.float16).tobytes()
    assert exr._zip_compress(raw) == jexr._zip_compress(raw)
    assert exr._zip_decompress(exr._zip_compress(raw), len(raw)) == raw


def test_pil_writers_raise_import_error_without_pil(tmp_path, monkeypatch):
    """The PIL formats need PIL to write: without it ImportError, as the
    reference's writer raises."""
    import sys

    monkeypatch.setitem(sys.modules, "PIL", None)
    for ext in (".jpg", ".tga", ".bmp", ".webp"):
        with pytest.raises(ImportError):
            images.write_image(str(tmp_path / f"a{ext}"), _image((4, 4, 3), hi=1.0))
        with pytest.raises(ImportError):
            jimages.write_image(str(tmp_path / f"a{ext}"), _image((4, 4, 3), hi=1.0))
    with pytest.raises(ValueError, match="unsupported"):
        images.write_image(str(tmp_path / "a.xyz"), _image((4, 4, 3)))


# ---- PIZ: an encoder of the format the reference's decoder reads ----

def _wenc14(a, b):
    a_ = a.astype(np.int16).astype(np.int64)
    b_ = b.astype(np.int16).astype(np.int64)
    return ((a_ + b_) >> 1).astype(np.uint16), (a_ - b_).astype(np.uint16)


def _wav2_encode(buf, nx, ox, ny, oy):
    """The inverse of wav2Decode for 14-bit values (tests/test_io.py's)."""
    n = min(nx, ny)
    p, p2 = 1, 2
    while p2 <= n:
        ys = np.arange(0, ny - p2 + 1, p2)
        xs = np.arange(0, nx - p2 + 1, p2)
        if len(ys) and len(xs):
            Y, X = np.meshgrid(ys, xs, indexing="ij")
            i00 = (Y * oy + X * ox).ravel()
            i01, i10 = i00 + ox * p, i00 + oy * p
            i11 = i10 + ox * p
            v00, v01 = _wenc14(buf[i00], buf[i01])
            v10, v11 = _wenc14(buf[i10], buf[i11])
            buf[i00], buf[i10] = _wenc14(v00, v10)
            buf[i01], buf[i11] = _wenc14(v01, v11)
        if nx & p and len(ys):
            i00 = ys * oy + (nx - p) * ox
            buf[i00], buf[i00 + oy * p] = _wenc14(buf[i00], buf[i00 + oy * p])
        if ny & p and len(xs):
            i00 = (ny - p) * oy + xs * ox
            buf[i00], buf[i00 + ox * p] = _wenc14(buf[i00], buf[i00 + ox * p])
        p, p2 = p2, p2 * 2
    return buf


def _huffman_lengths(freq):
    """Code lengths of a Huffman code over the symbols with freq > 0."""
    heap = [(f, i, (s,)) for i, (s, f) in enumerate(freq.items())]
    heapq.heapify(heap)
    depth = dict.fromkeys(freq, 0)
    if len(heap) == 1:
        return {next(iter(freq)): 1}
    tie = len(heap)
    while len(heap) > 1:
        fa, _, a = heapq.heappop(heap)
        fb, _, b = heapq.heappop(heap)
        for s in a + b:
            depth[s] += 1
        heapq.heappush(heap, (fa + fb, tie, a + b))
        tie += 1
    return depth


class _Bits:
    def __init__(self):
        self.bits = []

    def put(self, value, n):
        self.bits += [(value >> (n - 1 - k)) & 1 for k in range(n)]

    def tobytes(self):
        pad = (-len(self.bits)) % 8
        return np.packbits(np.asarray(self.bits + [0] * pad, np.uint8)).tobytes()


def _huf_encode(symbols, run_min=4):
    """(the Huffman block the reference decodes, lengths, codes): im, iM
    (the run-length symbol, one past the largest value), the packed code
    length table, then the codes, runs of `run_min` or more as the run
    symbol and an 8-bit count."""
    im, rle = int(symbols.min()), int(symbols.max()) + 1
    stream, i = [], 0
    while i < len(symbols):
        j = i + 1
        while j < len(symbols) and symbols[j] == symbols[i] and j - i < 255:
            j += 1
        stream.append(int(symbols[i]))
        if j - i - 1 >= run_min:
            stream += [rle, ("run", j - i - 1)]
        else:
            stream += [int(symbols[i])] * (j - i - 1)
        i = j
    freq = {}
    for s in stream:
        if not isinstance(s, tuple):
            freq[s] = freq.get(s, 0) + 1
    freq.setdefault(rle, 1)
    lengths = np.zeros(jpiz.HUF_ENCSIZE, np.int64)
    for s, n in _huffman_lengths(freq).items():
        lengths[s] = n
    codes = jpiz._canonical_codes(lengths)
    table = _Bits()
    k = im
    while k <= rle:
        if lengths[k]:
            table.put(int(lengths[k]), 6)
            k += 1
            continue
        run = 0
        while k + run <= rle and lengths[k + run] == 0 and run < 255 + jpiz.SHORTEST_LONG_RUN:
            run += 1
        if run >= jpiz.SHORTEST_LONG_RUN:
            table.put(jpiz.LONG_ZEROCODE_RUN, 6)
            table.put(run - jpiz.SHORTEST_LONG_RUN, 8)
        elif run >= 2:
            table.put(jpiz.SHORT_ZEROCODE_RUN + run - 2, 6)
        else:
            table.put(0, 6)
            run = 1
        k += run
    body = _Bits()
    for s in stream:
        if isinstance(s, tuple):
            body.put(s[1], 8)
        else:
            body.put(int(codes[s]), int(lengths[s]))
    data = table.tobytes() + body.tobytes()
    head = struct.pack("<iiiii", im, rle, len(table.tobytes()), len(body.bits), 0)
    return head + data, lengths, codes


def _piz_chunk(planes_u16, width, n_lines, pts):
    """A PIZ chunk of channels of pixel types `pts` whose raw u16 lines are
    `planes_u16[c]` ([n_lines, width * n_planes])."""
    values = np.unique(np.concatenate([p.ravel() for p in planes_u16]))
    bitmap = np.zeros(jpiz.BITMAP_SIZE * 8, np.uint8)
    bitmap[values] = 1
    bitmap = np.packbits(bitmap, bitorder="little")
    nz = np.nonzero(bitmap)[0]
    fwd = np.zeros(1 << 16, np.uint16)
    fwd[values] = np.arange(len(values), dtype=np.uint16)
    buf = []
    for p, pt in zip(planes_u16, pts):
        n_planes = 1 if pt == 1 else 2
        cb = fwd[p.ravel()].copy()
        for j in range(n_planes):
            view = cb[j:]
            _wav2_encode(view, width, n_planes, n_lines, width * n_planes)
        buf.append(cb)
    huf, _, _ = _huf_encode(np.concatenate(buf))
    out = struct.pack("<HH", int(nz.min()), int(nz.max())) + bitmap[nz.min():nz.max() + 1].tobytes()
    return out + struct.pack("<i", len(huf)) + huf


def test_canonical_codes_and_table_equal():
    rng = np.random.default_rng(3)
    symbols = np.minimum(rng.geometric(0.02, 5000), 900).astype(np.int64) + 40
    block, lengths, codes = _huf_encode(symbols)
    np.testing.assert_array_equal(piz._canonical_codes(lengths), jpiz._canonical_codes(lengths))
    im, im_max = struct.unpack_from("<ii", block, 0)
    ours, ref = piz._BitReader(block[20:]), jpiz._BitReader(block[20:])
    np.testing.assert_array_equal(piz._unpack_enc_table(ours, im, im_max),
                                  jpiz._unpack_enc_table(ref, im, im_max))
    np.testing.assert_array_equal(piz._unpack_enc_table(piz._BitReader(block[20:]), im, im_max),
                                  lengths[:jpiz.HUF_ENCSIZE])
    assert ours.pos == ref.pos


@pytest.mark.parametrize("seed,skew", [(0, 0.3), (1, 0.02), (2, None)])
def test_huf_decode_equal(seed, skew):
    """Short codes through the fast table, codes past 14 bits (Fibonacci
    counts: lengths up to 19) through the long-code path, and runs."""
    rng = np.random.default_rng(seed)
    if skew is None:
        fib = [1, 1]
        while len(fib) < 20:
            fib.append(fib[-1] + fib[-2])
        symbols = rng.permutation(np.repeat(np.arange(20) * 37 + 5, fib)).astype(np.int64)
    else:
        symbols = np.minimum(rng.geometric(skew, 4000), 20000).astype(np.int64)
    symbols[100:160] = symbols[99]  # a run
    # no runs in the Fibonacci case: they would flatten its counts
    block, lengths, codes = _huf_encode(symbols, run_min=4 if skew else len(symbols))
    im, im_max, tlen, n_bits, _ = struct.unpack_from("<iiiii", block, 0)
    data = block[20 + tlen:]
    if skew is None:
        assert lengths.max() > piz.HUF_DECBITS
    ours = piz._huf_decode(data, n_bits, im, im_max, lengths, codes, len(symbols))
    ref = jpiz._huf_decode(data, n_bits, im, im_max, lengths, codes, len(symbols))
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours, symbols.astype(np.uint16))


@pytest.mark.parametrize("nx,ny", [(8, 8), (13, 7), (32, 5), (1, 9), (37, 32)])
def test_wavelet_decode_equal(nx, ny):
    rng = np.random.default_rng(nx * ny)
    enc = rng.integers(0, 1 << 16, nx * ny).astype(np.uint16)
    for mx in ((1 << 13) - 1, (1 << 16) - 1):  # the 14-bit and 16-bit forms
        a = piz._wav2_decode(enc.copy(), nx, 1, ny, nx, mx)
        b = jpiz._wav2_decode(enc.copy(), nx, 1, ny, nx, mx)
        np.testing.assert_array_equal(a, b)
    lo = rng.integers(0, 1 << 16, 1000).astype(np.uint16)
    hi = rng.integers(0, 1 << 16, 1000).astype(np.uint16)
    for ours, ref in ((piz._wdec14, jpiz._wdec14), (piz._wdec16, jpiz._wdec16)):
        for x, y in zip(ours(lo, hi), ref(lo, hi)):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("pts", [(1, 1, 1), (2, 1), (1,)], ids=["half3", "float_half", "half1"])
def test_piz_chunk_equal(pts):
    width, n_lines = 21, 32
    planes = []
    for c, pt in enumerate(pts):
        vals = _hdr_image((n_lines, width), seed=10 + c) / 16.0
        p = (vals.astype(np.float16) if pt == 1 else vals).view(np.uint16).reshape(n_lines, -1)
        planes.append(p)
    chunk = _piz_chunk(planes, width, n_lines, pts)
    channels = [(f"C{c}", pt) for c, pt in enumerate(pts)]
    ours = piz.piz_uncompress(chunk, channels, width, n_lines)
    ref = jpiz.piz_uncompress(chunk, channels, width, n_lines)
    assert ours == ref
    expect = b"".join(planes[c][y].astype("<u2").tobytes()
                      for y in range(n_lines) for c in range(len(pts)))
    assert ours == expect


def test_piz_exr_file_equal(tmp_path):
    """A whole scanline EXR with PIZ compression (32 lines a chunk, the
    last chunk short), read by both packages to the image it holds."""
    h, w = 45, 19
    img = _hdr_image((h, w, 3), seed=4).astype(np.float16)
    path = str(tmp_path / "piz.exr")
    with open(path, "wb") as f:
        f.write(struct.pack("<ii", jexr._MAGIC, 2))
        chan = b"".join(n.encode() + b"\x00" + struct.pack("<iBBBBii", 1, 0, 0, 0, 0, 1, 1)
                        for n in "BGR") + b"\x00"
        jexr._write_attr(f, b"channels", b"chlist", chan)
        jexr._write_attr(f, b"compression", b"compression", bytes([4]))
        box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
        jexr._write_attr(f, b"dataWindow", b"box2i", box)
        jexr._write_attr(f, b"displayWindow", b"box2i", box)
        jexr._write_attr(f, b"lineOrder", b"lineOrder", b"\x00")
        f.write(b"\x00")
        table = f.tell()
        f.write(b"\x00" * 8 * 2)
        offsets = []
        for y0 in (0, 32):
            rows = img[y0:y0 + 32]
            planes = [rows[..., c].view(np.uint16) for c in (2, 1, 0)]  # B, G, R
            chunk = _piz_chunk(planes, w, len(rows), (1, 1, 1))
            assert len(chunk) != rows.nbytes
            offsets.append(f.tell())
            f.write(struct.pack("<ii", y0, len(chunk)))
            f.write(chunk)
        f.seek(table)
        f.write(struct.pack("<2Q", *offsets))
    ours, names = exr.read_exr(path)
    ref, ref_names = jexr.read_exr(path)
    assert names == ref_names == ["R", "G", "B"]
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours, img.astype(np.float32))
