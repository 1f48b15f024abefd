"""PIZ decompression for OpenEXR (wavelet + Huffman; port of
mitsuba_tpu/io/piz.py, host numpy).

Self-contained reimplementation of the public PIZ codec
(OpenEXR ImfPizCompressor/ImfHuf/ImfWav — format documented in
"Technical Introduction to OpenEXR"): bitmap-LUT -> Huffman decode ->
per-channel 2D integer wavelet reconstruction -> reverse LUT.
Decode only (the writer emits ZIPS); used for reading the many EXR
assets in the wild that default to PIZ.
"""

from __future__ import annotations

import struct

import numpy as np

BITMAP_SIZE = 8192  # 65536 bits
HUF_ENCBITS = 16
HUF_DECBITS = 14
HUF_ENCSIZE = (1 << HUF_ENCBITS) + 1
HUF_DECSIZE = 1 << HUF_DECBITS
HUF_DECMASK = HUF_DECSIZE - 1

SHORT_ZEROCODE_RUN = 59
LONG_ZEROCODE_RUN = 63
SHORTEST_LONG_RUN = 2 + LONG_ZEROCODE_RUN - SHORT_ZEROCODE_RUN  # 6

A_OFFSET = 1 << 15
MOD_MASK = (1 << 16) - 1


class _BitReader:
    """MSB-first bit reader over a byte buffer."""

    def __init__(self, data: bytes):
        self.bits = np.unpackbits(np.frombuffer(data, np.uint8))
        self.pos = 0

    def get(self, n):
        v = 0
        b = self.bits
        p = self.pos
        for _ in range(n):
            v = (v << 1) | int(b[p])
            p += 1
        self.pos = p
        return v


def _unpack_enc_table(br: _BitReader, im: int, iM: int):
    """Canonical code lengths (ImfHuf hufUnpackEncTable)."""
    lengths = np.zeros(HUF_ENCSIZE, np.int64)
    i = im
    while i <= iM:
        l = br.get(6)
        if l == LONG_ZEROCODE_RUN:
            zerun = br.get(8) + SHORTEST_LONG_RUN
            i += zerun
        elif l >= SHORT_ZEROCODE_RUN:
            zerun = l - SHORT_ZEROCODE_RUN + 2
            i += zerun
        else:
            lengths[i] = l
            i += 1
    return lengths


def _canonical_codes(lengths):
    """Assign canonical codes (hufCanonicalCodeTable)."""
    n = np.zeros(59, np.int64)
    for l in lengths:
        n[l] += 1
    c = 0
    codes_per_len_start = np.zeros(59, np.int64)
    for i in range(58, 0, -1):
        nc = (c + n[i]) >> 1
        codes_per_len_start[i] = c
        c = nc
    # now assign: for each symbol in increasing order, its code is the
    # running counter for its length
    counters = codes_per_len_start.copy()
    codes = np.zeros(len(lengths), np.int64)
    for sym in range(len(lengths)):
        l = lengths[sym]
        if l > 0:
            codes[sym] = counters[l]
            counters[l] += 1
    return codes


def _huf_decode(data: bytes, n_bits: int, im: int, iM: int,
                lengths, codes, out_count: int):
    """Bitstream decode with a HUF_DECBITS fast table + RLE symbol."""
    # fast table: prefix -> (symbol, length); longer codes via dict
    fast_sym = np.full(HUF_DECSIZE, -1, np.int64)
    fast_len = np.zeros(HUF_DECSIZE, np.int64)
    long_codes = {}
    for sym in range(len(lengths)):
        l = int(lengths[sym])
        if l == 0:
            continue
        c = int(codes[sym])
        if l <= HUF_DECBITS:
            start = c << (HUF_DECBITS - l)
            fast_sym[start : start + (1 << (HUF_DECBITS - l))] = sym
            fast_len[start : start + (1 << (HUF_DECBITS - l))] = l
        else:
            long_codes[(l, c)] = sym

    bits = np.unpackbits(np.frombuffer(data, np.uint8))[:n_bits]
    # pad so fast-table peeks never run off the end
    bits = np.concatenate([bits, np.zeros(64, np.uint8)])
    # precompute rolling HUF_DECBITS windows as integers
    out = np.zeros(out_count, np.uint16)
    pos = 0
    oi = 0
    weights = (1 << np.arange(HUF_DECBITS - 1, -1, -1)).astype(np.int64)
    rle_sym = iM  # run-length symbol is the max index (hufEncode)
    while oi < out_count and pos < n_bits:
        window = int(bits[pos : pos + HUF_DECBITS] @ weights)
        sym = fast_sym[window]
        if sym >= 0:
            l = int(fast_len[window])
        else:
            # long code: extend bit by bit
            l = HUF_DECBITS + 1
            c = window
            sym = -1
            while l <= 58 and pos + l <= n_bits + 64:
                c = (c << 1) | int(bits[pos + l - 1])
                hit = long_codes.get((l, c))
                if hit is not None:
                    sym = hit
                    break
                l += 1
            if sym < 0:
                raise ValueError("PIZ: corrupt Huffman stream")
        pos += l
        if sym == rle_sym:
            run = int(bits[pos : pos + 8] @ weights[-8:])
            pos += 8
            if oi == 0:
                raise ValueError("PIZ: RLE with no previous symbol")
            out[oi : oi + run] = out[oi - 1]
            oi += run
        else:
            out[oi] = sym
            oi += 1
    if oi != out_count:
        raise ValueError(f"PIZ: decoded {oi} of {out_count} symbols")
    return out


def _wdec14(l, h):
    ls = l.astype(np.int16).astype(np.int64)
    hs = h.astype(np.int16).astype(np.int64)
    ai = ls + (hs & 1) + (hs >> 1)
    a = ai.astype(np.uint16)
    b = (ai - hs).astype(np.uint16)
    return a, b


def _wdec16(l, h):
    m = l.astype(np.int64)
    d = h.astype(np.int64)
    bb = (m - (d >> 1)) & MOD_MASK
    aa = (d + bb - A_OFFSET) & MOD_MASK
    return aa.astype(np.uint16), bb.astype(np.uint16)


def _wav2_decode(buf, nx, ox, ny, oy, mx):
    """In-place 2D wavelet reconstruction (ImfWav wav2Decode)."""
    w14 = mx < (1 << 14)
    dec = _wdec14 if w14 else _wdec16
    n = min(nx, ny)
    p = 1
    while p <= n:
        p <<= 1
    p >>= 1
    p2 = p
    p >>= 1

    view = buf  # flat uint16 array; index via ox/oy strides

    while p >= 1:
        # iterate blocks of p2 with sub-offset p
        ys = np.arange(0, ny - p2 + 1, p2)
        xs = np.arange(0, nx - p2 + 1, p2)
        if len(ys) and len(xs):
            Y, X = np.meshgrid(ys, xs, indexing="ij")
            i00 = (Y * oy + X * ox).ravel()
            i01 = i00 + ox * p
            i10 = i00 + oy * p
            i11 = i10 + ox * p
            v00, v10 = dec(view[i00], view[i10])
            v01, v11 = dec(view[i01], view[i11])
            a00, a01 = dec(v00, v01)
            a10, a11 = dec(v10, v11)
            view[i00] = a00
            view[i01] = a01
            view[i10] = a10
            view[i11] = a11
        # boundary column (nx has a leftover of p)
        if nx & p:
            X = nx - p
            if len(ys):
                i00 = ys * oy + X * ox
                i10 = i00 + oy * p
                a, b = dec(view[i00], view[i10])
                view[i00] = a
                view[i10] = b
        # boundary row
        if ny & p:
            Y = ny - p
            if len(xs):
                i00 = Y * oy + xs * ox
                i01 = i00 + ox * p
                a, b = dec(view[i00], view[i01])
                view[i00] = a
                view[i01] = b
        p2 = p
        p >>= 1
    return buf


def piz_uncompress(data: bytes, channels, width: int, n_lines: int):
    """Decompress one PIZ chunk.

    channels: list of (name, pixel_type) from the EXR header (pixel
    types: 0 uint32 — unsupported here, 1 half, 2 float; PIZ stores
    everything as uint16 planes: half = 1 plane, float/uint = 2).
    Returns raw bytes in scanline-interleaved channel order (like an
    uncompressed chunk).
    """
    pos = 0
    min_nz, max_nz = struct.unpack_from("<HH", data, pos)
    pos += 4
    bitmap = np.zeros(BITMAP_SIZE, np.uint8)
    if min_nz <= max_nz:
        count = max_nz - min_nz + 1
        bitmap[min_nz : max_nz + 1] = np.frombuffer(
            data, np.uint8, count, pos
        )
        pos += count
    (n_comp,) = struct.unpack_from("<i", data, pos)
    pos += 4

    # reverse LUT: compact index -> u16 value
    bits = np.unpackbits(bitmap, bitorder="little")
    values = np.nonzero(bits)[0]
    lut = np.zeros(1 << 16, np.uint16)
    lut[: len(values)] = values.astype(np.uint16)
    max_value = max(len(values) - 1, 0)

    # channel geometry: u16 planes per channel
    planes = []  # (name, n_u16_planes)
    total_shorts = 0
    for name, pt in channels:
        n_planes = 1 if pt == 1 else 2
        planes.append((name, pt, n_planes))
        total_shorts += width * n_lines * n_planes

    # Huffman block: header im, iM, tableLength, nBits, room (5 ints)
    im, iM, _tl, n_bits, _room = struct.unpack_from(
        "<iiiii", data, pos
    )
    hdata = data[pos + 20 :]
    br = _BitReader(hdata)
    lengths = _unpack_enc_table(br, im, iM)
    codes = _canonical_codes(lengths)
    # bitstream starts at the next byte boundary after the table
    table_bytes = (br.pos + 7) // 8
    out = _huf_decode(
        hdata[table_bytes:], n_bits, im, iM, lengths, codes, total_shorts
    )

    # wavelet-decode each channel (channel-major layout); a channel with
    # S shorts per pixel is S interleaved planes with x-stride S
    # (ImfPizCompressor: wav2Decode(start + j, nx, size, ny, nx*size, mx))
    off = 0
    chan_bufs = {}
    for name, pt, n_planes in planes:
        size = width * n_lines * n_planes
        cbuf = out[off : off + size].copy()
        for j in range(n_planes):
            _wav2_decode(
                cbuf[j:], width, n_planes, n_lines,
                width * n_planes, max_value,
            )
        chan_bufs[name] = lut[cbuf]
        off += size

    # reassemble scanline-interleaved raw bytes
    parts = []
    for y in range(n_lines):
        for name, pt, n_planes in planes:
            row = chan_bufs[name][
                y * width * n_planes : (y + 1) * width * n_planes
            ]
            parts.append(row.astype("<u2").tobytes())
    return b"".join(parts)
