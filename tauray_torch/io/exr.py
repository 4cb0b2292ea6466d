# Copied from tauray_tpu/io/exr.py; only import paths differ: PIZ decoding calls the port's native library (tauray_torch/native), and the Python Huffman decoder only under TAURAY_NATIVE=0.
"""OpenEXR 2.0 scanline codec in pure Python/numpy.

The reference uses tinyexr to write frames with ZIP/ZIPS/RLE/PIZ/NONE
compression and RGB(A) 16/32-bit float formats (reference:
src/headless.hh:25-58), and its golden test images
(test/references/*.exr) are PIZ-compressed half RGB. No EXR library is
available in this environment, so this implements the subset of the
format the framework needs:

  read:  NONE, RLE, ZIPS, ZIP, PIZ — half/float/uint channels
  write: NONE, RLE, ZIPS, ZIP, PIZ — half/float channels

All codecs implement the open EXR specification (openexr.com
documentation of ZIP predictor/interleave, PIZ wavelet+Huffman).
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Tuple

import numpy as np

MAGIC = b"\x76\x2f\x31\x01"

NO_COMPRESSION = 0
RLE_COMPRESSION = 1
ZIPS_COMPRESSION = 2
ZIP_COMPRESSION = 3
PIZ_COMPRESSION = 4

COMPRESSION_NAMES = {
    "none": NO_COMPRESSION,
    "rle": RLE_COMPRESSION,
    "zips": ZIPS_COMPRESSION,
    "zip": ZIP_COMPRESSION,
    "piz": PIZ_COMPRESSION,
}

_LINES_PER_BLOCK = {
    NO_COMPRESSION: 1,
    RLE_COMPRESSION: 1,
    ZIPS_COMPRESSION: 1,
    ZIP_COMPRESSION: 16,
    PIZ_COMPRESSION: 32,
}

_PIXEL_TYPES = {0: np.uint32, 1: np.float16, 2: np.float32}
_PIXEL_TYPE_IDS = {np.dtype(np.uint32): 0, np.dtype(np.float16): 1, np.dtype(np.float32): 2}


# ---------------------------------------------------------------------------
# ZIP / RLE predictor + byte interleave (shared by ZIP, ZIPS and RLE)
# ---------------------------------------------------------------------------

def _reorder_predict_encode(data: bytes) -> bytes:
    arr = np.frombuffer(data, dtype=np.uint8)
    n = arr.size
    half = (n + 1) // 2
    tmp = np.empty(n, dtype=np.uint8)
    tmp[:half] = arr[0::2]
    tmp[half:] = arr[1::2]
    t = tmp.astype(np.int16)
    d = np.empty(n, dtype=np.int16)
    d[0] = t[0]
    d[1:] = t[1:] - t[:-1] + (128 + 256)
    return d.astype(np.uint8).tobytes()


def _reorder_predict_decode(data: bytes) -> bytes:
    arr = np.frombuffer(data, dtype=np.uint8).astype(np.int64)
    n = arr.size
    # inverse predictor: t[i] = t[i-1] + d[i] - 128 (mod 256)
    d = arr.copy()
    d[1:] -= 128
    t = np.cumsum(d) % 256
    t = t.astype(np.uint8)
    half = (n + 1) // 2
    out = np.empty(n, dtype=np.uint8)
    out[0::2] = t[:half]
    out[1::2] = t[half:]
    return out.tobytes()


# ---------------------------------------------------------------------------
# RLE
# ---------------------------------------------------------------------------

def _rle_encode(data: bytes) -> bytes:
    out = bytearray()
    n = len(data)
    i = 0
    MAX_RUN = 127
    while i < n:
        run = 1
        while i + run < n and data[i + run] == data[i] and run < MAX_RUN + 1:
            run += 1
        if run >= 3:
            out.append(run - 1)
            out.append(data[i])
            i += run
        else:
            start = i
            while i < n and (i - start) < MAX_RUN and not (
                i + 2 < n and data[i] == data[i + 1] == data[i + 2]
            ):
                i += 1
            count = i - start
            out.append((256 - count) & 0xFF)
            out.extend(data[start:i])
    return bytes(out)


def _rle_decode(data: bytes, expected: int) -> bytes:
    out = bytearray()
    i = 0
    n = len(data)
    while i < n and len(out) < expected:
        count = struct.unpack_from("b", data, i)[0]
        i += 1
        if count < 0:
            out.extend(data[i:i - count])
            i += -count
        else:
            out.extend(data[i:i + 1] * (count + 1))
            i += 1
    return bytes(out)


# ---------------------------------------------------------------------------
# PIZ: bitmap/LUT + 2D wavelet + Huffman
# ---------------------------------------------------------------------------

_US_MOD = 1 << 16
_A_OFFSET = 1 << 15
_MOD_MASK = _US_MOD - 1


def _reverse_lut_from_bitmap(bitmap: np.ndarray) -> Tuple[np.ndarray, int]:
    bits = np.unpackbits(bitmap, bitorder="little")
    bits[0] = 1  # zero is always in the table
    (values,) = np.nonzero(bits)
    lut = np.zeros(_US_MOD, dtype=np.uint16)
    lut[: values.size] = values.astype(np.uint16)
    return lut, values.size - 1


def _forward_lut_from_bitmap(bitmap: np.ndarray) -> Tuple[np.ndarray, int]:
    bits = np.unpackbits(bitmap, bitorder="little")
    bits[0] = 1
    lut = (np.cumsum(bits) - 1).astype(np.uint16)
    lut = np.where(bits.astype(bool), lut, 0).astype(np.uint16)
    max_value = int(np.cumsum(bits)[-1]) - 1
    return lut, max_value


def _wav_decode_2d(buf: np.ndarray, mx: int) -> None:
    """In-place inverse 2D wavelet transform on a (ny, nx) uint16 array."""
    ny, nx = buf.shape
    w14 = mx < (1 << 14)
    n = min(nx, ny)
    p = 1
    while p <= n:
        p <<= 1
    p >>= 1
    p2 = p
    p >>= 1
    while p >= 1:
        # Row/col index grids at stride p2, with pairs at offset p
        ys = np.arange(0, ny - p2 + 1, p2)
        xs = np.arange(0, nx - p2 + 1, p2)
        if ys.size and xs.size:
            a = buf[np.ix_(ys, xs)]
            b = buf[np.ix_(ys, xs + p)]
            c = buf[np.ix_(ys + p, xs)]
            d = buf[np.ix_(ys + p, xs + p)]
            i00, i10 = _wdec(a, c, w14)
            i01, i11 = _wdec(b, d, w14)
            r00, r01 = _wdec(i00, i01, w14)
            r10, r11 = _wdec(i10, i11, w14)
            buf[np.ix_(ys, xs)] = r00
            buf[np.ix_(ys, xs + p)] = r01
            buf[np.ix_(ys + p, xs)] = r10
            buf[np.ix_(ys + p, xs + p)] = r11
        if (nx & p) and ys.size:
            # odd remainder column: first x past the pair loop
            x = ((nx - p2) // p2 + 1) * p2
            a = buf[np.ix_(ys, [x])]
            c = buf[np.ix_(ys + p, [x])]
            r0, r1 = _wdec(a, c, w14)
            buf[np.ix_(ys, [x])] = r0
            buf[np.ix_(ys + p, [x])] = r1
        if ny & p:
            y = ((ny - p2) // p2 + 1) * p2
            xs2 = np.arange(0, nx - p2 + 1, p2)
            if xs2.size:
                a = buf[np.ix_([y], xs2)]
                b = buf[np.ix_([y], xs2 + p)]
                r0, r1 = _wdec(a, b, w14)
                buf[np.ix_([y], xs2)] = r0
                buf[np.ix_([y], xs2 + p)] = r1
        p2 = p
        p >>= 1


def _wav_encode_2d(buf: np.ndarray, mx: int) -> None:
    """In-place forward 2D wavelet transform (inverse of _wav_decode_2d)."""
    ny, nx = buf.shape
    w14 = mx < (1 << 14)
    n = min(nx, ny)
    # Forward transform iterates levels upward, mirroring decode's set.
    top = 1
    while top <= n:
        top <<= 1
    top >>= 1
    p = 1
    while p < top:
        p2 = p << 1
        ys = np.arange(0, ny - p2 + 1, p2)
        xs = np.arange(0, nx - p2 + 1, p2)
        if ys.size and xs.size:
            r00 = buf[np.ix_(ys, xs)]
            r01 = buf[np.ix_(ys, xs + p)]
            r10 = buf[np.ix_(ys + p, xs)]
            r11 = buf[np.ix_(ys + p, xs + p)]
            i00, i01 = _wenc(r00, r01, w14)
            i10, i11 = _wenc(r10, r11, w14)
            a, c = _wenc(i00, i10, w14)
            b, d = _wenc(i01, i11, w14)
            buf[np.ix_(ys, xs)] = a
            buf[np.ix_(ys, xs + p)] = b
            buf[np.ix_(ys + p, xs)] = c
            buf[np.ix_(ys + p, xs + p)] = d
        if (nx & p) and ys.size:
            x = ((nx - p2) // p2 + 1) * p2
            r0 = buf[np.ix_(ys, [x])]
            r1 = buf[np.ix_(ys + p, [x])]
            a, c = _wenc(r0, r1, w14)
            buf[np.ix_(ys, [x])] = a
            buf[np.ix_(ys + p, [x])] = c
        if ny & p:
            y = ((ny - p2) // p2 + 1) * p2
            xs2 = np.arange(0, nx - p2 + 1, p2)
            if xs2.size:
                r0 = buf[np.ix_([y], xs2)]
                r1 = buf[np.ix_([y], xs2 + p)]
                a, b = _wenc(r0, r1, w14)
                buf[np.ix_([y], xs2)] = a
                buf[np.ix_([y], xs2 + p)] = b
        p = p2


def _wdec(l: np.ndarray, h: np.ndarray, w14: bool) -> Tuple[np.ndarray, np.ndarray]:
    if w14:
        ls = l.astype(np.int16).astype(np.int32)
        hs = h.astype(np.int16).astype(np.int32)
        ai = ls + (hs & 1) + (hs >> 1)
        a = ai.astype(np.int16)
        b = (a.astype(np.int32) - hs).astype(np.int16)
        return a.astype(np.uint16), b.astype(np.uint16)
    m = l.astype(np.int64)
    d = h.astype(np.int64)
    bb = (m - (d >> 1)) & _MOD_MASK
    aa = (d + bb - _A_OFFSET) & _MOD_MASK
    return aa.astype(np.uint16), bb.astype(np.uint16)


def _wenc(a: np.ndarray, b: np.ndarray, w14: bool) -> Tuple[np.ndarray, np.ndarray]:
    if w14:
        As = a.astype(np.int16).astype(np.int32)
        Bs = b.astype(np.int16).astype(np.int32)
        ms = ((As + Bs) >> 1).astype(np.int16)
        ds = (As - Bs).astype(np.int16)
        return ms.astype(np.uint16), ds.astype(np.uint16)
    ao = (a.astype(np.int64) + _A_OFFSET) & _MOD_MASK
    bo = b.astype(np.int64)
    m = (ao + bo) >> 1
    d = ao - bo
    m = np.where(d < 0, (m + _A_OFFSET) & _MOD_MASK, m)
    d &= _MOD_MASK
    return m.astype(np.uint16), d.astype(np.uint16)


# --- Huffman coding (ImfHuf-compatible canonical codes) ---------------------

_HUF_ENCBITS = 16
_HUF_DECBITS = 14
_HUF_ENCSIZE = (1 << _HUF_ENCBITS) + 1
_HUF_DECSIZE = 1 << _HUF_DECBITS
_HUF_DECMASK = _HUF_DECSIZE - 1
_SHORT_ZEROCODE_RUN = 59
_LONG_ZEROCODE_RUN = 63
_SHORTEST_LONG_RUN = 2 + _LONG_ZEROCODE_RUN - _SHORT_ZEROCODE_RUN
_LONGEST_LONG_RUN = 255 + _SHORTEST_LONG_RUN


class _BitReader:
    __slots__ = ("data", "pos", "c", "lc")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.c = 0
        self.lc = 0

    def get_bits(self, n: int) -> int:
        while self.lc < n:
            self.c = (self.c << 8) | self.data[self.pos]
            self.pos += 1
            self.lc += 8
        self.lc -= n
        return (self.c >> self.lc) & ((1 << n) - 1)


def _huf_canonical_code_table(lengths: np.ndarray) -> np.ndarray:
    """lengths[sym] (0..58) -> packed hcode[sym] = (code << 6) | length."""
    n = np.zeros(59, dtype=np.int64)
    for l in lengths[lengths > 0]:
        n[l] += 1
    c = 0
    base = np.zeros(59, dtype=np.int64)
    for i in range(58, 0, -1):
        nc = (c + n[i]) >> 1
        base[i] = c
        c = nc
    hcode = np.zeros(lengths.size, dtype=np.int64)
    counters = base.copy()
    nz = np.nonzero(lengths)[0]
    for sym in nz:
        l = lengths[sym]
        hcode[sym] = (counters[l] << 6) | l
        counters[l] += 1
    return hcode


def _huf_unpack_enc_table(data: bytes, im: int, iM: int) -> Tuple[np.ndarray, int]:
    """Returns (hcode packed table, bytes consumed)."""
    br = _BitReader(data)
    lengths = np.zeros(_HUF_ENCSIZE, dtype=np.int64)
    i = im
    while i <= iM:
        l = br.get_bits(6)
        if l == _LONG_ZEROCODE_RUN:
            zerun = br.get_bits(8) + _SHORTEST_LONG_RUN
            i += zerun
        elif l >= _SHORT_ZEROCODE_RUN:
            i += l - _SHORT_ZEROCODE_RUN + 2
        else:
            lengths[i] = l
            i += 1
    consumed = br.pos
    return _huf_canonical_code_table(lengths), consumed


def _huf_pack_enc_table(hcode: np.ndarray, im: int, iM: int) -> bytes:
    out = bytearray()
    c = 0
    lc = 0

    def put(bits, n):
        nonlocal c, lc
        c = (c << n) | bits
        lc += n
        while lc >= 8:
            lc -= 8
            out.append((c >> lc) & 0xFF)

    i = im
    while i <= iM:
        l = int(hcode[i]) & 63
        if l == 0:
            zerun = 1
            while i + zerun <= iM and zerun < _LONGEST_LONG_RUN:
                if (int(hcode[i + zerun]) & 63) != 0:
                    break
                zerun += 1
            if zerun >= 2:
                if zerun >= _SHORTEST_LONG_RUN:
                    put(_LONG_ZEROCODE_RUN, 6)
                    put(zerun - _SHORTEST_LONG_RUN, 8)
                else:
                    put(_SHORT_ZEROCODE_RUN + zerun - 2, 6)
                i += zerun
                continue
        put(l, 6)
        i += 1
    if lc > 0:
        out.append((c << (8 - lc)) & 0xFF)
    return bytes(out)


def _huf_build_dec_table(hcode: np.ndarray, im: int, iM: int):
    """14-bit prefix table: entry = (length, literal) or long-code list."""
    short_len = np.zeros(_HUF_DECSIZE, dtype=np.int32)
    short_lit = np.zeros(_HUF_DECSIZE, dtype=np.int64)
    longs: Dict[int, List[int]] = {}
    for sym in range(im, iM + 1):
        packed = int(hcode[sym])
        l = packed & 63
        if l == 0:
            continue
        code = packed >> 6
        if l <= _HUF_DECBITS:
            idx = code << (_HUF_DECBITS - l)
            cnt = 1 << (_HUF_DECBITS - l)
            short_len[idx:idx + cnt] = l
            short_lit[idx:idx + cnt] = sym
        else:
            idx = code >> (l - _HUF_DECBITS)
            longs.setdefault(idx, []).append(sym)
    # try shorter codes first when several long codes share a 14-bit prefix
    for lst in longs.values():
        lst.sort(key=lambda s: int(hcode[s]) & 63)
    return short_len, short_lit, longs


def _huf_decode(data: bytes, nbits: int, hcode: np.ndarray, dec, rlc: int,
                n_out: int) -> np.ndarray:
    short_len, short_lit, longs = dec
    out = np.zeros(n_out, dtype=np.uint16)
    oi = 0
    c = 0
    lc = 0
    pos = 0
    nbytes = (nbits + 7) // 8
    while pos < nbytes:
        c = ((c << 8) | data[pos]) & 0xFFFFFFFFFFFFFFFF
        pos += 1
        lc += 8
        while lc >= _HUF_DECBITS:
            idx = (c >> (lc - _HUF_DECBITS)) & _HUF_DECMASK
            l = int(short_len[idx])
            if l:
                lit = int(short_lit[idx])
                lc -= l
            else:
                # long code
                lit = None
                for sym in longs.get(idx, ()):
                    packed = int(hcode[sym])
                    sl = packed & 63
                    while lc < sl and pos < nbytes:
                        c = ((c << 8) | data[pos]) & 0xFFFFFFFFFFFFFFFF
                        pos += 1
                        lc += 8
                    if lc >= sl and (c >> (lc - sl)) & ((1 << sl) - 1) == packed >> 6:
                        lit = sym
                        lc -= sl
                        break
                if lit is None:
                    raise ValueError("EXR: invalid Huffman code")
            if lit == rlc:
                while lc < 8:
                    c = ((c << 8) | data[pos]) & 0xFFFFFFFFFFFFFFFF
                    pos += 1
                    lc += 8
                lc -= 8
                cs = (c >> lc) & 0xFF
                out[oi:oi + cs] = out[oi - 1]
                oi += cs
            else:
                out[oi] = lit
                oi += 1
    # flush remaining bits
    i = (8 - nbits) & 7
    c >>= i
    lc -= i
    while lc > 0:
        idx = (c << (_HUF_DECBITS - lc)) & _HUF_DECMASK if lc < _HUF_DECBITS \
            else (c >> (lc - _HUF_DECBITS)) & _HUF_DECMASK
        l = int(short_len[idx])
        if l and l <= lc:
            lit = int(short_lit[idx])
            lc -= l
            if lit == rlc:
                if lc < 8:
                    raise ValueError("EXR: truncated RLE run at end of stream")
                lc -= 8
                cs = (c >> lc) & 0xFF
                out[oi:oi + cs] = out[oi - 1]
                oi += cs
            else:
                out[oi] = lit
                oi += 1
        else:
            break
    if oi != n_out:
        raise ValueError(f"EXR: Huffman output size mismatch ({oi} != {n_out})")
    return out


def _huf_encode(data: np.ndarray) -> bytes:
    """ImfHuf-compatible compress of a uint16 array."""
    freq = np.bincount(data.astype(np.int64), minlength=_HUF_ENCSIZE).astype(np.int64)
    # RLE pre-pass folds runs into the frequency of the run-length code symbol.
    # We keep it simple: no RLE symbol usage on encode except reserving it.
    freq[_HUF_ENCSIZE - 1] = 1  # pseudo-symbol used as the RLE code
    # Build code lengths with a simple package-style constrained Huffman:
    syms = np.nonzero(freq)[0]
    import heapq
    heap = [(int(freq[s]), int(s), (int(s),)) for s in syms]
    heapq.heapify(heap)
    lengths = np.zeros(_HUF_ENCSIZE, dtype=np.int64)
    if len(heap) == 1:
        lengths[heap[0][1]] = 1
    else:
        while len(heap) > 1:
            f1, _, s1 = heapq.heappop(heap)
            f2, _, s2 = heapq.heappop(heap)
            for s in s1 + s2:
                lengths[s] += 1
            merged = s1 + s2
            heapq.heappush(heap, (f1 + f2, min(s1 + s2), merged))
        # limit code length to 58 (spec max); extremely unlikely to trigger
        lengths = np.minimum(lengths, 58)
    hcode = _huf_canonical_code_table(lengths)
    im = int(syms.min())
    iM = int(syms.max()) if syms.size else 0
    iM = max(iM, _HUF_ENCSIZE - 1)
    table = _huf_pack_enc_table(hcode, im, iM)
    rlc = _HUF_ENCSIZE - 1

    # bit-pack symbols with RLE runs
    out = bytearray()
    c = 0
    lc = 0

    def put(code_packed):
        nonlocal c, lc
        l = code_packed & 63
        code = code_packed >> 6
        c = (c << l) | code
        lc += l
        while lc >= 8:
            lc -= 8
            out.append((c >> lc) & 0xFF)

    n = data.size
    i = 0
    vals = data.astype(np.int64)
    # find run boundaries vectorized
    while i < n:
        v = vals[i]
        run = 1
        # short scalar scan capped at 255
        maxrun = min(255 + 1, n - i)
        while run < maxrun and vals[i + run] == v:
            run += 1
        put(int(hcode[v]))
        rem = run - 1
        while rem > 0:
            chunk = min(rem, 255)
            # cost check like ImfHuf: only use rlc if beneficial
            if chunk * (int(hcode[v]) & 63) > (int(hcode[rlc]) & 63) + 8:
                put(int(hcode[rlc]))
                c = (c << 8) | chunk
                lc += 8
                while lc >= 8:
                    lc -= 8
                    out.append((c >> lc) & 0xFF)
            else:
                for _ in range(chunk):
                    put(int(hcode[v]))
            rem -= chunk
        i += run
    nbits = len(out) * 8 + lc
    if lc > 0:
        out.append((c << (8 - lc)) & 0xFF)
    header = struct.pack("<IIIII", im, iM, len(table), nbits, 0)
    return header + table + bytes(out)


def _piz_uncompress(data: bytes, nx: int, ny: int, channels) -> bytes:
    """channels: list of (name, dtype). Returns scanline-interleaved bytes."""
    off = 0
    min_nz, max_nz = struct.unpack_from("<HH", data, off)
    off += 4
    bitmap = np.zeros(8192, dtype=np.uint8)
    if min_nz <= max_nz:
        cnt = max_nz - min_nz + 1
        bitmap[min_nz:max_nz + 1] = np.frombuffer(data, dtype=np.uint8,
                                                  count=cnt, offset=off)
        off += cnt
    lut, max_value = _reverse_lut_from_bitmap(bitmap)
    (length,) = struct.unpack_from("<i", data, off)
    off += 4
    huf_data = data[off:off + length]

    # channel sizes in uint16 units
    ch_words = []
    total = 0
    for name, dt in channels:
        words_per_pixel = np.dtype(dt).itemsize // 2
        ch_words.append(words_per_pixel)
        total += nx * ny * words_per_pixel

    him, hiM, tlen, nbits, _ = struct.unpack_from("<IIIII", huf_data, 0)
    hcode, consumed = _huf_unpack_enc_table(huf_data[20:20 + tlen], him, hiM)
    from ..native import huf_decode as _native_huf
    decoded = _native_huf(huf_data[20 + tlen:], nbits, hcode, hiM, total)
    if decoded is None:
        dec = _huf_build_dec_table(hcode, him, hiM)
        decoded = _huf_decode(huf_data[20 + tlen:], nbits, hcode, dec,
                              hiM, total)

    # per-channel planes: wavelet decode + LUT
    planes = []
    pos = 0
    for (name, dt), wpp in zip(channels, ch_words):
        # each 16-bit slice of the channel is a separate (ny, nx*wpp)? No:
        # PIZ treats a channel of size (ny, nx * wpp) uint16s with nx' = nx*wpp
        cnx = nx * wpp
        plane = decoded[pos:pos + cnx * ny].reshape(ny, cnx).copy()
        pos += cnx * ny
        _wav_decode_2d(plane, max_value)
        plane = lut[plane]
        planes.append(plane)

    # interleave to scanline order
    out = bytearray()
    for y in range(ny):
        for plane in planes:
            out.extend(plane[y].tobytes())
    return bytes(out)


def _piz_compress(raw: bytes, nx: int, ny: int, channels) -> bytes:
    # de-interleave scanlines to channel planes
    planes = []
    arr = np.frombuffer(raw, dtype=np.uint16)
    ch_words = [np.dtype(dt).itemsize // 2 for _, dt in channels]
    row_words = nx * sum(ch_words)
    rows = arr.reshape(ny, row_words)
    offs = np.cumsum([0] + [nx * w for w in ch_words])
    for i, wpp in enumerate(ch_words):
        planes.append(rows[:, offs[i]:offs[i + 1]].copy())

    # bitmap of used values
    used = np.zeros(_US_MOD, dtype=bool)
    for p in planes:
        used[p.reshape(-1)] = True
    used[0] = False  # zero never stored in bitmap
    bitmap = np.packbits(used, bitorder="little")
    nz = np.nonzero(bitmap)[0]
    if nz.size:
        min_nz, max_nz = int(nz[0]), int(nz[-1])
    else:
        min_nz, max_nz = 8191, 0  # matches OpenEXR "empty" convention

    lut, max_value = _forward_lut_from_bitmap(bitmap)
    pieces = []
    for p in planes:
        q = lut[p].astype(np.uint16)
        _wav_encode_2d(q, max_value)
        pieces.append(q.reshape(-1))
    allw = np.concatenate(pieces)
    huf = _huf_encode(allw)

    out = bytearray()
    out += struct.pack("<HH", min_nz, max_nz)
    if min_nz <= max_nz:
        out += bitmap[min_nz:max_nz + 1].tobytes()
    out += struct.pack("<i", len(huf))
    out += huf
    return bytes(out)


# ---------------------------------------------------------------------------
# Header parse / write
# ---------------------------------------------------------------------------

def _read_attrs(data: bytes, off: int):
    attrs = {}
    while data[off] != 0:
        e = data.index(b"\0", off)
        name = data[off:e].decode()
        off = e + 1
        e = data.index(b"\0", off)
        typ = data[off:e].decode()
        off = e + 1
        (size,) = struct.unpack_from("<I", data, off)
        off += 4
        attrs[name] = (typ, data[off:off + size])
        off += size
    return attrs, off + 1


def read(path: str) -> Dict[str, np.ndarray]:
    """Read a scanline EXR; returns dict of channel name -> (H, W) array."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    (version,) = struct.unpack_from("<I", data, 4)
    if version & 0x200:
        raise ValueError("tiled EXR not supported")
    attrs, off = _read_attrs(data, 8)

    # channels
    chl = attrs["channels"][1]
    channels = []
    o = 0
    while chl[o] != 0:
        e = chl.index(b"\0", o)
        cname = chl[o:e].decode()
        o = e + 1
        (ptype,) = struct.unpack_from("<i", chl, o)
        o += 16
        channels.append((cname, _PIXEL_TYPES[ptype]))
    x0, y0, x1, y1 = struct.unpack("<4i", attrs["dataWindow"][1])
    width = x1 - x0 + 1
    height = y1 - y0 + 1
    compression = attrs["compression"][1][0]
    lpb = _LINES_PER_BLOCK[compression]
    nblocks = (height + lpb - 1) // lpb

    # offset table
    offsets = struct.unpack_from(f"<{nblocks}Q", data, off)

    out = {name: np.zeros((height, width), dtype=dt) for name, dt in channels}
    bytes_pp = {name: np.dtype(dt).itemsize for name, dt in channels}
    for block_off in offsets:
        y, packed = struct.unpack_from("<ii", data, block_off)
        payload = data[block_off + 8:block_off + 8 + packed]
        ystart = y - y0
        ny = min(lpb, height - ystart)
        raw_size = sum(width * ny * bytes_pp[n] for n, _ in channels)
        if compression == NO_COMPRESSION or packed >= raw_size:
            raw = payload
        elif compression in (ZIP_COMPRESSION, ZIPS_COMPRESSION):
            raw = _reorder_predict_decode(zlib.decompress(payload))
        elif compression == RLE_COMPRESSION:
            raw = _reorder_predict_decode(_rle_decode(payload, raw_size))
        elif compression == PIZ_COMPRESSION:
            raw = _piz_uncompress(payload, width, ny, channels)
        else:
            raise ValueError(f"unsupported EXR compression {compression}")
        # scanline-interleaved: per line, per channel
        pos = 0
        for line in range(ny):
            for cname, dt in channels:
                n = width * np.dtype(dt).itemsize
                out[cname][ystart + line] = np.frombuffer(raw, dtype=dt,
                                                          count=width, offset=pos)
                pos += n
    return out


def read_rgb(path: str) -> np.ndarray:
    """Read an EXR as a (H, W, C) float32 array in RGB(A) channel order."""
    chans = read(path)
    order = [c for c in ("R", "G", "B", "A") if c in chans]
    if not order:
        order = sorted(chans.keys())
    return np.stack([chans[c].astype(np.float32) for c in order], axis=-1)


def _attr(name: str, typ: str, value: bytes) -> bytes:
    return name.encode() + b"\0" + typ.encode() + b"\0" + struct.pack("<I", len(value)) + value


def write(path: str, channels: Dict[str, np.ndarray], compression: str = "piz") -> None:
    """Write a scanline EXR. channels: name -> (H, W) array (f16/f32/u32)."""
    comp = COMPRESSION_NAMES[compression]
    names = sorted(channels.keys())  # EXR requires alphabetical channel order
    arrays = [np.ascontiguousarray(channels[n]) for n in names]
    height, width = arrays[0].shape
    for a in arrays:
        if a.shape != (height, width):
            raise ValueError("channel shape mismatch")
        if a.dtype not in _PIXEL_TYPE_IDS:
            raise ValueError(f"unsupported dtype {a.dtype}")

    chl = b""
    for n, a in zip(names, arrays):
        chl += n.encode() + b"\0" + struct.pack("<iiii", _PIXEL_TYPE_IDS[a.dtype], 0, 1, 1)
    chl += b"\0"

    dw = struct.pack("<4i", 0, 0, width - 1, height - 1)
    header = MAGIC + struct.pack("<I", 2)
    header += _attr("channels", "chlist", chl)
    header += _attr("compression", "compression", bytes([comp]))
    header += _attr("dataWindow", "box2i", dw)
    header += _attr("displayWindow", "box2i", dw)
    header += _attr("lineOrder", "lineOrder", b"\0")
    header += _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += _attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0))
    header += _attr("screenWindowWidth", "float", struct.pack("<f", float(width)))
    header += b"\0"

    lpb = _LINES_PER_BLOCK[comp]
    nblocks = (height + lpb - 1) // lpb
    blocks = []
    ch_dts = [(n, a.dtype) for n, a in zip(names, arrays)]
    for b in range(nblocks):
        ystart = b * lpb
        ny = min(lpb, height - ystart)
        raw = bytearray()
        for line in range(ystart, ystart + ny):
            for a in arrays:
                raw.extend(a[line].tobytes())
        raw = bytes(raw)
        if comp == NO_COMPRESSION:
            packed = raw
        elif comp in (ZIP_COMPRESSION, ZIPS_COMPRESSION):
            packed = zlib.compress(_reorder_predict_encode(raw), 6)
        elif comp == RLE_COMPRESSION:
            packed = _rle_encode(_reorder_predict_encode(raw))
        elif comp == PIZ_COMPRESSION:
            packed = _piz_compress(raw, width, ny, ch_dts)
        if len(packed) >= len(raw):
            packed = raw
        blocks.append((ystart, packed))

    table_off = len(header)
    data_off = table_off + 8 * nblocks
    offsets = []
    pos = data_off
    for ystart, packed in blocks:
        offsets.append(pos)
        pos += 8 + len(packed)
    with open(path, "wb") as f:
        f.write(header)
        f.write(struct.pack(f"<{nblocks}Q", *offsets))
        for ystart, packed in blocks:
            f.write(struct.pack("<ii", ystart, len(packed)))
            f.write(packed)


def write_rgb(path: str, img: np.ndarray, compression: str = "piz",
              half: bool = True) -> None:
    """Write (H, W, 3|4) image as EXR with B,G,R(,A) channels like tinyexr."""
    img = np.asarray(img)
    dt = np.float16 if half else np.float32
    names = ["R", "G", "B", "A"][: img.shape[-1]]
    chans = {n: img[..., i].astype(dt) for i, n in enumerate(names)}
    write(path, chans, compression)
