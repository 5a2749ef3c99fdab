"""A numpy OpenEXR codec for single-part scanline images (a copy of the
JAX package's sdirt_tpu/io/exr.py, which imports no framework).

The FlyingThings3D and Middlebury focal-stack sets store disparity as
``disp.exr``. The JAX loaders read it with ``cv2.imread(path,
IMREAD_ANYCOLOR | IMREAD_ANYDEPTH)`` where OpenCV has the codec and fall
back to this reader; the port reads it here only. It implements the subset
that disparity and depth EXRs use:

  * single-part scanline files (EXR version 2, not tiled, deep or
    multipart);
  * pixel types HALF, FLOAT and UINT;
  * compression NONE, ZIPS (1 line per chunk), ZIP (16 lines per chunk)
    and PIZ (32 lines per chunk; decode only), which mainstream writers
    emit; RLE, B44, DWA and PXR24 raise an error naming the file.

Channels named R/G/B come back in cv2's B, G, R order.

Layout reference: the OpenEXR file-format specification (openexr.com,
"Technical Introduction to OpenEXR"; ImfZip.cpp byte reorder and predictor;
ImfHuf.cpp canonical Huffman; ImfWav.cpp 2D wavelet; ImfPizCompressor.cpp
bitmap, LUT and channel layout).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

MAGIC = 20000630
_PIXEL_DTYPES = {0: np.dtype("<u4"), 1: np.dtype("<f2"), 2: np.dtype("<f4")}
_COMP_NONE, _COMP_RLE, _COMP_ZIPS, _COMP_ZIP, _COMP_PIZ = 0, 1, 2, 3, 4
_LINES_PER_CHUNK = {_COMP_NONE: 1, _COMP_ZIPS: 1, _COMP_ZIP: 16, _COMP_PIZ: 32}


def _read_cstring(buf, pos):
    end = buf.index(b"\0", pos)
    return buf[pos:end].decode("latin-1"), end + 1


def _unpredict_and_deinterleave(data: bytes) -> bytes:
    """Invert EXR ZIP post-deflate filtering: delta-decode, then restore the
    even/odd byte split (ImfZip::uncompress)."""
    t = np.frombuffer(data, np.uint8).astype(np.int16)
    t = np.cumsum(t - 128, dtype=np.int64) + 128  # t[i] += t[i-1] - 128
    t = (t % 256).astype(np.uint8)
    n = len(t)
    half = (n + 1) // 2
    out = np.empty(n, np.uint8)
    out[0::2] = t[:half]
    out[1::2] = t[half:]
    return out.tobytes()


def _interleave_and_predict(data: bytes) -> bytes:
    """Forward EXR ZIP filtering (ImfZip::compress)."""
    raw = np.frombuffer(data, np.uint8)
    n = len(raw)
    half = (n + 1) // 2
    t = np.empty(n, np.uint8)
    t[:half] = raw[0::2]
    t[half:] = raw[1::2]
    d = t.astype(np.int16)
    d[1:] = np.diff(t.astype(np.int16)) + 128
    return (d % 256).astype(np.uint8).tobytes()


# ---------------------------------------------------------------------------
# PIZ decompression (ImfPizCompressor / ImfHuf / ImfWav)
# ---------------------------------------------------------------------------

_HUF_DECBITS = 14
_HUF_DECMASK = (1 << _HUF_DECBITS) - 1
_SHORT_ZEROCODE_RUN = 59
_LONG_ZEROCODE_RUN = 63
_SHORTEST_LONG_RUN = 2 + _LONG_ZEROCODE_RUN - _SHORT_ZEROCODE_RUN  # 6


class _BitReader:
    __slots__ = ("data", "pos", "c", "lc")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.c = 0
        self.lc = 0

    def get(self, nbits: int) -> int:
        while self.lc < nbits:
            self.c = (self.c << 8) | self.data[self.pos]
            self.pos += 1
            self.lc += 8
        self.lc -= nbits
        out = (self.c >> self.lc) & ((1 << nbits) - 1)
        self.c &= (1 << self.lc) - 1
        return out


def _huf_unpack_enc_table(br: _BitReader, im: int, iM: int):
    """Packed 6-bit canonical code lengths -> per-symbol (code, length)
    (ImfHuf.cpp hufUnpackEncTable + hufCanonicalCodeTable)."""
    lengths = np.zeros(iM + 1, np.int64)
    i = im
    while i <= iM:
        l = br.get(6)
        if l == _LONG_ZEROCODE_RUN:
            i += br.get(8) + _SHORTEST_LONG_RUN
        elif l >= _SHORT_ZEROCODE_RUN:
            i += l - _SHORT_ZEROCODE_RUN + 2
        else:
            lengths[i] = l
            i += 1
    if i != iM + 1 and i != iM + 1 + 0:  # overruns indicate corruption
        if i > iM + 1:
            raise ValueError("EXR PIZ: corrupt Huffman table (zero-run overrun)")

    # canonical codes: numerically lowest code per length, assigned in
    # symbol order (hufCanonicalCodeTable)
    n = np.zeros(59, np.int64)
    for l in lengths:
        n[l] += 1
    c = 0
    base = np.zeros(59, np.int64)
    for l in range(58, 0, -1):
        nc = (c + n[l]) >> 1
        base[l] = c
        c = nc
    codes = np.zeros(iM + 1, np.int64)
    nxt = base.copy()
    for s in range(iM + 1):
        l = lengths[s]
        if l > 0:
            codes[s] = nxt[l]
            nxt[l] += 1
    return codes, lengths


def _huf_decode(codes, lengths, data: bytes, n_bits: int, rlc: int,
                n_out: int) -> np.ndarray:
    """Canonical-Huffman bitstream -> n_out u16 symbols (ImfHuf hufDecode).
    rlc is the run-length symbol: the following 8 bits repeat the previous
    output symbol."""
    # fast table for codes <= 14 bits: prefix -> (length, symbol);
    # longer codes fall back to per-length dicts
    table_len = np.zeros(1 << _HUF_DECBITS, np.uint8)
    table_sym = np.zeros(1 << _HUF_DECBITS, np.uint32)
    long_codes = {}   # length -> {code: symbol}
    for s in range(len(lengths)):
        l = int(lengths[s])
        if l == 0:
            continue
        cc = int(codes[s])
        if l <= _HUF_DECBITS:
            lo = cc << (_HUF_DECBITS - l)
            hi = lo + (1 << (_HUF_DECBITS - l))
            table_len[lo:hi] = l
            table_sym[lo:hi] = s
        else:
            long_codes.setdefault(l, {})[cc] = s
    long_lens = sorted(long_codes)

    out = np.empty(n_out, np.uint16)
    oi = 0
    c = 0
    lc = 0
    pos = 0
    end = (n_bits + 7) // 8
    while oi < n_out:
        while lc < _HUF_DECBITS + 8 and pos < end:
            c = (c << 8) | data[pos]
            pos += 1
            lc += 8
        if lc <= 0:
            raise ValueError("EXR PIZ: Huffman bitstream exhausted early")
        idx = ((c << _HUF_DECBITS) >> lc) & _HUF_DECMASK
        l = int(table_len[idx])
        if l:
            if l > lc:
                raise ValueError("EXR PIZ: truncated Huffman bitstream")
            sym = int(table_sym[idx])
            lc -= l
        else:
            for l in long_lens:
                while lc < l and pos < end:
                    c = (c << 8) | data[pos]
                    pos += 1
                    lc += 8
                if lc < l:
                    continue
                sym = long_codes[l].get((c >> (lc - l)) & ((1 << l) - 1))
                if sym is not None:
                    lc -= l
                    break
            else:
                raise ValueError("EXR PIZ: invalid Huffman code")
        c &= (1 << lc) - 1
        if sym == rlc:
            if lc < 8:
                c = (c << 8) | data[pos]
                pos += 1
                lc += 8
            lc -= 8
            cs = (c >> lc) & 0xFF
            c &= (1 << lc) - 1
            if oi == 0:
                raise ValueError("EXR PIZ: run-length code with no prior symbol")
            out[oi:oi + cs] = out[oi - 1]
            oi += cs
        else:
            out[oi] = sym
            oi += 1
    return out


def _wav2_decode(a: np.ndarray, mx: int):
    """In-place 2D wavelet decode of a [ny, nx] u16 view (ImfWav wav2Decode)."""
    ny, nx = a.shape
    n = min(nx, ny)
    p = 1
    while p <= n:
        p <<= 1
    p >>= 1
    p2 = p
    p >>= 1
    w14 = mx < (1 << 14)

    def wdec(lo, hi):
        if w14:
            ls = lo.astype(np.int16).astype(np.int32)
            hs = hi.astype(np.int16).astype(np.int32)
            ai = ls + (hs & 1) + (hs >> 1)
            return ai.astype(np.uint16), (ai - hs).astype(np.uint16)
        m = lo.astype(np.int64)
        d = hi.astype(np.int64)
        bb = (m - (d >> 1)) & 0xFFFF
        aa = (d + bb - 0x8000) & 0xFFFF
        return aa.astype(np.uint16), bb.astype(np.uint16)

    while p >= 1:
        ys = np.arange(0, ny - p2 + 1, p2) if ny >= p2 else np.arange(0)
        xs = np.arange(0, nx - p2 + 1, p2) if nx >= p2 else np.arange(0)
        if len(ys) and len(xs):
            Y, X = np.meshgrid(ys, xs, indexing="ij")
            i00, i10 = wdec(a[Y, X], a[Y + p, X])
            i01, i11 = wdec(a[Y, X + p], a[Y + p, X + p])
            a00, a01 = wdec(i00, i01)
            a10, a11 = wdec(i10, i11)
            a[Y, X], a[Y, X + p] = a00, a01
            a[Y + p, X], a[Y + p, X + p] = a10, a11
        px_after = (len(xs)) * p2 if len(xs) else 0
        py_after = (len(ys)) * p2 if len(ys) else 0
        if (nx & p) and len(ys):          # odd remainder column (1D vertical)
            cx = px_after
            i00, b = wdec(a[ys, cx], a[ys + p, cx])
            a[ys, cx], a[ys + p, cx] = i00, b
        if (ny & p) and len(xs):          # odd remainder line (1D horizontal)
            ry = py_after
            i00, b = wdec(a[ry, xs], a[ry, xs + p])
            a[ry, xs], a[ry, xs + p] = i00, b
        p2 = p
        p >>= 1


def _piz_uncompress(raw: bytes, w: int, n_lines: int, chan_sorted, dtypes):
    """One PIZ chunk -> uncompressed scanline bytes (channel rows per line,
    like the NONE layout)."""
    minNZ, maxNZ = struct.unpack_from("<HH", raw, 0)
    p = 4
    bitmap = np.zeros(8192, np.uint8)
    if minNZ <= maxNZ:
        nb = maxNZ - minNZ + 1
        bitmap[minNZ:maxNZ + 1] = np.frombuffer(raw, np.uint8, nb, p)
        p += nb
    # reverse LUT: compact index -> u16 value (0 always present)
    bits = np.unpackbits(bitmap, bitorder="little")
    bits[0] = 1
    lut = np.nonzero(bits)[0].astype(np.uint16)
    max_value = len(lut) - 1

    (length,) = struct.unpack_from("<i", raw, p)
    p += 4
    huf = raw[p:p + length]

    # hufUncompress header: im, iM, tableLength(unused), nBits, future(unused)
    im, iM, _tl, n_bits, _fut = struct.unpack_from("<5i", huf, 0)
    br = _BitReader(huf[20:])
    codes, lengths = _huf_unpack_enc_table(br, im, iM)
    bitstream = huf[20 + br.pos:]

    sizes = [dt.itemsize // 2 for dt in dtypes]          # u16s per sample
    per_chan = [w * s * n_lines for s in sizes]
    total = sum(per_chan)
    data = _huf_decode(codes, lengths, bitstream, n_bits, iM, total)

    off = 0
    chan_bufs = []
    for (name, _), s in zip(chan_sorted, sizes):
        buf = data[off:off + w * s * n_lines].reshape(n_lines, w * s)
        off += w * s * n_lines
        for j in range(s):                               # wavelet per u16 plane
            view = buf[:, j::s]
            _wav2_decode(view, max_value)
            buf[:, j::s] = view
        chan_bufs.append(lut[buf])                       # apply reverse LUT
    # interleave back to scanline order: per line, per channel, raw row bytes
    out = bytearray()
    for li in range(n_lines):
        for buf in chan_bufs:
            out += buf[li].tobytes()
    return bytes(out)


def read_exr(path: str) -> np.ndarray:
    """Read an EXR image -> float32 [H, W] (one channel) or [H, W, C]
    (channels in B,G,R[,A]... i.e. cv2 order if named R/G/B, else
    alphabetical as stored)."""
    with open(path, "rb") as f:
        buf = f.read()

    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    if version & 0x200 or version & 0x800 or version & 0x1000:
        raise NotImplementedError(f"{path}: tiled/deep/multipart EXR "
                                  "not supported")
    pos = 8

    channels = []          # (name, pixel_type)
    compression = None
    data_window = None
    line_order = 0
    while True:
        if buf[pos] == 0:  # end of header
            pos += 1
            break
        name, pos = _read_cstring(buf, pos)
        typ, pos = _read_cstring(buf, pos)
        size = struct.unpack_from("<i", buf, pos)[0]
        pos += 4
        val = buf[pos:pos + size]
        pos += size
        if name == "channels":
            p = 0
            while val[p] != 0:
                cname, p = _read_cstring(val, p)
                ptype = struct.unpack_from("<i", val, p)[0]
                p += 16   # pixelType + pLinear/reserved + xSampling + ySampling
                channels.append((cname, ptype))
        elif name == "compression":
            compression = val[0]
        elif name == "dataWindow":
            data_window = struct.unpack("<4i", val)
        elif name == "lineOrder":
            line_order = val[0]

    if compression not in _LINES_PER_CHUNK:
        names = {0: "NONE", 1: "RLE", 2: "ZIPS", 3: "ZIP", 4: "PIZ",
                 5: "PXR24", 6: "B44", 7: "B44A", 8: "DWAA", 9: "DWAB"}
        raise NotImplementedError(
            f"{path}: EXR compression {names.get(compression, compression)} "
            "not supported (NONE/ZIPS/ZIP are)")

    xmin, ymin, xmax, ymax = data_window
    w, h = xmax - xmin + 1, ymax - ymin + 1
    lines_per_chunk = _LINES_PER_CHUNK[compression]
    n_chunks = -(-h // lines_per_chunk)

    # channels are stored alphabetically within each scanline
    chan_sorted = sorted(channels, key=lambda c: c[0])
    dtypes = [_PIXEL_DTYPES[t] for _, t in chan_sorted]

    offsets = struct.unpack_from(f"<{n_chunks}q", buf, pos)
    planes = {name: np.empty((h, w), np.float32) for name, _ in chan_sorted}

    for off in offsets:
        y, nbytes = struct.unpack_from("<ii", buf, off)
        raw = buf[off + 8: off + 8 + nbytes]
        y0 = y - ymin
        n_lines = min(lines_per_chunk, h - y0)
        expect = sum(dt.itemsize for dt in dtypes) * w * n_lines
        if nbytes < expect:   # == expect means stored raw (unprofitable)
            if compression == _COMP_PIZ:
                raw = _piz_uncompress(raw, w, n_lines, chan_sorted, dtypes)
            else:
                raw = _unpredict_and_deinterleave(zlib.decompress(raw))
        p = 0
        for li in range(n_lines):
            for (name, _), dt in zip(chan_sorted, dtypes):
                row = np.frombuffer(raw, dt, count=w, offset=p)
                p += w * dt.itemsize
                planes[name][y0 + li] = row.astype(np.float32)

    if line_order == 1:  # DECREASING_Y: chunk y values already absolute; rows
        pass             # were placed by y, so nothing to flip

    names = [n for n, _ in chan_sorted]
    if len(names) == 1:
        return planes[names[0]]
    # cv2 returns BGR for R/G/B-named channels; mirror that for parity
    if set(names) >= {"R", "G", "B"}:
        order = [n for n in ("B", "G", "R", "A") if n in names]
        order += [n for n in names if n not in order]
    else:
        order = names
    return np.stack([planes[n] for n in order], axis=-1)


def write_exr(path: str, img: np.ndarray, channel_names=None,
              pixel_type: str = "float", compression: str = "zip"):
    """Write [H, W] or [H, W, C] float data as a scanline EXR.

    pixel_type: 'float' or 'half'; compression: 'none', 'zips' or 'zip'.
    Used by the dataset fixtures/tests; read_exr round-trips it.
    """
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if channel_names is None:
        channel_names = ["Y"] if c == 1 else list("RGBA"[:c])
    assert len(channel_names) == c
    ptype = {"half": 1, "float": 2}[pixel_type]
    dt = _PIXEL_DTYPES[ptype]
    comp = {"none": _COMP_NONE, "zips": _COMP_ZIPS, "zip": _COMP_ZIP}[compression]
    lines_per_chunk = _LINES_PER_CHUNK[comp]

    order = np.argsort(channel_names)  # alphabetical storage order
    chan_sorted = [(channel_names[i], img[..., i]) for i in order]

    def attr(name, typ, data):
        return (name.encode() + b"\0" + typ.encode() + b"\0"
                + struct.pack("<i", len(data)) + data)

    chlist = b""
    for cname, _ in chan_sorted:
        chlist += cname.encode() + b"\0" + struct.pack("<iBBBBii", ptype,
                                                       0, 0, 0, 0, 1, 1)
    chlist += b"\0"
    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    header = (struct.pack("<ii", MAGIC, 2)
              + attr("channels", "chlist", chlist)
              + attr("compression", "compression", bytes([comp]))
              + attr("dataWindow", "box2i", box)
              + attr("displayWindow", "box2i", box)
              + attr("lineOrder", "lineOrder", b"\0")
              + attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
              + attr("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0))
              + attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
              + b"\0")

    chunks = []
    for y0 in range(0, h, lines_per_chunk):
        n_lines = min(lines_per_chunk, h - y0)
        raw = b"".join(
            np.ascontiguousarray(plane[y0 + li], dtype=np.float32)
            .astype(dt).tobytes()
            for li in range(n_lines) for _, plane in chan_sorted)
        if comp == _COMP_NONE:
            payload = raw
        else:
            z = zlib.compress(_interleave_and_predict(raw))
            payload = z if len(z) < len(raw) else raw
        chunks.append(struct.pack("<ii", y0, len(payload)) + payload)

    n_chunks = len(chunks)
    table_pos = len(header)
    data_pos = table_pos + 8 * n_chunks
    offsets, cur = [], data_pos
    for ch in chunks:
        offsets.append(cur)
        cur += len(ch)

    with open(path, "wb") as f:
        f.write(header)
        f.write(struct.pack(f"<{n_chunks}q", *offsets))
        for ch in chunks:
            f.write(ch)
