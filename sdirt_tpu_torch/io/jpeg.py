"""A baseline JPEG decoder in numpy, output equal to ``cv2.imread``'s.

The NYU depth set stores its colour frames as JPEG, and the card's machine
has neither cv2 nor PIL. This decoder reproduces what OpenCV's bundled
libjpeg(-turbo) gives at its defaults:

  * the ``islow`` integer IDCT (jidctint.c: 13-bit constants, two passes,
    the post-IDCT range-limit table with its wraparound);
  * "fancy" triangle upsampling of 2x1 (h2v1) and 2x2 (h2v2) subsampled
    chroma (jdsample.c), with the edge rows and columns replicated as the
    main controller's context rows replicate them; chroma two samples wide
    or less is replicated instead, as libjpeg does;
  * the fixed-point YCbCr -> RGB tables of jdcolor.c (16-bit scale).

Supported: 8-bit baseline or extended-sequential Huffman files with one
(grey) or three components, sampling 1x1, 2x1 and 2x2 (relative to the
largest factor), interleaved or per-component scans, restart markers.
Progressive, lossless, hierarchical and arithmetic-coded files, 12-bit
samples, two- and four-component (CMYK) files raise NotImplementedError
naming the file.

The entropy decoder is table-driven: every symbol is read through a 16-bit
look-ahead, and for the usual short codes one table entry gives the code's
and the magnitude bits' length, the zero run and the coefficient value
together. The IDCT, the upsampling and the colour conversion run over all
blocks at once.
"""

from __future__ import annotations

import functools
import struct

import numpy as np

# natural (row-major) index of each zigzag position, and positions past the
# end mapped to a spare slot 64 that a corrupt run would write into
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
_ZZ = _ZIGZAG.tolist() + [64] * 80

_UNSUPPORTED_SOF = {0xC2: "progressive", 0xC3: "lossless",
                    0xC5: "differential sequential", 0xC6: "differential progressive",
                    0xC7: "differential lossless", 0xC9: "arithmetic-coded",
                    0xCA: "arithmetic-coded progressive", 0xCB: "arithmetic-coded lossless",
                    0xCD: "arithmetic-coded differential",
                    0xCE: "arithmetic-coded differential progressive",
                    0xCF: "arithmetic-coded differential lossless"}

# jidctint.c constants, FIX(x) at CONST_BITS = 13
_CONST_BITS, _PASS1_BITS = 13, 2
_F0298, _F0390, _F0541, _F0765 = 2446, 3196, 4433, 6270
_F0899, _F1175, _F1501, _F1847 = 7373, 9633, 12299, 15137
_F1961, _F2053, _F2562, _F3072 = 16069, 16819, 20995, 25172


def _range_limit_table() -> np.ndarray:
    """libjpeg's post-IDCT range limit (jdmaster.c), indexed by the
    descaled sample & 1023: x + 128 clamped to [0, 255] for x in
    [-512, 511], wrapping beyond."""
    x = np.arange(1024)
    x = np.where(x >= 512, x - 1024, x)
    return np.clip(x + 128, 0, 255).astype(np.uint8)


_RANGE_LIMIT = _range_limit_table()


def _ycc_tables():
    """jdcolor.c build_ycc_rgb_table: Cr->R, Cb->B rounded, Cr->G and
    Cb->G (+ONE_HALF) scaled by 2^16."""
    x = np.arange(256, dtype=np.int64) - 128
    one_half = 1 << 15

    def fix(v):
        return int(v * (1 << 16) + 0.5)

    cr_r = (fix(1.40200) * x + one_half) >> 16
    cb_b = (fix(1.77200) * x + one_half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + one_half
    return cr_r, cb_b, cr_g, cb_g


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_tables()


class _Huffman:
    """One Huffman table with its 16-bit look-ahead tables.

    ``slow[look]`` is (code length, symbol), length 0 for no code. ``fast``
    is one tuple per look-ahead: for a code whose length plus magnitude
    bits fit in 16, (bits consumed, zero run, value) with a nonzero value,
    or (bits consumed, 15, 0) for ZRL and (bits consumed, 0, 0) for EOB;
    (0, 0, 0) sends the symbol to the slow path. For a DC table the run is
    0 and the value is the difference (possibly 0)."""

    def __init__(self, counts, symbols, dc: bool):
        length = np.zeros(1 << 16, np.int64)
        symbol = np.zeros(1 << 16, np.int64)
        code, k = 0, 0
        for bits in range(1, 17):
            for _ in range(counts[bits - 1]):
                lo = code << (16 - bits)
                hi = (code + 1) << (16 - bits)
                length[lo:hi] = bits
                symbol[lo:hi] = symbols[k]
                code += 1
                k += 1
            code <<= 1
        self.slow = list(zip(length.tolist(), symbol.tolist()))
        look = np.arange(1 << 16, dtype=np.int64)
        s = symbol & 15
        run = symbol >> 4
        total = length + s
        fits = (length > 0) & (total <= 16)
        extra = (look >> np.clip(16 - total, 0, 16)) & ((1 << s) - 1)
        value = np.where(extra < (1 << np.maximum(s - 1, 0)),
                         extra - (1 << s) + 1, extra)
        value = np.where(s == 0, 0, value)
        if dc:
            fits &= symbol <= 16
            run = np.zeros_like(run)
            consumed = np.where(fits, total, 0)
        else:
            special = (s == 0) & ((run == 0) | (run == 15))
            fits &= (s > 0) | special
            consumed = np.where(fits, total, 0)
        run = np.where(fits, run, 0)
        value = np.where(fits, value, 0)
        self.fast = list(zip(consumed.tolist(), run.tolist(), value.tolist()))


@functools.lru_cache(maxsize=32)
def _huffman(counts: bytes, symbols: bytes, dc: bool) -> _Huffman:
    """Tables are shared between files that carry the same codes (every
    file of one encoder, as a rule)."""
    return _Huffman(counts, symbols, dc)


def _extend(v: int, s: int) -> int:
    return v - (1 << s) + 1 if v < (1 << (s - 1)) else v


def _windows(seg: np.ndarray) -> list:
    """The 16-bit look-ahead at every bit position of an unstuffed segment
    (zero bits past its end, as libjpeg inserts them)."""
    b = np.concatenate([seg, np.zeros(4, np.uint8)]).astype(np.int64)
    w = (b[:-3] << 16) | (b[1:-2] << 8) | b[2:-1]          # 24 bits per byte
    shift = 8 - np.arange(8)
    return (((w[:, None] >> shift) & 0xFFFF).reshape(-1)).tolist()


def _unsupported(name, what):
    return NotImplementedError(f"{name}: {what} JPEG is not supported by the "
                               "baseline decoder")


class _Component:
    def __init__(self, cid, h, v, tq):
        self.id, self.h, self.v, self.tq = cid, h, v, tq


def _scan_segments(data: bytes, pos: int):
    """Split the entropy-coded data that starts at ``pos`` at its restart
    markers. Returns (unstuffed segments, position of the marker that
    ends the scan)."""
    arr = np.frombuffer(data, np.uint8, offset=pos)
    ff = np.flatnonzero(arr[:-1] == 0xFF)
    nxt = arr[ff + 1]
    ends = ff[(nxt != 0x00) & ((nxt < 0xD0) | (nxt > 0xD7)) & (nxt != 0xFF)]
    end = int(ends[0]) if len(ends) else len(arr)
    scan = arr[:end]
    ff = np.flatnonzero(scan[:-1] == 0xFF)
    nxt = scan[ff + 1]
    rst = ff[(nxt >= 0xD0) & (nxt <= 0xD7)]
    drop = np.concatenate([ff[nxt == 0x00] + 1, ff[nxt == 0xFF]])
    keep = np.ones(len(scan), bool)
    keep[drop] = False
    bounds = np.concatenate([[0], rst, [len(scan)]])
    segs = []
    for i in range(len(bounds) - 1):
        lo = bounds[i] + (2 if i else 0)
        hi = bounds[i + 1]
        segs.append(scan[lo:hi][keep[lo:hi]])
    return segs, pos + end


def _decode_scan(segs, comps, mcu_blocks, n_mcus, restart, dc_tabs, ac_tabs,
                 blocks, name):
    """Huffman-decode one scan into ``blocks`` (per component, a list of
    64-entry coefficient lists in natural order, by block index).
    mcu_blocks: per MCU, the (component index, block offset) pairs; the
    block index of MCU m is offset + base(m) per component."""
    zz = _ZZ
    seg_i, win, p = 0, None, 0
    preds = [0] * len(comps)
    per_seg = restart or n_mcus
    for m in range(n_mcus):
        if m % per_seg == 0:
            if seg_i >= len(segs):
                raise ValueError(f"{name}: truncated scan (restart {seg_i})")
            win, p = _windows(segs[seg_i]), 0
            seg_i += 1
            preds = [0] * len(comps)
        for ci, index in mcu_blocks(m):
            dc, ac = dc_tabs[ci], ac_tabs[ci]
            blk = [0] * 65
            n, _, v = dc.fast[win[p]]
            if n:
                p += n
            else:
                n, s = dc.slow[win[p]]
                if not n:
                    raise ValueError(f"{name}: bad Huffman code")
                p += n
                v = 0
                if s:
                    v = _extend(win[p] >> (16 - s), s)
                    p += s
            preds[ci] += v
            blk[0] = preds[ci]
            fast, k = ac.fast, 1
            while k < 64:
                n, r, v = fast[win[p]]
                if n:
                    p += n
                    if v:
                        k += r
                        blk[zz[k]] = v
                        k += 1
                    elif r:
                        k += 16
                    else:
                        break
                    continue
                n, sym = ac.slow[win[p]]
                if not n:
                    raise ValueError(f"{name}: bad Huffman code")
                p += n
                s, r = sym & 15, sym >> 4
                if s:
                    k += r
                    blk[zz[k]] = _extend(win[p] >> (16 - s), s)
                    p += s
                    k += 1
                elif r == 15:
                    k += 16
                else:
                    break
            blocks[ci][index] = blk


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _idct_1d(x0, x1, x2, x3, x4, x5, x6, x7):
    """jidctint.c's butterflies on int64 arrays; returns the 8 outputs
    before descaling."""
    z1 = (x2 + x6) * _F0541
    tmp2 = z1 + x6 * -_F1847
    tmp3 = z1 + x2 * _F0765
    tmp0 = (x0 + x4) << _CONST_BITS
    tmp1 = (x0 - x4) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x7, x5, x3, x1
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F1175
    t0 = t0 * _F0298
    t1 = t1 * _F2053
    t2 = t2 * _F3072
    t3 = t3 * _F1501
    z1 = z1 * -_F0899
    z2 = z2 * -_F2562
    z3 = z3 * -_F1961 + z5
    z4 = z4 * -_F0390 + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    return (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)


def idct_islow(coef: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """Dequantise and inverse-transform blocks as jpeg_idct_islow does.
    coef: [N, 64] in natural order; qt: [64] natural order. Returns
    [N, 8, 8] uint8 samples."""
    c = (coef.astype(np.int64) * qt.astype(np.int64)).reshape(-1, 8, 8)
    # pass 1: columns (vertical frequencies), scaled up by 2^PASS1_BITS
    ws = _idct_1d(*(c[:, i, :] for i in range(8)))
    ws = np.stack([_descale(v, _CONST_BITS - _PASS1_BITS) for v in ws], axis=1)
    # pass 2: rows, descaled by 8 and 2^PASS1_BITS, range-limited
    out = _idct_1d(*(ws[:, :, i] for i in range(8)))
    out = np.stack([_descale(v, _CONST_BITS + _PASS1_BITS + 3) for v in out], axis=2)
    return _RANGE_LIMIT[out & 1023]


def _upsample_h2v1(x: np.ndarray) -> np.ndarray:
    """jdsample.c h2v1_fancy_upsample over rows of [H, W] samples."""
    x = x.astype(np.int32)
    left = np.concatenate([x[:, :1], x[:, :-1]], axis=1)
    right = np.concatenate([x[:, 1:], x[:, -1:]], axis=1)
    out = np.empty((x.shape[0], 2 * x.shape[1]), np.int32)
    out[:, 0::2] = (3 * x + left + 1) >> 2
    out[:, 1::2] = (3 * x + right + 2) >> 2
    return out


def _upsample_h2v2(x: np.ndarray) -> np.ndarray:
    """jdsample.c h2v2_fancy_upsample: 3/4 nearer + 1/4 further in each
    direction (9/16, 3/16, 3/16, 1/16), the outer rows and columns
    replicated."""
    x = x.astype(np.int32)
    above = np.concatenate([x[:1], x[:-1]], axis=0)
    below = np.concatenate([x[1:], x[-1:]], axis=0)
    colsum = np.empty((2 * x.shape[0], x.shape[1]), np.int32)
    colsum[0::2] = 3 * x + above
    colsum[1::2] = 3 * x + below
    left = np.concatenate([colsum[:, :1], colsum[:, :-1]], axis=1)
    right = np.concatenate([colsum[:, 1:], colsum[:, -1:]], axis=1)
    out = np.empty((colsum.shape[0], 2 * colsum.shape[1]), np.int32)
    out[:, 0::2] = (3 * colsum + left + 8) >> 4
    out[:, 1::2] = (3 * colsum + right + 7) >> 4
    return out


def _upsample(plane, fh, fv, name):
    if (fh, fv) == (1, 1):
        return plane
    if (fh, fv) not in ((2, 1), (2, 2)):
        raise _unsupported(name, f"{fh}x{fv} chroma subsampling")
    if plane.shape[1] <= 2:              # libjpeg's plain (box) upsampling
        return np.repeat(np.repeat(plane, fv, axis=0), fh, axis=1)
    return _upsample_h2v1(plane) if fv == 1 else _upsample_h2v2(plane)


def ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """jdcolor.c ycc_rgb_convert on uint8 planes -> [H, W, 3] uint8 RGB."""
    y = y.astype(np.int64)
    cb = cb.astype(np.intp)
    cr = cr.astype(np.intp)
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = y + _CB_B[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """Decode a baseline JPEG held in ``data``: [H, W] uint8 for one
    component, else [H, W, 3] uint8 RGB (cv2.imread's BGR reversed)."""
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{name}: not a JPEG file")
    qts, dc_tabs, ac_tabs = {}, {}, {}
    comps, frame, restart = [], None, 0
    adobe_transform, jfif = None, False
    blocks = None
    pos = 2
    while pos < len(data):
        if data[pos] != 0xFF:
            raise ValueError(f"{name}: marker expected at byte {pos}")
        while data[pos] == 0xFF:
            pos += 1
        marker = data[pos]
        pos += 1
        if marker == 0xD9:                                    # EOI
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        (length,) = struct.unpack_from(">H", data, pos)
        body = data[pos + 2:pos + length]
        pos += length
        if marker in _UNSUPPORTED_SOF:
            raise _unsupported(name, _UNSUPPORTED_SOF[marker])
        if marker == 0xCC:
            raise _unsupported(name, "arithmetic-coded")
        if marker in (0xC0, 0xC1):                            # SOF0 / SOF1
            precision, height, width, nf = struct.unpack_from(">BHHB", body, 0)
            if precision != 8:
                raise _unsupported(name, f"{precision}-bit")
            if nf not in (1, 3):
                raise _unsupported(name, f"{nf}-component" + (" (CMYK)" if nf == 4 else ""))
            if height == 0:
                raise _unsupported(name, "DNL-sized")
            comps = [_Component(body[6 + 3 * i], body[7 + 3 * i] >> 4,
                                body[7 + 3 * i] & 15, body[8 + 3 * i]) for i in range(nf)]
            hmax = max(c.h for c in comps)
            vmax = max(c.v for c in comps)
            mcux = -(-width // (8 * hmax))
            mcuy = -(-height // (8 * vmax))
            for c in comps:
                c.bw, c.bh = mcux * c.h, mcuy * c.v
                c.width = -(-width * c.h // hmax)
                c.height = -(-height * c.v // vmax)
            frame = (height, width, hmax, vmax, mcux, mcuy)
            blocks = [[None] * (c.bw * c.bh) for c in comps]
        elif marker == 0xC4:                                  # DHT
            p = 0
            while p < len(body):
                tc, th = body[p] >> 4, body[p] & 15
                counts = list(body[p + 1:p + 17])
                n = sum(counts)
                syms = list(body[p + 17:p + 17 + n])
                (dc_tabs if tc == 0 else ac_tabs)[th] = _huffman(
                    bytes(counts), bytes(syms), tc == 0)
                p += 17 + n
        elif marker == 0xDB:                                  # DQT
            p = 0
            while p < len(body):
                pq, tq = body[p] >> 4, body[p] & 15
                if pq:
                    vals = np.frombuffer(body, ">u2", 64, p + 1).astype(np.int64)
                    p += 129
                else:
                    vals = np.frombuffer(body, np.uint8, 64, p + 1).astype(np.int64)
                    p += 65
                qt = np.zeros(64, np.int64)
                qt[_ZIGZAG] = vals
                qts[tq] = qt
        elif marker == 0xDD:                                  # DRI
            (restart,) = struct.unpack_from(">H", body, 0)
        elif marker == 0xE0 and body[:5] == b"JFIF\0":
            jfif = True
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe_transform = body[11]
        elif marker == 0xDA:                                  # SOS
            if frame is None:
                raise ValueError(f"{name}: scan before frame header")
            ns = body[0]
            sel = []
            for i in range(ns):
                cid, tab = body[1 + 2 * i], body[2 + 2 * i]
                ci = next(j for j, c in enumerate(comps) if c.id == cid)
                sel.append((ci, tab >> 4, tab & 15))
            ss, se = body[1 + 2 * ns], body[2 + 2 * ns]
            if ss != 0 or se != 63:
                raise _unsupported(name, "progressive")
            segs, pos = _scan_segments(data, pos)
            height, width, hmax, vmax, mcux, mcuy = frame
            dcs = {ci: dc_tabs[td] for ci, td, _ in sel}
            acs = {ci: ac_tabs[ta] for ci, _, ta in sel}
            if ns == 1:                                       # one block per MCU
                ci = sel[0][0]
                c = comps[ci]
                nbx, nby = -(-c.width // 8), -(-c.height // 8)

                def mcu_blocks(m, ci=ci, nbx=nbx, bw=c.bw):
                    return ((ci, (m // nbx) * bw + m % nbx),)
                n_mcus = nbx * nby
            else:
                order = [(ci, y * comps[ci].bw + x) for ci, _, _ in sel
                         for y in range(comps[ci].v) for x in range(comps[ci].h)]

                def mcu_blocks(m, order=order):
                    my, mx = divmod(m, mcux)
                    return [(ci, off + my * comps[ci].v * comps[ci].bw + mx * comps[ci].h)
                            for ci, off in order]
                n_mcus = mcux * mcuy
            _decode_scan(segs, comps, mcu_blocks, n_mcus, restart, dcs, acs,
                         blocks, name)
    if frame is None:
        raise ValueError(f"{name}: no frame header")
    height, width, hmax, vmax, _, _ = frame
    planes = []
    for ci, c in enumerate(comps):
        coef = np.array([b[:64] if b is not None else [0] * 64 for b in blocks[ci]],
                        np.int64)
        pix = idct_islow(coef, qts[c.tq])
        plane = pix.reshape(c.bh, c.bw, 8, 8).transpose(0, 2, 1, 3).reshape(
            c.bh * 8, c.bw * 8)[:c.height, :c.width]
        plane = _upsample(plane, hmax // c.h, vmax // c.v, name)
        planes.append(plane[:height, :width])
    if len(comps) == 1:
        return planes[0].astype(np.uint8)
    ids = tuple(c.id for c in comps)
    rgb = (adobe_transform == 0 if adobe_transform is not None
           else (not jfif and ids == (82, 71, 66)))
    if rgb:
        return np.stack(planes, axis=-1).astype(np.uint8)
    return ycc_to_rgb(*planes)


def read_jpeg(path: str) -> np.ndarray:
    """Decode the baseline JPEG at ``path`` (see decode_jpeg)."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), path)
