"""The port's native PNG/JPEG loader (sdirt_tpu_torch/native/src/sdirt_loader.cc,
zlib alone) against the JAX package's engine (sdirt_tpu/native, libpng +
libjpeg), the port's numpy decoders (dfdp/datasets.py:read_png,
io/jpeg.py:read_jpeg) and, through the Canon sets, the JAX loader under its
``native`` engine.

Tolerances: PNG at any size under NEAREST and JPEG at its own size are
bit-equal; CUBIC is within 1e-4 on 8-bit samples and 0.03 on 16-bit ones of
the JAX engine (f32 rounding of two 4-tap passes; both libraries are built
with -march=native and measure 0 here); the Canon items are within 1e-6 and
their depth bit-equal. The library is built with g++ on first use (~5 s).
"""

import glob
import os
import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from sdirt_tpu_torch import native
from sdirt_tpu_torch.dfdp import datasets as TD
from sdirt_tpu_torch.dfdp.datasets import read_png
from sdirt_tpu_torch.io.jpeg import read_jpeg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NYU = sorted(glob.glob(os.path.join(ROOT, "sdirt_tpu_torch", "reference", "datasets",
                                    "nyu2_train", "*", "*.jpg")))
FLAT = os.path.join(ROOT, "real_sample_set", "flat")
CASUAL = os.path.join(ROOT, "real_sample_set", "casual")
HW = (37, 53)
CUBIC_TOL = {8: 1e-4, 16: 0.03}


def jax_native():
    from sdirt_tpu import native as jn

    return jn


# -- PNG files --------------------------------------------------------------------


def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def _filtered(raw, prev, bpp, ft):
    """One scanline under filter type ft (encoder side), mod 256."""
    r, b = raw.astype(np.int32), prev.astype(np.int32)
    a = np.concatenate([np.zeros(bpp, np.int32), r[:-bpp]])
    c = np.concatenate([np.zeros(bpp, np.int32), b[:-bpp]])
    if ft == 4:
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    else:
        pred = (0 * r, a, b, (a + b) >> 1)[ft]
    return np.concatenate([[ft], (r - pred) & 255]).astype(np.uint8)


def write_png(path, samples, ctype, depth, interlace=False, palette=None, trns=None):
    """samples [H, W] or [H, W, C] (grey levels or palette indices below
    2**depth) as a PNG, the scanlines' filter types taken in turn and the
    data split over two IDAT chunks; Adam7 with ``interlace``."""
    s = samples if samples.ndim == 3 else samples[..., None]
    h, w, nc = s.shape
    bpp = max(1, nc * depth // 8)
    passes = ([(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
               (1, 0, 2, 2), (0, 1, 1, 2)] if interlace else [(0, 0, 1, 1)])
    data = b""
    for p, (sx, sy, dx, dy) in enumerate(passes):
        sub = s[sy::dy, sx::dx]
        if sub.size == 0:
            continue
        prev = None
        for y, row in enumerate(sub):
            if depth == 16:
                raw = np.frombuffer(row.astype(">u2").tobytes(), np.uint8)
            elif depth == 8:
                raw = row.astype(np.uint8).reshape(-1)
            else:
                bits = (row.reshape(-1, 1) >> np.arange(depth - 1, -1, -1)) & 1
                raw = np.packbits(bits.reshape(-1).astype(np.uint8))
            prev = np.zeros_like(raw) if prev is None else prev
            data += _filtered(raw, prev, bpp, (y + p) % 5).tobytes()
            prev = raw
    z = zlib.compress(data)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace)))
    if palette is not None:
        out += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    out += _chunk(b"IDAT", z[:len(z) // 2]) + _chunk(b"IDAT", z[len(z) // 2:])
    with open(path, "wb") as f:
        f.write(out + _chunk(b"IEND", b""))
    return path


def _smooth(rng, shape, hi=256):
    """Seeded image-like content: a gradient plus noise, in [0, hi)."""
    h, w = shape[:2]
    ramp = np.add.outer(np.linspace(0, 0.6, h), np.linspace(0, 0.4, w))
    if len(shape) == 3:
        ramp = ramp[..., None] * np.linspace(0.5, 1.0, shape[2])
    x = ramp + 0.25 * rng.random(shape)
    return np.clip(x * hi, 0, hi - 1).astype(np.uint16 if hi > 256 else np.uint8)


def _pil(path, arr, mode=None, **kw):
    im = Image.fromarray(arr) if mode is None else Image.fromarray(arr).convert(mode)
    im.save(path, **kw)


def _palette_png(path, n_colours, rng, **kw):
    idx = rng.integers(0, n_colours, HW).astype(np.uint8)
    im = Image.fromarray(idx)
    im.putpalette(rng.integers(0, 256, 3 * n_colours).astype(np.uint8).tolist())
    im.save(path, **kw)


def _make_png(kind, path):
    rng = np.random.default_rng(zlib.crc32(kind.encode()))
    if kind == "grey8":
        cv2.imwrite(path, _smooth(rng, HW))
    elif kind == "rgb8":
        cv2.imwrite(path, _smooth(rng, HW + (3,)))
    elif kind == "rgba8":
        cv2.imwrite(path, _smooth(rng, HW + (4,)))
    elif kind == "grey16":
        cv2.imwrite(path, _smooth(rng, HW, 65536))
    elif kind == "rgb16":
        cv2.imwrite(path, _smooth(rng, HW + (3,), 65536))
    elif kind == "grey_alpha8":
        _pil(path, _smooth(rng, HW + (2,)))
    elif kind == "grey1":
        _pil(path, _smooth(rng, HW), "1")
    elif kind == "palette8":
        _palette_png(path, 200, rng)
    elif kind == "palette8_trns":
        _palette_png(path, 200, rng, transparency=3)
    elif kind == "palette4":
        _palette_png(path, 12, rng)
    elif kind in ("grey2", "grey4"):
        d = int(kind[-1])
        write_png(path, rng.integers(0, 2**d, HW), 0, d)
    elif kind == "grey16_trns":
        write_png(path, _smooth(rng, HW, 65536), 0, 16, trns=struct.pack(">H", 1000))
    elif kind == "rgb8_trns":
        write_png(path, _smooth(rng, HW + (3,)), 2, 8, trns=b"\x00\x10\x00\x20\x00\x30")
    elif kind == "grey_alpha16":
        write_png(path, _smooth(rng, HW + (2,), 65536), 4, 16)
    elif kind == "rgba16":
        write_png(path, _smooth(rng, HW + (4,), 65536), 6, 16)
    elif kind == "adam7_rgb8":
        write_png(path, _smooth(rng, HW + (3,)), 2, 8, interlace=True)
    elif kind == "adam7_rgba8":
        write_png(path, _smooth(rng, HW + (4,)), 6, 8, interlace=True)
    elif kind == "adam7_grey16":
        write_png(path, _smooth(rng, HW, 65536), 0, 16, interlace=True)
    elif kind == "adam7_grey1":
        write_png(path, rng.integers(0, 2, HW), 0, 1, interlace=True)
    elif kind == "adam7_palette4":
        pal = rng.integers(0, 256, (16, 3))
        write_png(path, rng.integers(0, 16, HW), 3, 4, interlace=True, palette=pal,
                  trns=bytes([0, 128]))
    elif kind == "adam7_tiny":   # 3 x 2: most passes are empty
        write_png(path, _smooth(rng, (3, 2, 3)), 2, 8, interlace=True)
    else:
        raise KeyError(kind)
    return path


PNG_KINDS = ("grey8", "rgb8", "rgba8", "grey16", "rgb16", "grey_alpha8", "grey1",
             "palette8", "palette8_trns", "palette4", "grey2", "grey4", "grey16_trns",
             "rgb8_trns", "grey_alpha16", "rgba16", "adam7_rgb8", "adam7_rgba8",
             "adam7_grey16", "adam7_grey1", "adam7_palette4", "adam7_tiny")


def _size_of(path):
    with Image.open(path) as im:
        return im.size[::-1]


def _against_jax(path, sizes, channels=(1, 3)):
    """Port against the JAX engine at each size, NEAREST (bit-equal) and
    CUBIC (the tolerance); returns the largest CUBIC difference."""
    jn = jax_native()
    worst = 0.0
    for size in sizes:
        for ch in channels:
            got, bits = native.decode(path, size, ch, native.NEAREST, return_bit_depth=True)
            want, jbits = jn.decode(path, size, ch, jn.NEAREST, return_bit_depth=True)
            assert bits == jbits, (path, size)
            assert got.shape == (ch,) + tuple(size) and got.dtype == np.float32
            np.testing.assert_array_equal(got, want, err_msg=f"{path} {size} {ch}")
            got = native.decode(path, size, ch, native.CUBIC)
            want = jn.decode(path, size, ch, jn.CUBIC)
            diff = float(np.abs(got - want).max())
            assert diff <= CUBIC_TOL[bits], (path, size, ch, diff)
            worst = max(worst, diff)
    return worst


@pytest.mark.parametrize("kind", PNG_KINDS)
def test_png_equal_to_the_jax_engine(tmp_path, kind):
    path = _make_png(kind, str(tmp_path / f"{kind}.png"))
    hw = _size_of(path)
    _against_jax(path, (hw, (20, 31), (64, 90)))


READ_PNG_KINDS = [k for k in PNG_KINDS if not k.startswith(("adam7", "palette", "grey1",
                                                           "grey2", "grey4"))]


@pytest.mark.parametrize("kind", READ_PNG_KINDS)
def test_png_equal_to_read_png(tmp_path, kind):
    """At its own size under NEAREST, the decode is read_png's samples with
    alpha dropped and grey replicated (one channel: the first)."""
    path = _make_png(kind, str(tmp_path / f"{kind}.png"))
    s = read_png(path)
    s = s[..., None] if s.ndim == 2 else s
    s = s[..., :1] if s.shape[-1] == 2 else s[..., :3]
    want = np.repeat(s, 3, -1) if s.shape[-1] == 1 else s
    want = np.moveaxis(want, -1, 0).astype(np.float32)
    got, bits = native.decode(path, s.shape[:2], 3, native.NEAREST, return_bit_depth=True)
    assert bits == (16 if s.dtype == np.uint16 else 8)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(native.decode(path, s.shape[:2], 1, native.NEAREST),
                                  want[:1])


def test_real_sample_pngs_equal_to_jax_and_read_png():
    """The flat l/r captures and an orbbec 16-bit depth map, at their own
    size and at the sizes the reference file holds."""
    paths = sorted(glob.glob(os.path.join(FLAT, "**", "*.png"), recursive=True))[:2]
    paths.append(os.path.join(CASUAL, "orbbec", "001", "d.png"))
    for p in paths:
        s = read_png(p)
        got = native.decode(p, s.shape[:2], 1, native.NEAREST)
        np.testing.assert_array_equal(got[0], s if s.ndim == 2 else s[..., 0])
        _against_jax(p, ((96, 144), (256, 384)), channels=(3,))


# -- JPEG files ----------------------------------------------------------------------

SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420}
JPEG_CASES = ([f"q{q}_{s}" for q in (50, 90, 98) for s in SAMPLING]
              + ["grey_q90", "q90_420_rst", "grey_q75_rst", "q90_420_tiny"])


def _make_jpeg(case, path):
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    grey = case.startswith("grey")
    # tiny: chroma planes two samples wide, which libjpeg box-upsamples
    shape = (3, 4) if case.endswith("tiny") else (45, 67)
    img = _smooth(rng, shape if grey else shape + (3,))
    q = int(case.split("_")[1 if grey else 0][1:])
    params = [cv2.IMWRITE_JPEG_QUALITY, q]
    if not grey:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[case.split("_")[1]]]
    if case.endswith("rst"):
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, 2]
    assert cv2.imwrite(path, img, params)
    return path


def _jpeg_checks(path):
    """Bit-equal to read_jpeg at its own size; against the JAX engine (its
    libjpeg) the largest difference, NEAREST at its own size and CUBIC at two
    others."""
    ref = read_jpeg(path)
    hw = ref.shape[:2]
    want = np.moveaxis(np.repeat(ref[..., None], 3, -1) if ref.ndim == 2 else ref, -1, 0)
    got, bits = native.decode(path, hw, 3, native.NEAREST, return_bit_depth=True)
    assert bits == 8
    np.testing.assert_array_equal(got, want.astype(np.float32))
    np.testing.assert_array_equal(native.decode(path, hw, 1, native.NEAREST),
                                  want[:1].astype(np.float32))
    jn = jax_native()
    worst = float(np.abs(got - jn.decode(path, hw, 3, jn.NEAREST)).max())
    for size in ((20, 31), (64, 90)):
        worst = max(worst, float(np.abs(native.decode(path, size, 3, native.CUBIC)
                                        - jn.decode(path, size, 3, jn.CUBIC)).max()))
    return worst


@pytest.mark.parametrize("case", JPEG_CASES)
def test_jpeg_equal_to_read_jpeg_and_jax(tmp_path, case):
    # measured: 0 against the JAX engine's libjpeg on every case
    assert _jpeg_checks(_make_jpeg(case, str(tmp_path / f"{case}.jpg"))) <= 1e-4


def test_jpeg_range_limit_wraparound(tmp_path):
    """Quantisation tables raised to 255 push the IDCT's outputs past the
    range limit, where libjpeg's table wraps instead of clamping: the decode
    stays bit-equal to read_jpeg."""
    _make_jpeg("q90_444", str(tmp_path / "q.jpg"))
    data = bytearray((tmp_path / "q.jpg").read_bytes())
    pos = 2
    while data[pos + 1] != 0xDA:
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if data[pos + 1] == 0xDB:
            for t in range(pos + 4, pos + 2 + length, 65):
                data[t + 1:t + 65] = b"\xff" * 64
        pos += 2 + length
    path = tmp_path / "dqt255.jpg"
    path.write_bytes(bytes(data))
    ref = read_jpeg(str(path))
    got = native.decode(str(path), ref.shape[:2], 3, native.NEAREST)
    np.testing.assert_array_equal(got, np.moveaxis(ref, -1, 0).astype(np.float32))


@pytest.mark.parametrize("path", NYU, ids=[os.path.relpath(p, ROOT) for p in NYU])
def test_committed_nyu_jpegs(path):
    assert _jpeg_checks(path) <= 1e-4


# -- load_batch -----------------------------------------------------------------------


def test_load_batch_equals_serial_decodes(tmp_path):
    """More threads than cores share the batch's index: every file is
    decoded once, into its own slot, as a serial decode gives it."""
    paths = [_make_png(k, str(tmp_path / f"{k}.png")) for k in ("rgb8", "grey16", "adam7_rgb8",
                                                               "palette4", "rgb16")]
    paths += [_make_jpeg(c, str(tmp_path / f"{c}.jpg")) for c in ("q90_420", "grey_q90")]
    paths = (paths + NYU[:2]) * 4
    threads = 2 * (os.cpu_count() or 1) + 1
    for interp in (native.NEAREST, native.CUBIC):
        got, depths = native.load_batch(paths, (24, 40), 3, interp, n_threads=threads,
                                        return_bit_depth=True)
        assert got.shape == (len(paths), 3, 24, 40) and got.dtype == np.float32
        for i, p in enumerate(paths):
            np.testing.assert_array_equal(got[i], native.decode(p, (24, 40), 3, interp))
        np.testing.assert_array_equal(depths, [8, 16, 8, 8, 16, 8, 8, 8, 8] * 4)
        one = native.load_batch(paths, (24, 40), 3, interp, n_threads=1)
        np.testing.assert_array_equal(got, one)


# -- failures -------------------------------------------------------------------------


def test_bad_files_raise_and_the_process_goes_on(tmp_path):
    png = _make_png("rgb8", str(tmp_path / "ok.png"))
    jpg = _make_jpeg("q90_420_rst", str(tmp_path / "ok.jpg"))
    bad = [str(tmp_path / "missing.png"), str(tmp_path)]
    garbage = tmp_path / "garbage.jpg"
    garbage.write_bytes(b"\xff\xd8" + bytes(np.random.default_rng(0).integers(
        0, 256, 4000, dtype=np.uint8)))
    bad.append(str(garbage))
    for src in (png, jpg):
        data = (tmp_path / os.path.basename(src)).read_bytes()
        for cut in (1, 8, 30, len(data) // 3, len(data) // 2, len(data) - 13, len(data) - 1):
            p = tmp_path / f"cut{cut}_{os.path.basename(src)}"
            p.write_bytes(data[:cut])
            bad.append(str(p))
    data = bytearray((tmp_path / "ok.png").read_bytes())
    data[len(data) // 2] ^= 0x40                      # an IDAT byte: its CRC fails
    (tmp_path / "crc.png").write_bytes(bytes(data))
    bad.append(str(tmp_path / "crc.png"))
    progressive = str(tmp_path / "progressive.jpg")
    cv2.imwrite(progressive, _smooth(np.random.default_rng(1), (45, 67, 3)),
                [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    bad.append(progressive)
    with pytest.raises(NotImplementedError):
        read_jpeg(progressive)                        # io/jpeg.py refuses it too
    for p in bad:
        with pytest.raises(IOError):
            native.decode(p, (16, 24))
    with pytest.raises(IOError, match="1 file"):
        native.load_batch([png, bad[2], jpg], (16, 24), n_threads=3)
    # the process survived and still decodes valid files
    np.testing.assert_array_equal(native.decode(png, HW, 3, native.NEAREST),
                                  np.moveaxis(read_png(png), -1, 0).astype(np.float32))
    assert np.isfinite(native.decode(jpg, (16, 24))).all()


# -- the Canon sets under the native engine ------------------------------------------------


def _items(ds, indices):
    return [[np.asarray(a) for a in ds[i]] for i in indices]


def test_canon_items_equal_to_the_jax_loader_under_native():
    from sdirt_tpu.dfdp import datasets as JD

    prev = TD._IMAGE_ENGINE, JD._IMAGE_ENGINE
    try:
        TD.set_image_engine("native")
        JD.set_image_engine("native")
        for cls, root, idx in (("CanonFlatSet", FLAT, (0, 1)),
                               ("CanonCasualSet", CASUAL, (0, 6))):
            got = _items(getattr(TD, cls)(root, resize=(256, 384)), idx)
            want = _items(getattr(JD, cls)(root, resize=(256, 384)), idx)
            for g, w in zip(got, want):
                for a, b in zip(g[:-1], w[:-1]):
                    assert a.shape == b.shape and a.dtype == np.float32
                    assert float(np.abs(a - b).max()) <= 1e-6, cls
                np.testing.assert_array_equal(g[-1], w[-1])
    finally:
        TD._IMAGE_ENGINE, JD._IMAGE_ENGINE = prev


def test_the_engine_is_part_of_the_item_cache_key(monkeypatch):
    """numpy -> native -> numpy: each read equals a fresh read under its
    engine, not an item the other engine left in the per-process cache."""
    sets = (TD.CanonCasualSet(CASUAL, resize=(128, 192)),
            TD.CanonFlatSet(FLAT, resize=(128, 192)))

    def fresh(ds, engine):
        monkeypatch.setattr(TD, "_DEPTH_ITEMS", {})
        monkeypatch.setattr(TD, "_IMAGE_ENGINE", engine)
        item = ds[0]
        monkeypatch.setattr(TD, "_DEPTH_ITEMS", cache)
        return item

    cache = {}
    monkeypatch.setattr(TD, "_DEPTH_ITEMS", cache)
    for ds in sets:
        want = {e: fresh(ds, e) for e in TD.ENGINES}
        assert not np.array_equal(want["numpy"][0], want["native"][0])
        for engine in ("numpy", "native", "numpy"):
            monkeypatch.setattr(TD, "_IMAGE_ENGINE", engine)
            for a, b in zip(ds[0], want[engine]):
                np.testing.assert_array_equal(a, b, err_msg=f"{type(ds).__name__} {engine}")


def test_native_engine_needs_a_resize(monkeypatch):
    monkeypatch.setattr(TD, "_IMAGE_ENGINE", "native")
    with pytest.raises(ValueError, match="SDIRT_IMAGE_ENGINE=native"):
        TD.CanonFlatSet(FLAT)[0]
