"""The PyTorch port's PNG reader, nearest resize and Canon sample sets
against cv2, PIL and the JAX package's loaders (sdirt_tpu_torch/dfdp/datasets.py).

Every file of real_sample_set/ must decode bit-equal to cv2; the filters the
bundled files do not use (None, Average) are exercised on synthetic PNGs.
"""

import glob
import os
import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from sdirt_tpu_torch.dfdp import datasets as TD

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLES = sorted(glob.glob(os.path.join(ROOT, "real_sample_set", "**", "*.png"),
                           recursive=True))


def _cv2_unchanged_rgb(path, grey_alpha=False):
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if grey_alpha:          # cv2 expands grey+alpha to BGRA
        return img[..., [0, 3]]
    if img.ndim == 3:
        img = img[..., [2, 1, 0, 3]] if img.shape[-1] == 4 else img[..., ::-1]
    return img


@pytest.mark.parametrize("path", SAMPLES,
                         ids=[os.path.relpath(p, ROOT) for p in SAMPLES])
def test_png_reader_bit_equal_to_cv2(path):
    samples = TD.read_png(path)
    assert np.array_equal(samples, _cv2_unchanged_rgb(path))
    assert np.array_equal(TD.as_rgb(samples), cv2.imread(path)[..., ::-1])
    if os.path.basename(path) == "d.png":
        assert np.array_equal(TD.as_gray(samples), cv2.imread(path, 0))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _encode_png(samples, ctype, depth):
    """A PNG whose scanlines cycle through filter types 0..4."""
    h, w = samples.shape[:2]
    ch = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
    dt = ">u2" if depth == 16 else np.uint8
    rows = samples.astype(dt).reshape(h, w * ch).view(np.uint8).astype(np.int32)
    bpp = ch * depth // 8
    out = []
    prev = np.zeros_like(rows[0])
    for r in range(h):
        x, ft = rows[r], r % 5
        left = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        pred = [0, left, prev, (left + prev) // 2, _paeth(left, prev, upleft)][ft]
        out.append(np.concatenate([[ft], (x - pred) % 256]).astype(np.uint8))
        prev = x

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xffffffff))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(np.concatenate(out).tobytes()))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("ctype,depth", [(0, 8), (0, 16), (2, 8), (2, 16),
                                         (4, 8), (6, 8), (6, 16)])
def test_png_reader_all_filters(tmp_path, ctype, depth):
    ch = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
    rng = np.random.default_rng(ctype * 100 + depth)
    shape = (23, 17) if ch == 1 else (23, 17, ch)
    samples = rng.integers(0, 2**depth, shape)
    path = str(tmp_path / "t.png")
    with open(path, "wb") as f:
        f.write(_encode_png(samples, ctype, depth))
    got = TD.read_png(path)
    np.testing.assert_array_equal(got, samples)
    np.testing.assert_array_equal(got, _cv2_unchanged_rgb(path, ctype == 4))
    np.testing.assert_array_equal(TD.load_rgb(path), cv2.imread(path)[..., ::-1])


SIZES = [((4000, 6000), (512, 768)), ((512, 768), (512, 768)),
         ((37, 53), (16, 24)), ((16, 24), (37, 53)), ((480, 640), (512, 768))]


@pytest.mark.parametrize("src,dst", SIZES, ids=[f"{s}to{d}" for s, d in SIZES])
def test_resize_nearest_matches_pil_and_cv2(src, dst):
    img = np.random.default_rng(0).uniform(0, 10, src).astype(np.float32)
    pil = np.array(Image.fromarray(img).resize(dst[::-1],
                                               Image.Resampling.NEAREST))
    np.testing.assert_array_equal(TD.resize_nearest(img, dst), pil)
    # cv2's INTER_NEAREST rule, floor(i * n_in / n_out), on the same gather
    rows, cols = (np.minimum(np.floor(np.arange(o) * (i / o)).astype(np.int64),
                             i - 1) for i, o in zip(src, dst))
    cv = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_NEAREST)
    np.testing.assert_array_equal(img[rows][:, cols], cv)


@pytest.mark.parametrize("name", ["flat", "box", "f2d", "casual"])
def test_canon_sets_equal_jax_loaders(name):
    from sdirt_tpu.dfdp import datasets as JD

    res = (512, 768)
    root = os.path.join(ROOT, "real_sample_set")
    make = {"flat": ("CanonFlatSet", "flat"), "box": ("CanonDepthSet", "box"),
            "f2d": ("CanonFlat2DepthSet", "flat"),
            "casual": ("CanonCasualSet", "casual")}[name]
    ours = getattr(TD, make[0])(os.path.join(root, make[1]), resize=res)
    ref = getattr(JD, make[0])(os.path.join(root, make[1]), resize=res)
    assert len(ours) == len(ref) > 0
    for i in range(len(ref)):
        for a, b in zip(ours[i], ref[i], strict=True):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
