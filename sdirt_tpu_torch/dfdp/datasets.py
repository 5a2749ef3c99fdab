"""Real Canon dual-pixel capture sets, the RGB-D training sets (NYU,
FlyingThings3D, Middlebury), a dependency-free PNG reader, and the training
data side: augmentation, the procedural ``SyntheticRGBD`` scenes and the
threaded loader (PyTorch port's counterpart of sdirt_tpu/dfdp/datasets.py).

The card's machine has neither cv2 nor PIL, so images are decoded here with
``zlib`` and numpy (JPEG by ``io/jpeg.py``, EXR by ``io/exr.py``),
reproducing what the JAX package's loaders read:

  * ``read_png``: non-interlaced PNG, 8- or 16-bit grey, grey+alpha, RGB or
    RGBA, all five scanline filters; returns the stored samples (RGB order).
  * ``read_image``: ``read_png``, or ``io/jpeg.py:read_jpeg`` for a JPEG.
  * ``load_rgb`` (``as_rgb``): as ``cv2.imread(path)`` + BGR->RGB: alpha
    dropped, grey replicated, 16-bit collapsed to 8-bit by taking the high
    byte.
  * ``load_gray`` (``as_gray``): as ``cv2.imread(path, 0)``: alpha dropped,
    colour converted by libpng's fixed-point rule, which OpenCV asks for
    (see ``as_gray``).
  * ``resize_nearest``: the JAX package's default nearest resize (PIL's
    NEAREST), sample for sample.

Samples are numpy arrays in the reference's [C, H, W] layout. The training
side is the JAX package's numpy code, with its four OpenCV calls replaced by
``cvops`` (the same arithmetic), so a seed gives the same scenes.

The JAX loaders draw their training-mode randomness (NYU's random frame,
``auto_augment``, the focal-stack frames) from the global generators. The
port's loaders are read from worker threads, so every such item takes an
``np.random.RandomState`` of its own (``item_rng``): every set's
``__getitem__(idx, rng=None)`` takes it, and a set that draws nothing
ignores it. The ``DataLoader`` seeds it from its epoch seed and the item's
index in the loader's dataset; an item read directly without one is seeded
from its index alone. A ``RandomState`` seeded like the global one gives
the JAX loader's draws.

The image engine (``SDIRT_IMAGE_ENGINE`` / ``set_image_engine``) is
``numpy`` (the default) or ``native`` (the C++ decoders of
``sdirt_tpu_torch/native``, built with g++ against zlib alone). It applies
where the JAX package's ``native`` engine applies:

  * FlyingThings3D's and Middlebury-FS's ``disp.exr``: the C++ EXR decoder,
    bit-identical to ``io/exr.py``;
  * the Canon sets' l/r views (``_load_rgb_chw``): the C++ PNG/JPEG decode
    with the JAX engine's fused Catmull-Rom resize (not the numpy engine's
    antialiased bicubic), 16-bit files taken to their high byte, as the JAX
    engine does.

The depth PNGs and the NYU, FlyingThings3D and Middlebury colour frames stay
on the numpy decoders under either engine, as they stay on cv2 in the JAX
package. Asking for ``native`` where the library cannot be built raises.

The resize engine (``SDIRT_RESIZE_ENGINE`` / ``set_resize_engine``) is
``pil`` (the default: PIL's antialiased bicubic for colour, PIL's NEAREST
for depth, as above) or ``cv2`` (``cvops.resize``'s INTER_CUBIC, not
antialiased on a downscale, and ``cvops.resize_nearest``'s INTER_NEAREST),
the JAX package's two resize engines. An unknown engine raises.
"""

from __future__ import annotations

import os
import random
import struct
import threading
import time
import zlib
from glob import glob
from os.path import basename, dirname

import numpy as np

from ..io.exr import read_exr
from ..io.jpeg import read_jpeg
from ..utils import trace
from . import cvops

ENGINES = ("numpy", "native")
_IMAGE_ENGINE = os.environ.get("SDIRT_IMAGE_ENGINE", "numpy")
RESIZE_ENGINES = ("pil", "cv2")
_RESIZE_ENGINE = os.environ.get("SDIRT_RESIZE_ENGINE", "pil")


def set_image_engine(engine: str):
    """Select the image engine: ``numpy`` or ``native``."""
    global _IMAGE_ENGINE
    if engine not in ENGINES:
        raise ValueError(f"image engine {engine!r}: one of {ENGINES}")
    _IMAGE_ENGINE = engine


def _engine() -> str:
    if _IMAGE_ENGINE not in ENGINES:
        raise ValueError(f"SDIRT_IMAGE_ENGINE={_IMAGE_ENGINE!r}: one of {ENGINES}")
    return _IMAGE_ENGINE


def set_resize_engine(engine: str):
    """Select the resize engine: ``pil`` or ``cv2``."""
    global _RESIZE_ENGINE
    if engine not in RESIZE_ENGINES:
        raise ValueError(f"resize engine {engine!r}: one of {RESIZE_ENGINES}")
    _RESIZE_ENGINE = engine


def _resize_engine() -> str:
    if _RESIZE_ENGINE not in RESIZE_ENGINES:
        raise ValueError(f"SDIRT_RESIZE_ENGINE={_RESIZE_ENGINE!r}: one of {RESIZE_ENGINES}")
    return _RESIZE_ENGINE


def _load_exr(path):
    """A float EXR through the selected engine (both give the same bits)."""
    if _engine() == "native":
        from .. import native

        return native.decode_exr(path)
    return read_exr(path)


_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}       # colour type -> samples per pixel


def _unfilter(raw: np.ndarray, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline PNG filters. raw: [h, 1 + w*bpp] uint8 ->
    [h, w, bpp] uint8.

    Sub, Average and Paeth read the reconstructed byte one pixel to the
    left, and Up, Average and Paeth the one above, so pixel (r, j) depends
    only on (r, j-1), (r-1, j) and (r-1, j-1): the pixels of one
    anti-diagonal r + j = t are independent. The bytes are stored
    diagonal-major on a grid with a zero border row and column (cell (R, J)
    of diagonal T = R + J at ``off[T] + R``), so each of the h + w - 1 steps
    works on contiguous slices of the two previous diagonals.
    """
    ftype = raw[:, 0].astype(np.int64)
    if ftype.max(initial=0) > 4:
        raise ValueError(f"unknown PNG filter type {int(ftype.max())}")
    # rows of each filter type among rows [0, r): counts[k][r]
    counts = [np.concatenate([[0], np.cumsum(ftype == k)]) for k in range(5)]
    t = np.arange(h + w + 1)
    lo = np.maximum(0, t - w)
    size = np.minimum(h, t) - lo + 1
    off = np.concatenate([[0], np.cumsum(size)[:-1]]) - lo
    rows = np.arange(1, h + 1)[:, None]
    idx = off[rows + np.arange(1, w + 1)] + rows          # [h, w] cell index
    pix = np.dtype((np.void, bpp))                        # one pixel's bytes
    filt = np.zeros((int(size.sum()), bpp), np.uint8)
    filt.view(pix)[idx, 0] = np.ascontiguousarray(raw[:, 1:]).view(pix).reshape(h, w)
    out = np.zeros_like(filt)
    for diag in range(2, h + w + 1):
        ra, rb = max(1, diag - w), min(h, diag - 1)       # padded rows R
        n = rb - ra + 1
        cell, left = off[diag] + ra, off[diag - 1] + ra
        a = out[left:left + n].astype(np.int16)           # (R, J-1)
        b = out[left - 1:left - 1 + n].astype(np.int16)   # (R-1, J)
        kinds = [k for k in range(5) if counts[k][rb] > counts[k][ra - 1]]
        if kinds == [2]:
            pred = b
        else:
            c = out[off[diag - 2] + ra - 1:][:n].astype(np.int16)  # (R-1, J-1)
            pred = c.copy()
            if 4 in kinds:                                # Paeth
                bc, ac = b - c, a - c
                pa, pb, pc = np.abs(bc), np.abs(ac), np.abs(bc + ac)
                np.copyto(pred, b, where=pb <= pc)
                np.copyto(pred, a, where=(pa <= pb) & (pa <= pc))
            ft = ftype[ra - 1:rb, None]
            for k in kinds:
                if k == 4:
                    continue
                # None, Sub, Up, Average
                choice = (0, a, b)[k] if k < 3 else (a + b) >> 1
                np.copyto(pred, choice, where=ft == k)
        np.add(filt[cell:cell + n], pred, out=out[cell:cell + n],
               casting="unsafe")                          # mod 256
    return out.view(pix)[idx, 0].view(np.uint8).reshape(h, w, bpp)


def read_png(path: str) -> np.ndarray:
    """Decode a non-interlaced PNG to its samples: [H, W] for grey, else
    [H, W, channels] in RGB(A) order; uint8, or uint16 for 16-bit files."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{path} is not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if hdr is None:
        raise ValueError(f"{path} has no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = hdr
    if interlace or depth not in (8, 16) or ctype not in _CHANNELS:
        raise ValueError(f"{path}: unsupported PNG (bit depth {depth}, colour "
                         f"type {ctype}, interlace {interlace})")
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    img = _unfilter(raw.reshape(h, 1 + w * bpp), h, w, bpp)
    if depth == 16:
        img = img.reshape(h, w * ch, 2)
        img = (img[..., 0].astype(np.uint16) << 8) | img[..., 1]
    img = img.reshape(h, w, ch)
    return img[..., 0] if ch == 1 else img


def _to8(img):
    return (img >> 8).astype(np.uint8) if img.dtype == np.uint16 else img


def as_rgb(samples: np.ndarray) -> np.ndarray:
    """read_png samples -> [H, W, 3] uint8 RGB, as cv2.imread(path) followed
    by BGR->RGB."""
    img = _to8(samples)
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=-1)
    if img.shape[-1] == 2:                                 # grey + alpha
        return np.repeat(img[..., :1], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def as_gray(samples: np.ndarray) -> np.ndarray:
    """read_png samples -> [H, W] uint8, as cv2.imread(path, 0).

    OpenCV has libpng convert colour to grey with the weights 0.299, 0.587
    (blue the rest) in 15-bit fixed point, 9797 / 19234 / 3737, before the
    16-to-8-bit strip: truncated for 8-bit samples, rounded (+2^14) for
    16-bit ones, whose grey then keeps its high byte. Alpha is dropped."""
    if samples.ndim == 2:
        return _to8(samples)
    if samples.shape[-1] == 2:                             # grey + alpha
        return np.ascontiguousarray(_to8(samples[..., 0]))
    r, g, b = (samples[..., i].astype(np.uint32) for i in range(3))  # sums < 2^31
    wide = samples.dtype == np.uint16
    gray = (9797 * r + 19234 * g + 3737 * b + (1 << 14 if wide else 0)) >> 15
    return (gray >> 8 if wide else gray).astype(np.uint8)


def read_image(path: str) -> np.ndarray:
    """The stored samples of a PNG or a baseline JPEG (by its signature),
    colour in R, G, B order."""
    with open(path, "rb") as f:
        head = f.read(2)
    return read_jpeg(path) if head == b"\xff\xd8" else read_png(path)


def load_rgb(path: str) -> np.ndarray:
    return as_rgb(read_image(path))


def load_gray(path: str) -> np.ndarray:
    return as_gray(read_png(path))


def _pil_nearest_index(n_in: int, n_out: int) -> np.ndarray:
    """PIL's NEAREST scale: source coordinate scale*(i + 0.5), accumulated in
    double as Pillow does, truncated."""
    scale = n_in / n_out
    steps = np.full(n_out, scale)
    steps[0] = scale * 0.5
    return np.minimum(np.add.accumulate(steps).astype(np.int64), n_in - 1)


def resize_nearest(img: np.ndarray, hw) -> np.ndarray:
    """Nearest resize of [H, W] or [H, W, C] to hw = (H', W'), as PIL's
    NEAREST."""
    h, w = hw
    rows = _pil_nearest_index(img.shape[0], h)
    cols = _pil_nearest_index(img.shape[1], w)
    return img[rows][:, cols]


def _bicubic(x):
    """PIL's bicubic filter (a = -0.5)."""
    x = np.abs(x)
    a = -0.5
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _pil_coeffs(n_in: int, n_out: int):
    """PIL's resampling taps along one axis: (first source index [n_out],
    float64 weights [n_out, taps]), the support scaled by the downscale
    ratio and the weights normalised per output sample."""
    scale = n_in / n_out
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(n_out) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64), n_in) - xmin
    x = np.arange(ksize)
    k = _bicubic((x[None] + xmin[:, None] - center[:, None] + 0.5) / filterscale)
    k = np.where(x[None] < xmax[:, None], k, 0.0)
    ww = k.sum(1, keepdims=True)
    return xmin, np.where(ww != 0.0, k / np.where(ww != 0.0, ww, 1.0), k)


def _pil_pass(img, n_out: int, axis: int):
    """One PIL resampling pass of a float32 array along ``axis``: taps
    summed in float64 in order, stored as float32."""
    img = np.moveaxis(img, axis, 0)
    xmin, k = _pil_coeffs(img.shape[0], n_out)
    acc = np.zeros((n_out,) + img.shape[1:], np.float64)
    shape = (n_out,) + (1,) * (img.ndim - 1)
    for t in range(k.shape[1]):
        src = img[np.minimum(xmin + t, img.shape[0] - 1)].astype(np.float64)
        acc += src * k[:, t].reshape(shape)
    return np.moveaxis(acc.astype(np.float32), 0, axis)


def resize_bicubic(img: np.ndarray, hw) -> np.ndarray:
    """Antialiased bicubic resize of a float32 [H, W(, C)] array to
    hw = (H', W'), as PIL's 'F'-mode BICUBIC resize channel by channel (the
    JAX package's default resize engine): horizontal pass, then vertical."""
    h, w = hw
    if img.shape[:2] == (h, w):
        return img.copy()
    out = img.astype(np.float32)
    if out.shape[1] != w:
        out = _pil_pass(out, w, 1)
    if out.shape[0] != h:
        out = _pil_pass(out, h, 0)
    return out


def _load_rgb_chw(path, resize):
    """[3, H, W] float32 in [0, 1], bicubic-resized to ``resize``: under the
    numpy engine decoded by ``load_rgb`` and resized by ``resize_bicubic``;
    under ``native`` decoded and Catmull-Rom-resized in C++, 16-bit files
    floored to their high byte (sdirt_tpu/dfdp/datasets.py:82-95)."""
    if _engine() == "native":
        from .. import native

        if resize is None:
            raise ValueError("SDIRT_IMAGE_ENGINE=native reads the Canon views at a "
                             "resize (H, W); this set has none")
        img, bits = native.decode(path, resize, channels=3, interp=native.CUBIC,
                                  return_bit_depth=True)
        if bits == 16:
            img = np.floor(img / 256.0)
        return img.clip(0, 255) / np.float32(255.0)
    img = (load_rgb(path).astype(np.float64) / 255.0).astype(np.float32)
    if resize is not None:
        return _resize_rgb(img, resize)
    return np.ascontiguousarray(img.transpose(2, 0, 1))


def _resize_depth(d, resize):
    """Nearest resize under the selected resize engine."""
    d = np.asarray(d, np.float32)
    if _resize_engine() == "cv2":
        return cvops.resize_nearest(d, resize[::-1])
    return resize_nearest(d, resize)


def _resize_rgb(img, resize):
    """float32 [H, W, 3] -> bicubic-resized [3, H', W'] float32 under the
    selected resize engine."""
    img = np.asarray(img, np.float32)
    if _resize_engine() == "cv2":
        return _chw(cvops.resize(img, resize[::-1], "cubic"))
    return _chw(resize_bicubic(img, resize))


def item_rng(seed: int, index: int) -> np.random.RandomState:
    """The generator of one training item's draws, from a loader's epoch
    seed and the item's index."""
    return np.random.RandomState((seed * 1_000_003 + index) % 2**32)


def _require_scenes(scenes, dataset_dir, cls):
    if not scenes:
        raise FileNotFoundError(f"{cls}: no scenes found under '{dataset_dir}'")
    return scenes


# The Canon depth sets are decoded once per process: a box scene's d.png is
# a 24-MP RGBA PNG that read_png takes seconds to decode, and training
# evaluates the box set every epoch. Items are kept per resolution, image
# engine and resize engine (each resizes the l/r views differently), the
# full-size box depth across them; the keys hold the files' sizes and
# mtimes, so a rewritten file is read again.
_DEPTH_ITEMS: dict = {}
_BOX_DEPTHS: dict = {}
_KEPT_LOCK = threading.Lock()


def _kept(cache, cap, key, load):
    value = cache.get(key)
    if value is None:
        value = load()
        with _KEPT_LOCK:
            if len(cache) >= cap:
                del cache[next(iter(cache))]
            cache[key] = value
    return value


def _stamp(path):
    st = os.stat(path)
    return path, st.st_size, st.st_mtime_ns


class CanonDepthSet:
    """Scenes of l/r DP pngs + d.png depth (box set)."""

    def __init__(self, dataset_dir, resize=None):
        self.scenes = _require_scenes(sorted(glob(f"{dataset_dir}/*")),
                                      dataset_dir, type(self).__name__)
        self.resize = resize
        self.file_type = glob(f"{self.scenes[0]}/l.*")[0].split(".")[-1]

    def __len__(self):
        return len(self.scenes)

    def _load_lr(self, scene):
        return np.concatenate(
            [_load_rgb_chw(f"{scene}/l.{self.file_type}", self.resize),
             _load_rgb_chw(f"{scene}/r.{self.file_type}", self.resize)], 0)

    def _raw_depth(self, scene):
        path = f"{scene}/d.png"
        if os.path.exists(path):
            gray = _kept(_BOX_DEPTHS, 16, _stamp(path), lambda: load_gray(path))
            return _resize_depth(gray / 255.0 * 10.0, self.resize)
        return np.ones(self.resize, np.float64) * 2.5

    def __getitem__(self, index, rng=None):
        scene = self.scenes[index]
        key = (type(self).__name__, None if self.resize is None else tuple(self.resize),
               _engine(), _resize_engine(),
               *sorted(_stamp(e.path) for e in os.scandir(scene) if e.is_file()))
        return [a.copy() for a in _kept(_DEPTH_ITEMS, 64, key, lambda: self._item(scene))]

    def _item(self, scene):
        depth = self._raw_depth(scene)
        img = self._load_lr(scene)
        depth[depth < 0] = 0
        depth[depth >= 10] = 0
        return [img, _resize_depth(depth.astype(np.float32), self.resize)[None]]


class CanonCasualSet(CanonDepthSet):
    """iphone/orbbec depth-sensor scenes."""

    def __init__(self, dataset_dir, resize=None):
        self.scenes = _require_scenes(sorted(glob(f"{dataset_dir}/*/*")),
                                      dataset_dir, type(self).__name__)
        self.resize = resize
        self.file_type = glob(f"{self.scenes[0]}/l.*")[0].split(".")[-1]

    def _raw_depth(self, scene):
        if "iphone" in scene:
            depth = load_gray(f"{scene}/d.png") / 255.0 * 10.0
        else:   # orbbec: 16-bit millimetres
            depth = read_png(f"{scene}/d.png") / 1000.0
        return _resize_depth(depth, self.resize)


class CanonFlat2DepthSet:
    """Flat-wall F/4 captures with known plane depth from the folder name."""

    def __init__(self, dataset_dir, resize=None):
        img_paths = _require_scenes(
            sorted(glob(f"{dataset_dir}/**/f4/l.*", recursive=True)),
            dataset_dir, type(self).__name__)
        self.file_type = img_paths[0].split(".")[-1]
        self.resize = resize
        self.dis_l, self.imgp_l = [], []
        for p in img_paths:
            dis_str = basename(dirname(dirname(p)))
            if "inf" in dis_str:
                continue
            self.dis_l.append(float(dis_str) / 1000.0)
            self.imgp_l.append(dirname(dirname(p)))

    def __len__(self):
        return len(self.imgp_l)

    def _lr(self, folder):
        return np.concatenate(
            [_load_rgb_chw(f"{folder}/l.{self.file_type}", self.resize),
             _load_rgb_chw(f"{folder}/r.{self.file_type}", self.resize)], 0)

    def __getitem__(self, index, rng=None):
        dis_m, imgp = self.dis_l[index], self.imgp_l[index]
        f4 = self._lr(f"{imgp}/f4")
        depth = np.ones(self.resize, np.float32) * dis_m
        return [f4, depth[None]]


class CanonFlatSet(CanonFlat2DepthSet):
    """F/4 + F/20 pairs for the DP-simulation fidelity score; 'inf' scenes
    are placed at 100 m."""

    def __init__(self, dataset_dir, resize=None):
        img_paths = _require_scenes(
            sorted(glob(f"{dataset_dir}/**/f4/l.*", recursive=True)),
            dataset_dir, type(self).__name__)
        self.file_type = img_paths[0].split(".")[-1]
        self.resize = resize
        self.dis_l, self.imgp_l = [], []
        for p in img_paths:
            dis_str = basename(dirname(dirname(p)))
            dis = 100000.0 if "inf" in dis_str else float(dis_str)
            self.dis_l.append(dis / 1000.0)
            self.imgp_l.append(dirname(dirname(p)))

    def __getitem__(self, index, rng=None):
        dis_m, imgp = self.dis_l[index], self.imgp_l[index]
        f4 = self._lr(f"{imgp}/f4")
        f20 = self._lr(f"{imgp}/f20")
        depth = np.ones(self.resize, np.float32) * dis_m
        return [f4, f20, depth[None]]


def _chw(img):
    return np.ascontiguousarray(img.transpose(2, 0, 1).astype(np.float32))


def auto_augment(img, depth, rng=None):
    """Photometric + geometric augmentation (reference dataset.py:246-306)."""
    rng = np.random if rng is None else rng
    if rng.rand() > 0.5:
        contrast = rng.uniform(0.75, 1.25)
        brightness = rng.uniform(-0.25, 0.25)
        img = np.clip(contrast * img + brightness, 0.0, 1.0)
    if rng.rand() > 0.5:
        gamma = rng.uniform(1, 2) if rng.rand() > 0.5 else rng.uniform(0.5, 1)
        img = img**gamma
    if rng.rand() > 0.5:
        img, depth = np.flip(img, 1), np.flip(depth, 1)
    if rng.rand() > 0.75:
        img, depth = np.flip(img, 0), np.flip(depth, 0)
    if rng.rand() > 0.5:
        limit = 20
        shift = rng.randint(0, limit)
        h, w = img.shape[:2]
        img = img[shift:h - (limit - shift), shift:w - (limit - shift)]
        depth = depth[shift:h - (limit - shift), shift:w - (limit - shift)]
    if rng.rand() > 0.5:
        depth = depth * rng.uniform(0.25, 1.25)
    return img, depth


def photometric_augment(img, rng):
    """The photometric half of auto_augment (contrast/brightness/gamma,
    reference dataset.py:249-258) for generated scenes: SyntheticRGBD
    already randomizes layout/texture/depth, but its procedural palette is
    narrower than real exposures — this closes the synthetic->real
    photometric gap. Geometric crop (shape-changing under fixed-shape jit)
    and the depth-scale jitter (would leave the style's curated
    discriminable-disparity band) are deliberately excluded."""
    if rng.random() > 0.5:
        contrast = rng.uniform(0.75, 1.25)
        brightness = rng.uniform(-0.25, 0.25)
        img = np.clip(contrast * img + brightness, 0.0, 1.0)
    if rng.random() > 0.5:
        gamma = rng.uniform(1, 2) if rng.random() > 0.5 else rng.uniform(0.5, 1)
        img = img**gamma
    return img


def depth_preprocess(depth):
    """Clip working range to 0.25-10 m, keep empty pixels 0
    (reference dataset.py:308-315)."""
    mark = depth * 1.0
    depth = np.clip(depth, 0.25, 10)
    depth[mark <= 0] = 0
    return depth


class NYUData:
    """NYUv2-style folders of (jpg rgb, png depth * 25.5) pairs, cropped by
    20 pixels. Virtual length 2000 with a random frame per item in train
    mode (``rng.randint``, then ``auto_augment``), 50 in eval mode."""

    scale = 25.5
    crop = 20

    def __init__(self, rgb_path, resize=None, train=True):
        self.resize = resize
        self.train = train
        self.imgs, self.depths = [], []
        for scene in glob(f"{rgb_path}/*"):
            self.imgs += sorted(glob(f"{scene}/*.jpg"))
            self.depths += sorted(glob(f"{scene}/*.png"))

    def __len__(self):
        return 2000 if self.train else 50

    def __getitem__(self, idx, rng=None):
        if self.train:
            rng = item_rng(0, idx) if rng is None else rng
            idx = rng.randint(0, len(self.imgs))
        try:
            aif = load_rgb(self.imgs[idx]) / 255.0
            depth = read_png(self.depths[idx]) / self.scale
            h, w, _ = aif.shape
            c = self.crop
            aif = aif[c:h - c, c:w - c]
            depth = depth[c:h - c, c:w - c]
            assert depth[depth > 0].any()
        except Exception:
            return self.__getitem__((idx + 1) % len(self.imgs), rng)
        if self.train:
            aif, depth = auto_augment(aif, depth, rng)
        depth = depth_preprocess(depth)
        return [_resize_rgb(aif.astype(np.float32), self.resize),
                _resize_depth(depth.astype(np.float32), self.resize)[None]]


class FlyingThings3D:
    """Scenes of AiF.png + disp.exr / 20. With fs_num > 0 an item is a
    random focal stack of the pre-rendered frames ``<focus>.png`` (read in
    cv2's B, G, R order, as the JAX loader reads them), the depth and the
    focus distances; the frames are drawn by ``random.Random.sample``
    seeded from the item's generator."""

    DEPTH_FACTOR = 20.0

    def __init__(self, dataset_dir, resize=None, train=True, fs_num=0):
        self.dataset_dir = dataset_dir
        self.scenes = [s.split("/")[-1] for s in glob(f"{dataset_dir}/*")]
        self.resize = resize
        self.train = train
        self.fs_num = fs_num

    def __len__(self):
        return len(self.scenes) if self.train else min(50, len(self.scenes))

    def __getitem__(self, index, rng=None):
        rng = item_rng(0, index) if rng is None else rng
        scene = f"{self.dataset_dir}/{self.scenes[index]}"
        depth = _load_exr(f"{scene}/disp.exr") / self.DEPTH_FACTOR
        depth = _resize_depth(depth, self.resize)

        if self.fs_num > 0:
            stack_paths = sorted(glob(f"{scene}/*.png"))[:-1]
            pick = random.Random(rng.randint(0, 2**31 - 1))
            chosen = pick.sample(stack_paths, self.fs_num)
            frames, dists = [], []
            for path in chosen:
                dists.append(float(path.split("/")[-1][:-4]) / self.DEPTH_FACTOR)
                bgr = load_rgb(path)[..., ::-1].astype(np.float32) / 255.0
                frames.append(_resize_rgb(bgr, self.resize))
            return [np.stack(frames), depth.astype(np.float32)[None],
                    np.asarray(dists, np.float32)]

        aif = load_rgb(f"{scene}/AiF.png") / 255.0
        if self.train:
            aif, depth = auto_augment(aif, depth, rng)
        depth = depth_preprocess(depth)
        return [_resize_rgb(aif.astype(np.float32), self.resize),
                _resize_depth(depth.astype(np.float32), self.resize)[None]]


class Middlebury:
    """Scenes of im0.png + depth.png (16-bit millimetres) / 1000."""

    def __init__(self, dataset_dir, resize=None, train=False):
        self.dataset_dir = dataset_dir
        self.scenes = sorted(s.split("/")[-1] for s in glob(f"{dataset_dir}/*"))
        self.resize = resize

    def __len__(self):
        return len(self.scenes)

    def _aif(self, scene):
        return load_rgb(f"{self.dataset_dir}/{scene}/im0.png") / 255.0

    def _depth(self, scene):
        return read_png(f"{self.dataset_dir}/{scene}/depth.png") / 1000.0

    def __getitem__(self, index, rng=None):
        scene = self.scenes[index]
        depth = self._depth(scene)
        aif = self._aif(scene)
        return [_resize_rgb(aif.astype(np.float32), self.resize),
                _resize_depth(depth.astype(np.float32), self.resize)[None]]


class MiddleburyFS(Middlebury):
    """Scenes of AiF.png + disp.exr / 10, negative depths set to 0."""

    def _aif(self, scene):
        return load_rgb(f"{self.dataset_dir}/{scene}/AiF.png") / 255.0

    def _depth(self, scene):
        depth = _load_exr(f"{self.dataset_dir}/{scene}/disp.exr") / 10.0
        depth[depth < 0] = 0
        return depth


class ConcatDataset:
    """The sets one after another. An item's generator (see ``item_rng``)
    is handed to the set that serves it."""

    def __init__(self, *datasets):
        self.datasets = list(datasets)
        self._lens = [len(d) for d in self.datasets]

    def __len__(self):
        return sum(self._lens)

    def __getitem__(self, idx, rng=None):
        for d, n in zip(self.datasets, self._lens):
            if idx < n:
                return d.__getitem__(idx, rng)
            idx -= n
        raise IndexError


class Subset:
    """The items ``indices`` of ``dataset``, each read by its index there
    (a set cut to a few items for a short run)."""

    def __init__(self, dataset, indices):
        self.dataset, self.indices = dataset, list(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i, rng=None):
        return self.dataset.__getitem__(self.indices[i], rng)


class _WorkerError:
    """Exception sentinel handed from a worker to the consumer."""

    def __init__(self, exc):
        self.exc = exc


class DataLoader:
    """Thread-pool prefetching batch loader. The index order is the JAX
    package's (stdlib ``random.Random(seed)`` shuffle), and batches are
    yielded in that order whatever thread finishes first: worker w builds
    batches w, w + n, ..., at most ``2 * num_workers`` ahead of the
    consumer. A worker's exception is raised in the consumer. Item j is
    read as ``dataset.__getitem__(j, item_rng(seed, j))``.

    shard=(index, count): yield only slice ``index`` of ``count`` equal
    slices of every batch (a data-parallel rank's share, parallel/mesh.py):
    every rank builds the same order from the seed, so the ranks together
    read exactly the unsharded loader's batches. Needs drop_last and a
    batch size that divides by count."""

    def __init__(self, dataset, batch_size=1, shuffle=False, num_workers=4,
                 drop_last=False, seed=0, shard=None):
        if shard is not None and (not drop_last or batch_size % shard[1]):
            raise ValueError(f"shard {shard} needs drop_last and a batch size "
                             f"that divides by {shard[1]}, got {batch_size}")
        self.shard = shard
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.seed = seed
        self.rng = random.Random(seed)

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self):
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            self.rng.shuffle(idx)
        batches = [idx[i:i + self.batch_size] for i in range(0, len(idx), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        if self.shard is not None:
            index, count = self.shard
            per = self.batch_size // count
            batches = [b[index * per:(index + 1) * per] for b in batches]

        ahead = 2 * self.num_workers
        cond = threading.Condition()
        ready: dict = {}
        consumed = [0]
        stop = threading.Event()

        def work(worker_ids):
            for i in worker_ids:
                with cond:
                    cond.wait_for(lambda: stop.is_set() or i < consumed[0] + ahead)
                if stop.is_set():
                    return
                wall, cpu = time.perf_counter_ns(), time.thread_time_ns()
                try:
                    samples = [self.dataset.__getitem__(j, item_rng(self.seed, j))
                               for j in batches[i]]
                    item = [np.stack([s[k] for s in samples])
                            for k in range(len(samples[0]))]
                except BaseException as exc:  # noqa: BLE001 - re-raised below
                    item = _WorkerError(exc)
                else:
                    trace.count("loader.batches")
                    trace.count("loader.work_wall_s",
                                (time.perf_counter_ns() - wall) / 1e9)
                    trace.count("loader.work_cpu_s",
                                (time.thread_time_ns() - cpu) / 1e9)
                with cond:
                    ready[i] = item
                    cond.notify_all()
                if isinstance(item, _WorkerError):
                    return

        ids = list(range(len(batches)))
        threads = [threading.Thread(target=work, args=(ids[w::self.num_workers],),
                                    daemon=True) for w in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            for i in ids:
                with cond:
                    with trace.span("loader.wait"):
                        cond.wait_for(lambda: i in ready)
                    item = ready.pop(i)
                    consumed[0] = i + 1
                    cond.notify_all()
                if isinstance(item, _WorkerError):
                    raise RuntimeError("DataLoader worker failed") from item.exc
                yield item
        finally:
            stop.set()
            with cond:
                cond.notify_all()
            for t in threads:
                t.join(timeout=0.1)


class SyntheticRGBD:
    """Procedural RGB-D scenes (colored rectangles over a background plane at
    random depths). Not in the reference — enables training/integration tests
    without external datasets; the directory-based sets above remain the
    production path.

    style 'v1': textured rectangles (round-1/2 generator).
    style 'v2': depth-from-defocus-oriented scenes — multi-scale texture
    octaves, more and smaller occluders (ellipses + rects) with sharp
    boundaries, and log-uniform depth biased toward the resolvable
    near-focus range (defocus changes fastest near the 1 m focus plane, so
    uniform-depth scenes spend most pixels where blur is depth-insensitive).
    style 'v3': v2 scenes with depths confined to the near band
    (occluders 0.4–3.5 m, background 0.8–3.5 m). Rationale: the rf50mm @
    1 m-focus DP disparity spans ~2.4 px below 2 m but only ~0.14 px from
    5 m to 9 m (scripts/dp_disparity_probe.py) — v2's far-field pixels are
    physically unresolvable and dominate the loss, so a v2-trained net
    converges to a near-constant predictor. v3 keeps every pixel inside the
    discriminable disparity range, matching where the reference's DP119
    results live (BASELINE.md: planar/box scenes at 0.5–2 m).
    style 'v4': v3 scenes with NON-fronto-parallel geometry — slanted
    planar occluders and background (linear depth gradients) plus curved
    (spherical-cap) surfaces. v1-v3 surfaces are all constant-depth, but the
    real evaluation sets are not: the box set is dominated by slanted faces
    and the casual set by smooth depth variation; a net trained only on
    piecewise-constant depth has never seen an in-surface depth gradient.
    style 'v5': composition realism modeled on the bundled real eval sets
    (65% new compositions + 35% v4 items for continuity). New: (a) a
    perspective GROUND plane — depth falls as 1/(y - horizon), the dominant
    structure of every casual capture and the tabletop of the box set;
    (b) CUBOID primitives — a fronto-ish front face plus a receding top
    face sharing the front-top edge (the box set is stacked cartons, whose
    top faces sweep ~the full near depth band within a few dozen rows);
    (c) full-height POLES with cylindrical curvature; (d) MULTI-COLOR
    textures (2-3 colors blended through smoothed noise masks, then octave
    detail) — the poster-covered real surfaces carry color structure the
    single-base-color v2 texture never produces.
    style 'v6': box-set-targeted iteration on v5 (the one real scene still
    under its round-3 target). The box captures are close-range STACKS of
    cartons wrapped in printed poster art in front of a poster-collage
    pinboard wall, on a grid-printed tablecloth. v6 adds what v5's
    statistics miss: (a) PICTORIAL poster textures — smooth multi-stop
    color gradients, soft shapes and thin dark strokes (line-art/text) with
    border frames, instead of noise-blob color fields; (b) GRID textures
    (thin grout/print lines over jittered cells) for the tablecloth — also
    the dominant texture of the casual set's tiled surfaces; (c) a
    box-stack composition: 3-7 near-range cuboids (0.4–2 m, the measured
    box-set depth band) over a poster-collage wall and gridded ground.
    Mix: 50% box-stack + 30% v5 compositions + 20% v4 continuity items.
    """

    DEPTH_RANGES = {          # (occluder lo/hi, background lo/hi), meters
        "v2": ((0.35, 9.0), (1.5, 9.0)),
        "v3": ((0.4, 3.5), (0.8, 3.5)),
        "v4": ((0.4, 3.5), (0.8, 3.5)),
        # v5 extends the BACKGROUND band to 5 m: the casual captures hold
        # true depths past 3.5 m, and a net whose training vocabulary caps
        # at 3.5 m can never score acc1 there (5 m truth needs >=4.0
        # predicted). F/4 disparity still moves ~0.15 px over 3.5-5 m
        # (scripts/dp_disparity_probe.py) — weak signal beats a guaranteed
        # miss. Occluders stay in the strongly discriminable 0.4-3.5 band,
        # so near-field learning is not diluted (the v2 far-field lesson).
        "v5": ((0.4, 3.5), (0.8, 5.0)),
        # v6 keeps the v5 bands; the box-stack items bias their cuboids
        # into 0.4-2 m (real box GT spans 0.47-2 m, scripts note in
        # RESULTS.md round 4).
        "v6": ((0.4, 3.5), (0.8, 5.0)),
    }

    def __init__(self, resize, length: int = 64, seed: int = 0, train=True,
                 style: str = "v1"):
        self.resize = resize
        self.length = length
        self.seed = seed
        self.train = train
        assert style in ("v1", "v2", "v3", "v4", "v5", "v6"), style
        self.style = style

    def __len__(self):
        return self.length

    @staticmethod
    def _texture(rng, bh, bw, base):
        """Textured patch around a base color: defocus carries depth
        information only where the image has spatial frequency content, so
        every surface gets one of several high-frequency patterns."""
        yy, xx = np.mgrid[0:bh, 0:bw].astype(np.float32)
        kind = rng.integers(0, 4)
        if kind == 0:      # band-limited noise (smoothed)
            t = rng.normal(0, 1, (bh, bw)).astype(np.float32)
            k = max(1, int(rng.integers(1, 4)))
            t = cvops.blur(t, (k, k))
            t /= max(np.abs(t).max(), 1e-6)
        elif kind == 1:    # oriented stripes
            f = rng.uniform(0.2, 1.2)
            th = rng.uniform(0, np.pi)
            t = np.sin(f * (xx * np.cos(th) + yy * np.sin(th)))
        elif kind == 2:    # checkerboard
            p = rng.integers(3, 12)
            t = (((xx // p) + (yy // p)) % 2).astype(np.float32) * 2 - 1
        else:              # smooth gradient (low-frequency control case)
            t = (xx / max(bw - 1, 1) + yy / max(bh - 1, 1)) - 1
        amp = rng.uniform(0.1, 0.4)
        patch = base[None, None] * (1.0 + amp * t[..., None])
        return np.clip(patch, 0.0, 1.0).astype(np.float32)

    @staticmethod
    def _texture_v2(rng, bh, bw, base):
        """2-3 octaves of band-limited noise + optional stripes; stronger
        amplitude than v1 so defocus is observable everywhere. Coarse octaves
        are synthesized at low resolution and upsampled (loader-thread CPU
        budget: this runs per occluder per sample)."""
        acc = rng.standard_normal((bh, bw), dtype=np.float32)
        acc /= max(np.abs(acc).max(), 1e-6)
        for s in rng.choice([2, 4, 8], size=rng.integers(1, 3), replace=False):
            sh, sw = max(2, bh // s), max(2, bw // s)
            t = rng.standard_normal((sh, sw), dtype=np.float32)
            t = cvops.resize(t, (bw, bh), "linear")
            acc += t / max(np.abs(t).max(), 1e-6)
        if rng.random() > 0.5:
            yy, xx = np.mgrid[0:bh, 0:bw].astype(np.float32)
            f, th = rng.uniform(0.3, 1.5), rng.uniform(0, np.pi)
            acc += np.sin(f * (xx * np.cos(th) + yy * np.sin(th)))
        acc /= max(np.abs(acc).max(), 1e-6)
        amp = rng.uniform(0.25, 0.6)
        patch = base[None, None] * (1.0 + amp * acc[..., None])
        return np.clip(patch, 0.02, 1.0).astype(np.float32)

    @staticmethod
    def _log_uniform_depth(rng, lo=0.35, hi=9.0):
        return float(np.exp(rng.uniform(np.log(lo), np.log(hi))))

    @staticmethod
    def _depth_field_v4(rng, d0, yy, xx, h, w, lo, hi):
        """Full-frame per-pixel depth for one v4 surface around base d0:
        35% fronto-parallel, 40% slanted plane (linear in-image gradient up
        to ~±60% of d0 across the frame), 25% spherical-cap bulge. Clipped
        to the style's discriminable band so no pixel leaves the usable
        DP-disparity range."""
        mode = rng.random()
        if mode < 0.35:
            return np.full((h, w), d0, np.float32)
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        u = (xx - cx).astype(np.float32) / w
        v = (yy - cy).astype(np.float32) / h
        if mode < 0.75:
            gx, gy = rng.uniform(-0.6, 0.6, 2)
            d = d0 * (1.0 + gx * u + gy * v)
        else:
            a = rng.uniform(-0.4, 0.4)
            d = d0 * (1.0 + a * np.exp(-4.0 * (u * u + v * v)))
        return np.clip(d, lo, hi).astype(np.float32)

    @staticmethod
    def _texture_v5(rng, bh, bw):
        """Multi-color texture: 2-3 random colors blended through smoothed
        low-res noise masks (soft-max weights -> coherent color regions with
        sharp-ish boundaries, poster-like), then one fine luminance octave."""
        n = int(rng.integers(2, 4))
        cols = rng.uniform(0.05, 0.95, (n, 3)).astype(np.float32)
        masks = np.empty((n, bh, bw), np.float32)
        for i in range(n):
            s = int(rng.choice([4, 8, 16]))
            m = rng.standard_normal(
                (max(2, bh // s), max(2, bw // s))).astype(np.float32)
            masks[i] = cvops.resize(m, (bw, bh), "cubic")
        sharp = np.float32(rng.uniform(2.0, 6.0))
        wts = np.exp(sharp * (masks - masks.max(0, keepdims=True)))
        wts /= wts.sum(0, keepdims=True)
        img = np.einsum("nhw,nc->hwc", wts, cols)
        det = rng.standard_normal((bh, bw), dtype=np.float32)
        k = int(rng.integers(1, 4))
        det = cvops.blur(det, (k, k))
        det /= max(np.abs(det).max(), 1e-6)
        img = img * (1.0 + rng.uniform(0.08, 0.35) * det[..., None])
        return np.clip(img, 0.02, 1.0).astype(np.float32)

    @staticmethod
    def _texture_poster(rng, bh, bw):
        """Pictorial 'poster art' texture: a smooth two-color gradient field
        (sky-like), a few filled shapes, thin dark strokes (line-art /
        text-like glyph strokes) and usually a border frame. These are the
        statistics of the printed art wrapping every box-set carton — large
        smooth gradients and stroke-scale detail that the noise-blob
        `_texture_v5` never produces."""
        yy, xx = np.mgrid[0:bh, 0:bw].astype(np.float32)
        u = xx / max(bw - 1, 1)
        v = yy / max(bh - 1, 1)
        c0, c1 = rng.uniform(0.15, 0.95, (2, 3)).astype(np.float32)
        if rng.random() < 0.5:      # linear gradient, random direction
            th = rng.uniform(0, 2 * np.pi)
            t = (u - 0.5) * np.cos(th) + (v - 0.5) * np.sin(th) + 0.5
        else:                       # radial (sunburst / vignette)
            cy, cx = rng.uniform(0.2, 0.8), rng.uniform(0.2, 0.8)
            t = np.sqrt((u - cx) ** 2 + (v - cy) ** 2) * rng.uniform(1.0, 2.0)
        t = np.clip(t, 0.0, 1.0)[..., None]
        img = c0 * (1.0 - t) + c1 * t
        for _ in range(int(rng.integers(1, 5))):   # filled shapes
            col = rng.uniform(0.05, 0.95, 3).astype(np.float32)
            cy, cx = rng.uniform(0, bh), rng.uniform(0, bw)
            ry = max(rng.uniform(bh / 12, bh / 3), 1.0)
            rx = max(rng.uniform(bw / 12, bw / 3), 1.0)
            m = (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0)
            a = np.float32(rng.uniform(0.5, 1.0))
            mask = m[..., None].astype(np.float32) * a
            img = img * (1.0 - mask) + col * mask
        stroke = np.zeros((bh, bw), np.float32)    # line-art / text strokes
        for _ in range(int(rng.integers(4, 14))):
            x0, y0 = int(rng.integers(0, bw)), int(rng.integers(0, bh))
            x1 = int(np.clip(x0 + rng.integers(-bw // 3, bw // 3 + 1),
                             0, bw - 1))
            y1 = int(np.clip(y0 + rng.integers(-bh // 3, bh // 3 + 1),
                             0, bh - 1))
            cvops.line(stroke, (x0, y0), (x1, y1), 1.0,
                    thickness=int(rng.integers(1, 3)))
        img = img * (1.0 - np.float32(rng.uniform(0.3, 0.85))
                     * stroke[..., None])
        if rng.random() < 0.6 and bh > 8 and bw > 8:   # border frame
            bpx = int(rng.integers(1, max(min(bh, bw) // 20, 2) + 1))
            col = (rng.uniform(0.6, 1.0, 3) if rng.random() < 0.7
                   else rng.uniform(0.0, 0.25, 3)).astype(np.float32)
            img[:bpx], img[-bpx:] = col, col
            img[:, :bpx], img[:, -bpx:] = col, col
        return np.clip(img, 0.02, 1.0).astype(np.float32)

    @staticmethod
    def _texture_grid(rng, bh, bw):
        """Regular grid of thin dark grout/print lines over a base color
        with per-cell luminance jitter — the box set's gridded tablecloth
        and the casual set's tiled walls/ledges."""
        base = rng.uniform(0.25, 0.85, 3).astype(np.float32)
        py = int(rng.integers(max(bh // 24, 6), max(bh // 6, 8)))
        px = int(rng.integers(max(bw // 24, 6), max(bw // 6, 8)))
        yy, xx = np.mgrid[0:bh, 0:bw]
        cell = ((yy // py) * 7919 + (xx // px) * 104729) % 97
        jit = (cell.astype(np.float32) / 96.0 - 0.5) * rng.uniform(0.05, 0.25)
        img = base[None, None] * (1.0 + jit[..., None])
        t = int(rng.integers(1, 3))
        line = ((yy % py) < t) | ((xx % px) < t)
        img = np.where(line[..., None],
                       img * (1.0 - np.float32(rng.uniform(0.3, 0.7))), img)
        return np.clip(img, 0.02, 1.0).astype(np.float32)

    def _pick_tex(self, rng, bh, bw, color):
        """v5 surfaces draw mostly multi-color textures, some v2 ones; v6
        adds pictorial posters to the mix (box-set statistics)."""
        if self.style == "v6":
            r = rng.random()
            if r < 0.40:
                return self._texture_poster(rng, bh, bw)
            if r < 0.75:
                return self._texture_v5(rng, bh, bw)
            return self._texture_v2(rng, bh, bw, color)
        if rng.random() < 0.7:
            return self._texture_v5(rng, bh, bw)
        return self._texture_v2(rng, bh, bw, color)

    @staticmethod
    def _ground_depth(rng, h, w, lo, hi):
        """Perspective ground plane: horizon at a random row, depth falls
        as 1/(y - y_h) below it (flat floor under a level camera), scaled
        so the bottom edge sits at a random near depth. Returns (depth
        field [h,w] valid below the horizon, horizon row)."""
        y_h = rng.uniform(0.2, 0.6) * h
        d_near = rng.uniform(0.4, 1.0)
        d_far = rng.uniform(1.8, float(hi))
        yy = np.arange(h, dtype=np.float32)[:, None]
        t = np.maximum(yy - y_h, 1e-3)
        # 1/t profile through (bottom -> d_near), clipped at d_far
        d = d_near * (h - y_h) / t
        d = np.clip(d, lo, d_far).astype(np.float32)
        return np.broadcast_to(d, (h, w)).copy(), int(round(y_h))

    def _draw_cuboid(self, rng, img, depth, yy, xx, h, w, lo, hi):
        """Front face (fronto-ish slant) + receding top face sharing the
        front-top edge; optionally a receding side face. Depths clipped to
        the discriminable band."""
        bw_ = int(rng.integers(w // 8, w // 2))
        bh_ = int(rng.integers(h // 8, h // 2))
        x0 = int(rng.integers(0, max(w - bw_, 1)))
        y0 = int(rng.integers(0, max(h - bh_, 1)))
        d_f = self._log_uniform_depth(rng, lo, hi * 0.8)
        # front face: mild slant (real cartons are a few degrees off)
        gx, gy = rng.uniform(-0.12, 0.12, 2)
        u = (xx[y0:y0 + bh_, x0:x0 + bw_] - x0).astype(np.float32) / max(bw_, 1)
        v = (yy[y0:y0 + bh_, x0:x0 + bw_] - y0).astype(np.float32) / max(bh_, 1)
        dfront = np.clip(d_f * (1 + gx * u + gy * v), lo, hi)
        img[y0:y0 + bh_, x0:x0 + bw_] = self._pick_tex(
            rng, bh_, bw_, rng.uniform(0.1, 0.95, 3).astype(np.float32))
        depth[y0:y0 + bh_, x0:x0 + bw_] = dfront
        # top face: thin band above the front-top edge, receding fast
        if y0 > 4 and rng.random() < 0.8:
            th = int(rng.integers(3, max(min(y0, bh_ // 2), 4)))
            yt = y0 - th
            ext = rng.uniform(0.15, 0.7)   # how far back the box reaches
            vt = (y0 - yy[yt:y0, x0:x0 + bw_]).astype(np.float32) / max(th, 1)
            dtop = np.clip(d_f * (1 + ext * vt), lo, hi)
            tex = self._pick_tex(rng, th, bw_,
                                 rng.uniform(0.1, 0.95, 3).astype(np.float32))
            img[yt:y0, x0:x0 + bw_] = tex * rng.uniform(0.75, 1.0)
            depth[yt:y0, x0:x0 + bw_] = dtop

    def _draw_pole(self, rng, img, depth, h, w, lo, hi):
        """Full-height vertical pole with cylindrical depth curvature."""
        pw = int(rng.integers(max(w // 24, 4), w // 6))
        x0 = int(rng.integers(0, max(w - pw, 1)))
        d0 = self._log_uniform_depth(rng, lo, 2.0)
        u = (np.arange(pw, dtype=np.float32) / max(pw - 1, 1)) * 2 - 1
        bulge = 1.0 - 0.06 * (1.0 - u * u)       # nearer at the centerline
        dcol = np.clip(d0 * bulge, lo, hi).astype(np.float32)
        img[:, x0:x0 + pw] = self._pick_tex(
            rng, h, pw, rng.uniform(0.1, 0.9, 3).astype(np.float32))
        depth[:, x0:x0 + pw] = dcol[None, :]

    def _item_v5(self, rng, h, w):
        (occ_lo, occ_hi), (bg_lo, bg_hi) = self.DEPTH_RANGES["v5"]
        yy, xx = np.mgrid[0:h, 0:w]
        # background wall (fronto or mildly slanted, multi-color texture)
        d_bg = self._log_uniform_depth(rng, max(bg_lo, 1.2), bg_hi)
        depth = self._depth_field_v4(rng, d_bg, yy, xx, h, w, bg_lo, bg_hi)
        img = self._pick_tex(rng, h, w, rng.uniform(0.2, 0.8, 3).astype(np.float32))
        # ground plane over the lower frame (85% of scenes)
        if rng.random() < 0.85:
            gd, y_h = self._ground_depth(rng, h, w, occ_lo, bg_hi)
            gtex = self._pick_tex(rng, h, w,
                                  rng.uniform(0.2, 0.8, 3).astype(np.float32))
            band = yy >= y_h
            img[band] = gtex[band]
            depth[band] = gd[band]
        # cuboids (box-set look) and classic v4 occluders, interleaved
        for _ in range(int(rng.integers(4, 12))):
            if rng.random() < 0.55:
                self._draw_cuboid(rng, img, depth, yy, xx, h, w, occ_lo, occ_hi)
            else:
                color = rng.uniform(0.1, 0.95, 3).astype(np.float32)
                d = self._log_uniform_depth(rng, occ_lo, occ_hi)
                dfield = self._depth_field_v4(rng, d, yy, xx, h, w,
                                              occ_lo, occ_hi)
                cy, cx = rng.integers(0, h), rng.integers(0, w)
                ry = rng.integers(h // 24 + 2, h // 3)
                rx = rng.integers(w // 24 + 2, w // 3)
                mask = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
                if not mask.any():
                    continue
                y0, y1 = yy[mask].min(), yy[mask].max() + 1
                x0, x1 = xx[mask].min(), xx[mask].max() + 1
                tex = self._pick_tex(rng, y1 - y0, x1 - x0, color)
                sub = mask[y0:y1, x0:x1]
                img[y0:y1, x0:x1][sub] = tex[sub]
                depth[mask] = dfield[mask]
        # poles last: they occlude everything (casual-set look, 35%)
        for _ in range(int(rng.integers(0, 3)) if rng.random() < 0.35 else 0):
            self._draw_pole(rng, img, depth, h, w, occ_lo, occ_hi)
        return img, depth.astype(np.float32)

    def _item_v6(self, rng, h, w):
        """Box-stack composition (the real box set, scene for scene): a
        poster-collage pinboard wall, a gridded tablecloth ground, and a
        stack of near-range cuboids (0.4–2 m) whose faces carry pictorial
        poster textures."""
        (occ_lo, occ_hi), (bg_lo, bg_hi) = self.DEPTH_RANGES["v6"]
        yy, xx = np.mgrid[0:h, 0:w]
        # collage wall: base texture + pinned poster rectangles
        d_bg = self._log_uniform_depth(rng, max(bg_lo, 1.5), bg_hi)
        depth = self._depth_field_v4(rng, d_bg, yy, xx, h, w, bg_lo, bg_hi)
        img = self._pick_tex(rng, h, w,
                             rng.uniform(0.2, 0.8, 3).astype(np.float32))
        for _ in range(int(rng.integers(5, 12))):
            ph = int(rng.integers(h // 10, h // 3))
            pw_ = int(rng.integers(w // 10, w // 3))
            y0 = int(rng.integers(0, max(h - ph, 1)))
            x0 = int(rng.integers(0, max(w - pw_, 1)))
            img[y0:y0 + ph, x0:x0 + pw_] = self._texture_poster(rng, ph, pw_)
        # gridded tabletop over the lower frame
        if rng.random() < 0.9:
            gd, y_h = self._ground_depth(rng, h, w, occ_lo, bg_hi)
            gtex = self._texture_grid(rng, h, w)
            band = yy >= y_h
            img[band] = gtex[band]
            depth[band] = gd[band]
        # the stack: cuboids confined to the measured box-set depth band
        for _ in range(int(rng.integers(3, 8))):
            self._draw_cuboid(rng, img, depth, yy, xx, h, w, occ_lo,
                              min(occ_hi, 2.5))
        return img, depth.astype(np.float32)

    def _item_v2(self, rng, h, w):
        (occ_lo, occ_hi), (bg_lo, bg_hi) = self.DEPTH_RANGES[self.style]
        v4 = self.style in ("v4", "v5")   # v5's continuity items are v4-style
        bg = rng.uniform(0.2, 0.8, 3).astype(np.float32)
        img = self._texture_v2(rng, h, w, bg)
        yy, xx = np.mgrid[0:h, 0:w]
        d_bg = self._log_uniform_depth(rng, bg_lo, bg_hi)
        if v4:
            depth = self._depth_field_v4(rng, d_bg, yy, xx, h, w, bg_lo, bg_hi)
        else:
            depth = np.full((h, w), d_bg, np.float32)
        for _ in range(rng.integers(8, 21)):
            color = rng.uniform(0.1, 0.95, 3).astype(np.float32)
            d = self._log_uniform_depth(rng, occ_lo, occ_hi)
            dfield = (self._depth_field_v4(rng, d, yy, xx, h, w, occ_lo, occ_hi)
                      if v4 else None)
            if rng.random() > 0.45:      # ellipse (curved occlusion boundary)
                cy, cx = rng.integers(0, h), rng.integers(0, w)
                ry = rng.integers(h // 24 + 2, h // 3)
                rx = rng.integers(w // 24 + 2, w // 3)
                mask = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
                if not mask.any():
                    continue
                y0, y1 = yy[mask].min(), yy[mask].max() + 1
                x0, x1 = xx[mask].min(), xx[mask].max() + 1
                tex = self._texture_v2(rng, y1 - y0, x1 - x0, color)
                sub = mask[y0:y1, x0:x1]
                img[y0:y1, x0:x1][sub] = tex[sub]
                depth[mask] = dfield[mask] if v4 else d
            else:                        # rectangle
                x0, y0 = rng.integers(0, w - 8), rng.integers(0, h - 8)
                bw = min(int(rng.integers(8, w // 2)), w - x0)
                bh = min(int(rng.integers(8, h // 2)), h - y0)
                img[y0:y0 + bh, x0:x0 + bw] = self._texture_v2(rng, bh, bw, color)
                depth[y0:y0 + bh, x0:x0 + bw] = (
                    dfield[y0:y0 + bh, x0:x0 + bw] if v4 else d)
        return img, depth

    def __getitem__(self, idx, rng=None):
        rng = np.random.default_rng(self.seed * 100003 + idx)
        h, w = self.resize
        if self.style == "v6":
            r = rng.random()
            if r < 0.50:
                img, depth = self._item_v6(rng, h, w)
            elif r < 0.80:
                img, depth = self._item_v5(rng, h, w)
            else:
                img, depth = self._item_v2(rng, h, w)
        elif self.style == "v5":
            if rng.random() < 0.65:
                img, depth = self._item_v5(rng, h, w)
            else:
                img, depth = self._item_v2(rng, h, w)
        elif self.style in ("v2", "v3", "v4"):
            img, depth = self._item_v2(rng, h, w)
        else:
            bg = rng.uniform(0.25, 0.75, 3).astype(np.float32)
            img = self._texture(rng, h, w, bg)
            depth = np.full((h, w), rng.uniform(2.0, 9.0), np.float32)
            for _ in range(rng.integers(4, 9)):
                x0, y0 = rng.integers(0, w - 8), rng.integers(0, h - 8)
                bw, bh = rng.integers(8, w // 2), rng.integers(8, h // 2)
                bh = min(bh, h - y0)
                bw = min(bw, w - x0)
                color = rng.uniform(0.1, 0.9, 3).astype(np.float32)
                d = rng.uniform(0.3, 8.0)
                img[y0:y0 + bh, x0:x0 + bw] = self._texture(rng, bh, bw, color)
                depth[y0:y0 + bh, x0:x0 + bw] = d
        if self.train:
            img = photometric_augment(img, rng).astype(np.float32)
        img = img + rng.standard_normal(img.shape, dtype=np.float32) * np.float32(0.015)
        img = np.clip(img, 0, 1)
        return [_chw(img), depth[None]]
