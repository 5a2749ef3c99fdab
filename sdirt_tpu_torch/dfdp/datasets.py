"""Real Canon dual-pixel capture sets and a dependency-free PNG reader
(PyTorch port's counterpart of the Canon loaders in
sdirt_tpu/dfdp/datasets.py).

The card's machine has neither cv2 nor PIL, so PNGs are decoded here with
``zlib`` and numpy, reproducing what the JAX package's loaders read:

  * ``read_png``: non-interlaced PNG, 8- or 16-bit grey, grey+alpha, RGB or
    RGBA, all five scanline filters; returns the stored samples (RGB order).
  * ``load_rgb`` (``as_rgb``): as ``cv2.imread(path)`` + BGR->RGB: alpha
    dropped, grey replicated, 16-bit collapsed to 8-bit by taking the high
    byte.
  * ``load_gray`` (``as_gray``): as ``cv2.imread(path, 0)``; a colour file
    must hold grey values (R = G = B), as the bundled depth maps do.
  * ``resize_nearest``: the JAX package's default nearest resize (PIL's
    NEAREST), sample for sample.

Samples are numpy arrays in the reference's [C, H, W] layout.
"""

from __future__ import annotations

import os
import struct
import zlib
from glob import glob
from os.path import basename, dirname

import numpy as np

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
    """read_png samples -> [H, W] uint8, as cv2.imread(path, 0), for grey
    images and colour images holding grey values."""
    img = _to8(samples)
    if img.ndim == 2:
        return img
    if img.shape[-1] == 2:
        return np.ascontiguousarray(img[..., 0])
    rgb = img[..., :3]
    if not ((rgb[..., 0] == rgb[..., 1]).all() and (rgb[..., 1] == rgb[..., 2]).all()):
        raise ValueError("colour PNG read as grey holds non-grey pixels")
    return np.ascontiguousarray(rgb[..., 0])


def load_rgb(path: str) -> np.ndarray:
    return as_rgb(read_png(path))


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


def _load_rgb_chw(path, resize):
    """[3, H, W] float32 in [0, 1]. The bundled captures are stored at the
    serve resolution; a bicubic resize of other sizes comes later."""
    img = load_rgb(path)
    if resize is not None and img.shape[:2] != tuple(resize):
        raise NotImplementedError(
            f"{path} is {img.shape[:2]}, not {tuple(resize)}: bicubic resize "
            "of RGB captures is not ported yet")
    img = (img.astype(np.float64) / 255.0).astype(np.float32)
    return np.ascontiguousarray(img.transpose(2, 0, 1))


def _resize_depth(d, resize):
    return resize_nearest(np.asarray(d, np.float32), resize)


def _require_scenes(scenes, dataset_dir, cls):
    if not scenes:
        raise FileNotFoundError(f"{cls}: no scenes found under '{dataset_dir}'")
    return scenes


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
        if os.path.exists(f"{scene}/d.png"):
            return _resize_depth(load_gray(f"{scene}/d.png") / 255.0 * 10.0,
                                 self.resize)
        return np.ones(self.resize, np.float64) * 2.5

    def __getitem__(self, index):
        scene = self.scenes[index]
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

    def __getitem__(self, index):
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

    def __getitem__(self, index):
        dis_m, imgp = self.dis_l[index], self.imgp_l[index]
        f4 = self._lr(f"{imgp}/f4")
        f20 = self._lr(f"{imgp}/f20")
        depth = np.ones(self.resize, np.float32) * dis_m
        return [f4, f20, depth[None]]
