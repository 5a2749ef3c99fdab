"""A PNG writer on zlib and numpy, for image-like figures (the port draws
no plots: the machine with the card has no matplotlib).

Writes 8-bit grey ([H, W]) or RGB ([H, W, 3]) files, non-interlaced, every
row with filter type 0; ``dfdp/datasets.py:read_png`` reads them back
unchanged.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
_COLOUR_TYPE = {1: 0, 3: 2}           # channels -> PNG colour type


def _chunk(kind: bytes, body: bytes) -> bytes:
    crc = zlib.crc32(kind + body) & 0xFFFFFFFF
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", crc)


def to_uint8(img) -> np.ndarray:
    """Values in [0, 1] (clipped) -> uint8, rounded to nearest."""
    img = np.clip(np.nan_to_num(np.asarray(img, np.float64)), 0.0, 1.0)
    return np.round(img * 255.0).astype(np.uint8)


def write_png(path: str, img) -> str:
    """Write ``img`` (uint8 [H, W] grey or [H, W, 3] RGB; float arrays are
    taken as [0, 1] and rounded by to_uint8) to ``path``; returns path."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = to_uint8(img)
    ch = 1 if img.ndim == 2 else img.shape[-1]
    if img.ndim not in (2, 3) or ch not in _COLOUR_TYPE or 0 in img.shape[:2]:
        raise ValueError(f"write_png takes [H, W] or [H, W, 3], got {img.shape}")
    h, w = img.shape[:2]
    rows = np.ascontiguousarray(img).reshape(h, w * ch)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOUR_TYPE[ch], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIG + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + _chunk(b"IEND", b""))
    return path
