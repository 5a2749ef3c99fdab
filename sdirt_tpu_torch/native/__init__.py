"""The port's native (C++) decode engine, built with g++ at first use and
bound with ctypes (PyTorch counterpart of sdirt_tpu/native/):

  * ``src/sdirt_loader.cc``: threaded PNG/JPEG decode with the JAX engine's
    streaming Catmull-Rom / nearest resize (``decode``, ``load_batch``). It
    links zlib alone: PNG is parsed, inflated and unfiltered there, and JPEG
    is a C++ translation of io/jpeg.py (baseline and extended-sequential
    Huffman, equal to it sample for sample; progressive, arithmetic-coded,
    12-bit and CMYK files are refused, as io/jpeg.py refuses them).
  * ``src/sdirt_exr.cc``: the OpenEXR decoder, a copy of the JAX package's
    (``decode_exr``).

  g++ -O3 -march=native -shared -fPIC -pthread -std=c++17 src/<source>.cc -lz

``-march=native`` is the JAX package's own flag (sdirt_tpu/native/Makefile):
with it g++ contracts the resize's tap sums into FMAs as it does there, and
the resize equals the JAX engine's bit for bit; without it the two differ by
up to ~2e-4 on 8-bit samples. Both libraries go to
``sdirt_tpu_torch/csrc/build/`` through utils/kernels.py:compile_all, in
parallel. There is no quiet fallback: a
failed build raises ``NativeBuildError`` with the compiler's output, and a
file that cannot be decoded (missing, corrupt, truncated or refused) raises
``IOError``; ``available()`` says whether the build succeeds. The ctypes
calls release the GIL, so reader threads decode in parallel.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from ..utils import kernels

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
SOURCES = {name: os.path.join(_SRC, f"{name}.cc") for name in ("sdirt_exr", "sdirt_loader")}
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-pthread", "-std=c++17")
LIBS = ("-lz",)

NEAREST = 0
CUBIC = 1


class NativeBuildError(RuntimeError):
    """The native library could not be built or loaded."""


# {"sdirt_exr": CDLL, "sdirt_loader": CDLL} once built
_lib = None
build_seconds = 0.0

_FLOATS = ctypes.POINTER(ctypes.c_float)
_INT = ctypes.c_int
_SIGNATURES = {
    "sdirt_exr": {
        "sdirt_exr_info": [ctypes.c_char_p, ctypes.POINTER(_INT), ctypes.POINTER(_INT),
                           ctypes.POINTER(_INT)],
        "sdirt_exr_decode": [ctypes.c_char_p, _FLOATS]},
    "sdirt_loader": {
        "sdirt_decode_resize": [ctypes.c_char_p, _FLOATS, _INT, _INT, _INT, _INT],
        "sdirt_load_batch": [ctypes.POINTER(ctypes.c_char_p), _INT, _FLOATS, _INT, _INT,
                             _INT, _INT, _INT, ctypes.POINTER(_INT)]}}


def build(timeout: float = 300.0, reuse: bool = True) -> dict:
    """Compile (or, with ``reuse``, load an earlier build of) both libraries
    and bind their C functions; raises NativeBuildError with g++'s output."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    import time

    t0 = time.perf_counter()
    cxx = os.environ.get("CXX", "g++")
    try:
        libs, _, _ = kernels.compile_all(
            {name: (src, [cxx, *CXX_FLAGS, src, *LIBS]) for name, src in SOURCES.items()},
            timeout, reuse)
    except (RuntimeError, OSError) as e:
        raise NativeBuildError("building the native EXR decoder and PNG/JPEG loader "
                               f"failed: {e}") from e
    for name, functions in _SIGNATURES.items():
        for fn, argtypes in functions.items():
            getattr(libs[name], fn).argtypes = argtypes
            getattr(libs[name], fn).restype = _INT
    build_seconds = time.perf_counter() - t0
    _lib = libs
    return libs


def decode(path: str, resize, channels: int = 3, interp: int = CUBIC,
           return_bit_depth: bool = False):
    """Decode one PNG/JPEG and resize it to ``resize`` = (H, W): float32
    [C, H, W] raw sample values (8-bit: 0..255; 16-bit PNG: 0..65535). With
    ``return_bit_depth`` also the source's bit depth, 8 or 16, so that the
    caller can normalise."""
    lib = build()["sdirt_loader"]
    th, tw = resize
    out = np.empty((channels, th, tw), np.float32)
    rc = lib.sdirt_decode_resize(path.encode(), out.ctypes.data_as(_FLOATS), th, tw,
                                 channels, interp)
    if rc < 0:
        raise IOError(f"native decode failed for {path}")
    if return_bit_depth:
        return out, 16 if rc == 1 else 8
    return out


def load_batch(paths, resize, channels: int = 3, interp: int = CUBIC,
               n_threads: int | None = None, return_bit_depth: bool = False):
    """Decode and resize a batch on ``n_threads`` C++ threads (default: the
    CPU count): float32 [N, C, H, W] raw sample values, each equal to
    ``decode``'s; with ``return_bit_depth`` also a uint8 [N] array of the
    files' bit depths (8 or 16)."""
    if n_threads is None:
        n_threads = os.cpu_count() or 1
    lib = build()["sdirt_loader"]
    th, tw = resize
    n = len(paths)
    out = np.empty((n, channels, th, tw), np.float32)
    names = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    bit16 = (_INT * n)()
    rc = lib.sdirt_load_batch(names, n, out.ctypes.data_as(_FLOATS), th, tw, channels,
                              interp, n_threads, bit16)
    if rc != 0:
        raise IOError(f"native batch decode: {-rc} file(s) failed")
    if return_bit_depth:
        depths = np.where(np.frombuffer(bit16, np.int32) == 1, 16, 8).astype(np.uint8)
        return out, depths
    return out


def decode_exr(path: str) -> np.ndarray:
    """A scanline EXR (NONE/ZIPS/ZIP/PIZ) -> float32 [H, W], or [H, W, C]
    with R/G/B-named channels in cv2's BGR order: io/exr.py:read_exr's
    output, bit for bit."""
    lib = build()["sdirt_exr"]
    h, w, c = _INT(), _INT(), _INT()
    if lib.sdirt_exr_info(path.encode(), ctypes.byref(h), ctypes.byref(w),
                          ctypes.byref(c)) != 0:
        raise IOError(f"native EXR header parse failed for {path}")
    out = np.empty((h.value, w.value, c.value), np.float32)
    if lib.sdirt_exr_decode(path.encode(), out.ctypes.data_as(_FLOATS)) != 0:
        raise IOError(f"native EXR decode failed for {path}")
    return out[..., 0] if c.value == 1 else out


def available() -> bool:
    """Whether the libraries build and load here."""
    try:
        build()
        return True
    except NativeBuildError:
        return False
