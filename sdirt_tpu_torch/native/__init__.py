"""The port's native (C++) decode engine: the OpenEXR decoder
(``src/sdirt_exr.cc``, a copy of the JAX package's), built with g++ at first
use and bound with ctypes (PyTorch counterpart of sdirt_tpu/native/).

  g++ -O3 -shared -fPIC -pthread -std=c++17 src/sdirt_exr.cc -lz

The library goes to ``sdirt_tpu_torch/csrc/build/`` through
utils/kernels.py:compile_all. There is no quiet fallback: ``decode_exr``
raises with the compiler's output when the library cannot be built or
loaded, and ``IOError`` for a file it cannot decode; ``available()`` says
whether the build succeeds.

The JAX engine also decodes and resizes the real captures' PNG and JPEG
views in C++ (``sdirt_loader.cc``, libjpeg + libpng). The card's machine has
zlib's header but neither ``jpeglib.h`` nor ``png.h``, so that part is not
here: the port's image decodes stay on its numpy decoders (dfdp/datasets.py,
io/jpeg.py) under either engine.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from ..utils import kernels

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src", "sdirt_exr.cc")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")
LIBS = ("-lz",)


class NativeBuildError(RuntimeError):
    """The native library could not be built or loaded."""


_lib = None
build_seconds = 0.0


def build(timeout: float = 300.0, reuse: bool = True) -> ctypes.CDLL:
    """Compile (or, with ``reuse``, load an earlier build of) the decoder and
    bind its C functions; raises NativeBuildError with g++'s output."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    import time

    t0 = time.perf_counter()
    cxx = os.environ.get("CXX", "g++")
    try:
        libs, _, _ = kernels.compile_all(
            {"sdirt_exr": (SRC, [cxx, *CXX_FLAGS, SRC, *LIBS])}, timeout, reuse)
    except (RuntimeError, OSError) as e:
        raise NativeBuildError(f"building the native EXR decoder failed: {e}") from e
    lib = libs["sdirt_exr"]
    lib.sdirt_exr_info.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
                                   ctypes.POINTER(ctypes.c_int),
                                   ctypes.POINTER(ctypes.c_int)]
    lib.sdirt_exr_info.restype = ctypes.c_int
    lib.sdirt_exr_decode.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float)]
    lib.sdirt_exr_decode.restype = ctypes.c_int
    build_seconds = time.perf_counter() - t0
    _lib = lib
    return lib


def decode_exr(path: str) -> np.ndarray:
    """A scanline EXR (NONE/ZIPS/ZIP/PIZ) -> float32 [H, W], or [H, W, C]
    with R/G/B-named channels in cv2's BGR order: io/exr.py:read_exr's
    output, bit for bit."""
    lib = build()
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if lib.sdirt_exr_info(path.encode(), ctypes.byref(h), ctypes.byref(w),
                          ctypes.byref(c)) != 0:
        raise IOError(f"native EXR header parse failed for {path}")
    out = np.empty((h.value, w.value, c.value), np.float32)
    if lib.sdirt_exr_decode(path.encode(),
                            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))) != 0:
        raise IOError(f"native EXR decode failed for {path}")
    return out[..., 0] if c.value == 1 else out


def available() -> bool:
    """Whether the library builds and loads here."""
    try:
        build()
        return True
    except NativeBuildError:
        return False
