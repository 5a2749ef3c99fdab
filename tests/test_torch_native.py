"""The PyTorch port's native engine (sdirt_tpu_torch/native/): its C++ EXR
decoder against the port's numpy codec (io/exr.py) and the JAX package's
build of the same source (sdirt_tpu/native), the dataset engine switch
(dfdp/datasets.py: SDIRT_IMAGE_ENGINE / set_image_engine), and the build's
failure, which raises instead of falling back. The engine's PNG/JPEG decode
and resize (src/sdirt_loader.cc, C++ against zlib alone), the counterpart of
tests/test_native_loader.py's decode, resize and thread tests, is held in
tests/test_torch_native_decode.py; both files build with g++ on the CPU, and
chip_smoke.py phase 27 checks the engine on the card's machine. No PIZ file
is in the repository, so the PIZ path is not covered
(tests/test_torch_exr.py checks the numpy codec's PIZ stages).
"""

import os

import numpy as np
import pytest

from sdirt_tpu_torch import native
from sdirt_tpu_torch.dfdp import datasets as D
from sdirt_tpu_torch.io.exr import read_exr, write_exr


def _files(tmp_path):
    """EXRs of every compression the writer has, float and half, one and
    three channels."""
    rng = np.random.default_rng(3)
    paths = []
    for comp in ("zip", "zips", "none"):
        for pixel in ("float", "half"):
            p = str(tmp_path / f"{comp}_{pixel}.exr")
            write_exr(p, (rng.random((37, 53)) * 30 - 2).astype(np.float32),
                      pixel_type=pixel, compression=comp)
            paths.append(p)
    p = str(tmp_path / "rgb.exr")
    write_exr(p, rng.random((21, 17, 3)).astype(np.float32), channel_names=["R", "G", "B"])
    return paths + [p]


def test_decode_exr_bit_equal_to_the_numpy_codec(tmp_path):
    for p in _files(tmp_path):
        got, want = native.decode_exr(p), read_exr(p)
        assert got.dtype == np.float32 and got.shape == want.shape, p
        np.testing.assert_array_equal(got, want, err_msg=p)


def test_decode_exr_bit_equal_to_the_jax_build(tmp_path):
    """The port's copy of sdirt_exr.cc, built by the port, decodes every file
    as the JAX package's build of its own copy does."""
    from sdirt_tpu import native as jax_native

    for p in _files(tmp_path):
        np.testing.assert_array_equal(native.decode_exr(p), jax_native.decode_exr(p),
                                      err_msg=p)


def test_missing_and_corrupt_files_raise(tmp_path):
    with pytest.raises(IOError):
        native.decode_exr(str(tmp_path / "missing.exr"))
    bad = tmp_path / "bad.exr"
    bad.write_bytes(b"\x76\x2f\x31\x01" + bytes(np.random.default_rng(0).integers(
        0, 256, 300, dtype=np.uint8)))
    with pytest.raises(IOError):
        native.decode_exr(str(bad))
    # the process survived and still decodes a valid file
    good = _files(tmp_path)[0]
    np.testing.assert_array_equal(native.decode_exr(good), read_exr(good))


@pytest.mark.parametrize("compiler", ["false", "no-such-compiler"])
def test_a_failing_build_raises(monkeypatch, compiler):
    """No quiet fallback: a compiler that fails, or none, raises
    NativeBuildError (with the compiler's report), and available() says so."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("CXX", compiler)
    with pytest.raises(native.NativeBuildError, match="native EXR decoder"):
        native.build(reuse=False)
    monkeypatch.setattr(native, "build", lambda: (_ for _ in ()).throw(
        native.NativeBuildError("no compiler")))
    assert not native.available()


def _ft3d(root, n=2):
    from sdirt_tpu_torch.utils.png import write_png

    rng = np.random.default_rng(7)
    for s in range(n):
        scene = root / f"{s:04d}"
        os.makedirs(scene)
        write_png(str(scene / "AiF.png"), rng.integers(0, 256, (48, 80, 3), np.uint8))
        write_exr(str(scene / "disp.exr"),
                  rng.uniform(0.4, 8.0, (48, 80)).astype(np.float32) * 20.0)
    return str(root)


@pytest.mark.parametrize("cls", ["FlyingThings3D", "MiddleburyFS"])
def test_engines_give_equal_items(tmp_path, monkeypatch, cls):
    """FlyingThings3D's and Middlebury-FS's disp.exr through the native
    engine give the numpy engine's items bit for bit."""
    root = _ft3d(tmp_path)
    make = {"FlyingThings3D": lambda: D.FlyingThings3D(root, resize=(32, 48), train=False),
            "MiddleburyFS": lambda: D.MiddleburyFS(root, resize=(32, 48))}[cls]
    items = {}
    for engine in ("numpy", "native"):
        monkeypatch.setattr(D, "_IMAGE_ENGINE", engine)
        items[engine] = [make()[i] for i in range(2)]
    for a, b in zip(items["numpy"], items["native"]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_engine_selection(monkeypatch):
    monkeypatch.setattr(D, "_IMAGE_ENGINE", "numpy")
    D.set_image_engine("native")
    assert D._IMAGE_ENGINE == "native"
    with pytest.raises(ValueError, match="image engine"):
        D.set_image_engine("cv2")
    monkeypatch.setattr(D, "_IMAGE_ENGINE", "cv2")      # as from SDIRT_IMAGE_ENGINE
    with pytest.raises(ValueError, match="SDIRT_IMAGE_ENGINE"):
        D._load_exr("any.exr")
