"""The port's baseline JPEG decoder (sdirt_tpu_torch/io/jpeg.py) against
``cv2.imread`` on files that OpenCV writes: bit-equal at qualities 50, 75,
95 and 100, sampling 4:2:0, 4:2:2 and 4:4:4, grey, with a restart
interval, at 37x53 and 480x640 (and at shapes whose chroma is one or two
samples wide). Files the decoder does not take raise NotImplementedError
naming the file.
"""

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from sdirt_tpu_torch.dfdp.datasets import load_rgb, read_image  # noqa: E402
from sdirt_tpu_torch.io.jpeg import read_jpeg  # noqa: E402

SAMPLING = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444}


def _image(h, w, seed=0):
    """Smooth colour ramps plus noise: every coefficient range occurs."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w]
    base = np.stack([np.sin(x / 7.0) * 90 + 120, np.cos(y / 5.0) * 80 + 120,
                     (x + y) % 256], -1)
    return np.clip(base + rng.normal(0, 30, (h, w, 3)), 0, 255).astype(np.uint8)


def _write(path, h, w, quality, kind):
    img = _image(h, w, seed=quality)
    params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    if kind == "grey":
        img = img[..., 1]
    elif kind == "restart":
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, 3]
    else:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[kind]]
    assert cv2.imwrite(path, img, params)
    return path


@pytest.mark.parametrize("kind", ["420", "422", "444", "grey", "restart"])
@pytest.mark.parametrize("quality", [50, 75, 95, 100])
@pytest.mark.parametrize("hw", [(37, 53), (480, 640)])
def test_decode_bit_equal_to_cv2(tmp_path, hw, quality, kind):
    path = _write(str(tmp_path / "t.jpg"), *hw, quality, kind)
    got = read_jpeg(path)
    if kind == "grey":
        assert got.shape == hw
        np.testing.assert_array_equal(got, cv2.imread(path, cv2.IMREAD_GRAYSCALE))
    else:
        assert got.shape == (*hw, 3)
    np.testing.assert_array_equal(load_rgb(path), cv2.imread(path)[..., ::-1])


@pytest.mark.parametrize("hw", [(1, 1), (9, 3), (17, 4)])
@pytest.mark.parametrize("kind", ["420", "422"])
def test_narrow_chroma_bit_equal(tmp_path, hw, kind):
    """Chroma one or two samples wide: libjpeg replicates instead of the
    triangle filter."""
    path = _write(str(tmp_path / "t.jpg"), *hw, 90, kind)
    np.testing.assert_array_equal(load_rgb(path), cv2.imread(path)[..., ::-1])


def test_read_image_dispatches(tmp_path):
    jpg = _write(str(tmp_path / "t.jpg"), 16, 24, 80, "420")
    png = str(tmp_path / "t.png")
    assert cv2.imwrite(png, _image(16, 24))
    np.testing.assert_array_equal(read_image(jpg), read_jpeg(jpg))
    np.testing.assert_array_equal(read_image(png), cv2.imread(png)[..., ::-1])


def test_progressive_raises(tmp_path):
    path = str(tmp_path / "p.jpg")
    assert cv2.imwrite(path, _image(32, 48), [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with pytest.raises(NotImplementedError, match="p.jpg.*progressive"):
        read_jpeg(path)


def _patched(tmp_path, name, edit):
    """A baseline file with its frame header edited by ``edit(data, at)``,
    ``at`` the SOF0 marker's offset."""
    data = bytearray(open(_write(str(tmp_path / "b.jpg"), 16, 16, 90, "420"), "rb").read())
    edit(data, data.index(b"\xff\xc0"))
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(bytes(data))
    return path


@pytest.mark.parametrize("name,edit,what", [
    ("arith.jpg", lambda d, at: d.__setitem__(at + 1, 0xC9), "arithmetic"),
    ("twelve.jpg", lambda d, at: d.__setitem__(at + 4, 12), "12-bit"),
    ("cmyk.jpg", lambda d, at: d.__setitem__(at + 9, 4), "4-component")])
def test_unsupported_files_raise(tmp_path, name, edit, what):
    with pytest.raises(NotImplementedError, match=f"{name}.*{what}"):
        read_jpeg(_patched(tmp_path, name, edit))
