"""The PyTorch port's training data side against the JAX package on the CPU:
the numpy copies of OpenCV's blur, resize and line (sdirt_tpu_torch/dfdp/
cvops.py), the procedural SyntheticRGBD scenes of every style, the
augmentations, the real sets at a resized resolution, and the loader's
batch order.

OpenCV routes ``cv2.resize`` through Intel IPP where its build has it; IPP's
float resize moves in the last bits and depends on the CPU it dispatches
for. Bit-equality is therefore held against OpenCV's own code (IPP off), and
the default IPP path within a stated tolerance.
"""

import os

import cv2
import numpy as np
import pytest
from PIL import Image

from sdirt_tpu.dfdp import datasets as JD
from sdirt_tpu_torch.dfdp import cvops
from sdirt_tpu_torch.dfdp import datasets as TD

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STYLES = ("v1", "v2", "v3", "v4", "v5", "v6")
RES = (128, 192)


@pytest.fixture
def opencv_without_ipp():
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(was)


def _resize_cases(seed, n):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        sh, sw = (int(v) for v in rng.integers(2, 40, 2))
        s = int(rng.choice([2, 4, 8, 16]))
        dst = (int(sw * s + rng.integers(0, s)), int(sh * s + rng.integers(0, s)))
        yield rng.standard_normal((sh, sw)).astype(np.float32), dst


@pytest.mark.parametrize("interp", ["linear", "cubic"])
def test_resize_bit_equal_to_opencv(opencv_without_ipp, interp):
    flag = {"linear": cv2.INTER_LINEAR, "cubic": cv2.INTER_CUBIC}[interp]
    for img, dst in _resize_cases(0, 150):
        ref = cv2.resize(img, dst, interpolation=flag)
        assert np.array_equal(cvops.resize(img, dst, interp), ref), (img.shape, dst)


@pytest.mark.parametrize("interp", ["linear", "cubic"])
def test_resize_close_to_opencv_ipp(interp):
    flag = {"linear": cv2.INTER_LINEAR, "cubic": cv2.INTER_CUBIC}[interp]
    for img, dst in _resize_cases(1, 60):
        ref = cv2.resize(img, dst, interpolation=flag)
        # IPP's resize of N(0, 1) noise: last-bit differences, measured up to
        # 7e-6; 1e-5 bounds them
        np.testing.assert_allclose(cvops.resize(img, dst, interp), ref,
                                   rtol=0, atol=1e-5)


def test_blur_bit_equal_to_opencv():
    rng = np.random.default_rng(2)
    for _ in range(200):
        h, w = (int(v) for v in rng.integers(2, 80, 2))
        k = int(rng.integers(1, 4))
        x = rng.standard_normal((h, w)).astype(np.float32)
        assert np.array_equal(cvops.blur(x, (k, k)), cv2.blur(x, (k, k))), (h, w, k)


@pytest.mark.parametrize("thickness", [1, 2])
def test_line_bit_equal_to_opencv(thickness):
    """End points as _texture_poster draws them: inside the patch, at most
    a third of its size apart."""
    rng = np.random.default_rng(3 + thickness)
    for _ in range(1500):
        bh, bw = int(rng.integers(4, 60)), int(rng.integers(4, 60))
        x0, y0 = int(rng.integers(0, bw)), int(rng.integers(0, bh))
        x1 = int(np.clip(x0 + rng.integers(-bw // 3, bw // 3 + 1), 0, bw - 1))
        y1 = int(np.clip(y0 + rng.integers(-bh // 3, bh // 3 + 1), 0, bh - 1))
        ref = np.zeros((bh, bw), np.float32)
        got = ref.copy()
        cv2.line(ref, (x0, y0), (x1, y1), 1.0, thickness=thickness)
        cvops.line(got, (x0, y0), (x1, y1), 1.0, thickness=thickness)
        assert np.array_equal(got, ref), ((bh, bw), (x0, y0), (x1, y1))


def _items(mod, style, train, idx):
    ds = mod.SyntheticRGBD(RES, seed=0 if train else 999, train=train, style=style)
    return [ds[i] for i in idx]


@pytest.mark.parametrize("train", [True, False], ids=["train", "val"])
@pytest.mark.parametrize("style", STYLES)
def test_synthetic_items_bit_equal(opencv_without_ipp, style, train):
    for ref, got in zip(_items(JD, style, train, range(4)),
                        _items(TD, style, train, range(4))):
        for r, g in zip(ref, got):
            assert g.dtype == r.dtype and g.shape == r.shape
            assert np.array_equal(g, r)


@pytest.mark.parametrize("style", STYLES)
def test_synthetic_items_close_to_opencv_ipp(style):
    for ref, got in zip(_items(JD, style, True, range(2)),
                        _items(TD, style, True, range(2))):
        # depth never passes through OpenCV; the image's textures do: the
        # IPP resize differences, through v5/v6's colour blend, measured up
        # to 4e-6 on [0, 1] images
        assert np.array_equal(got[1], ref[1])
        np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=2e-5)


def test_synthetic_sizes_and_ranges():
    img, depth = TD.SyntheticRGBD(RES, style="v5")[0]
    assert img.shape == (3, *RES) and depth.shape == (1, *RES)
    assert img.dtype == depth.dtype == np.float32
    assert 0.0 <= img.min() and img.max() <= 1.0
    lo, hi = TD.SyntheticRGBD.DEPTH_RANGES["v5"]
    assert depth.min() >= min(lo[0], hi[0]) * 0.99 and depth.max() <= max(hi[1], lo[1])


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_auto_augment_bit_equal(seed):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (64, 80, 3)).astype(np.float32)
    depth = rng.uniform(0, 12, (64, 80)).astype(np.float32)
    depth[::7] = 0
    for trial in range(20):
        ref = JD.auto_augment(img, depth, np.random.RandomState(seed * 100 + trial))
        got = TD.auto_augment(img, depth, np.random.RandomState(seed * 100 + trial))
        for r, g in zip(ref, got):
            assert g.dtype == r.dtype and np.array_equal(g, r)
        ref = JD.photometric_augment(img, np.random.default_rng(trial))
        got = TD.photometric_augment(img, np.random.default_rng(trial))
        assert np.array_equal(got, ref)
    assert np.array_equal(TD.depth_preprocess(depth.copy()),
                          JD.depth_preprocess(depth.copy()))


class _Index:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i, rng=None):
        return [np.array([i]), np.full((2, 3), i, np.float32)]


@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_order_equal_to_jax(drop_last):
    """The port yields batches in index order whatever the worker count: the
    JAX loader's order with one worker (its threads otherwise hand batches
    over as they finish)."""
    for seed in range(4):
        ref = JD.DataLoader(_Index(23), 4, shuffle=True, num_workers=1,
                            drop_last=drop_last, seed=seed)
        got = TD.DataLoader(_Index(23), 4, shuffle=True, num_workers=4,
                            drop_last=drop_last, seed=seed)
        ref_b, got_b = list(ref), list(got)
        assert len(got) == len(ref) == len(got_b) == len(ref_b)
        for r, g in zip(ref_b, got_b):
            assert all(np.array_equal(x, y) for x, y in zip(r, g))
    concat = TD.ConcatDataset(_Index(3), _Index(4))
    assert len(concat) == 7 and concat[5][0][0] == 2
    with pytest.raises(IndexError):
        concat[7]


def test_loader_worker_exception_propagates():
    class Bad(_Index):
        def __getitem__(self, i, rng=None):
            if i == 9:
                raise ValueError("boom")
            return super().__getitem__(i, rng)

    with pytest.raises(RuntimeError, match="worker failed") as err:
        list(TD.DataLoader(Bad(20), 2, num_workers=3))
    assert isinstance(err.value.__cause__, ValueError)


def test_bicubic_resize_bit_equal_to_pil():
    rng = np.random.default_rng(4)
    for _ in range(30):
        h, w = (int(v) for v in rng.integers(5, 200, 2))
        oh, ow = (int(v) for v in rng.integers(3, 220, 2))
        img = rng.random((h, w, 3)).astype(np.float32)
        ref = JD._pil_resize(img, (oh, ow), Image.Resampling.BICUBIC)
        assert np.array_equal(TD.resize_bicubic(img, (oh, ow)), ref)


@pytest.mark.parametrize("name,folder", [("CanonDepthSet", "box"),
                                         ("CanonCasualSet", "casual"),
                                         ("CanonFlat2DepthSet", "flat"),
                                         ("CanonFlatSet", "flat")])
def test_canon_sets_resized_equal_jax(name, folder):
    """The real sets at the smoke configs' 128x192 (bicubic RGB, nearest
    depth), as --stage train and --stage full read them there."""
    path = os.path.join(ROOT, "real_sample_set", folder)
    ref = getattr(JD, name)(path, resize=RES)[0]
    got = getattr(TD, name)(path, resize=RES)[0]
    for r, g in zip(ref, got):
        assert g.dtype == r.dtype and np.array_equal(g, r)
