"""The port's ``cv2`` resize engine (``SDIRT_RESIZE_ENGINE`` /
``dfdp.datasets.set_resize_engine``) against the JAX loaders under
``set_resize_engine("cv2")`` on the CPU: the committed NYU-layout tree and
the Canon sets of real_sample_set/, colour within 1e-6 and depth bit-equal;
the Canon item cache keyed by the engine; an unknown engine refused.

OpenCV builds with Intel IPP route ``resize`` through IPP, whose results
move in the last bits and depend on the CPU; the port reproduces OpenCV's
own code, so IPP is switched off around each test (and restored).
"""

import os

import cv2
import numpy as np
import pytest

from sdirt_tpu.dfdp import datasets as JD
from sdirt_tpu_torch.dfdp import cvops
from sdirt_tpu_torch.dfdp import datasets as TD

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NYU_REF = os.path.join(ROOT, "sdirt_tpu_torch", "reference", "datasets", "nyu2_train")
SAMPLES = os.path.join(ROOT, "real_sample_set")
RGB_TOL = 1e-6


@pytest.fixture(autouse=True)
def cv2_engines():
    """Both packages on the cv2 resize engine, OpenCV's IPP off; restored
    afterwards."""
    ipp = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    TD.set_resize_engine("cv2")
    JD.set_resize_engine("cv2")
    try:
        yield
    finally:
        TD.set_resize_engine("pil")
        JD.set_resize_engine("pil")
        cv2.ipp.setUseIPP(ipp)


def _assert_item(got, ref):
    """Colour within RGB_TOL, depth (the last array) bit-equal."""
    assert len(got) == len(ref)
    for j, (g, r) in enumerate(zip(got, ref)):
        g, r = np.asarray(g), np.asarray(r)
        assert g.shape == r.shape and g.dtype == r.dtype, j
        if j == len(got) - 1:
            np.testing.assert_array_equal(g, r)
        else:
            np.testing.assert_allclose(g, r, rtol=0, atol=RGB_TOL)


@pytest.mark.parametrize("src,dst", [((480, 640), (256, 384)), ((37, 53), (90, 161)),
                                     ((512, 768), (128, 192)), ((540, 960), (512, 768))])
def test_cvops_resizes_equal_cv2(src, dst):
    """INTER_CUBIC on an interleaved 3-channel float32 image and
    INTER_NEAREST on a depth map, up and down."""
    rng = np.random.default_rng(src[0] + dst[1])
    img = rng.uniform(0, 1, (*src, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        cvops.resize(img, dst[::-1], "cubic"),
        cv2.resize(img, dst[::-1], interpolation=cv2.INTER_CUBIC))
    depth = rng.uniform(0, 10, src).astype(np.float32)
    np.testing.assert_array_equal(
        cvops.resize_nearest(depth, dst[::-1]),
        cv2.resize(depth, dst[::-1], interpolation=cv2.INTER_NEAREST))


@pytest.mark.parametrize("res", [(256, 384), (512, 768)])
def test_nyu_items_match_jax_under_cv2(res):
    """The committed NYU-layout tree (640x480 JPEGs, 8-bit depth PNGs)
    resized down and up."""
    ref = JD.NYUData(NYU_REF, resize=res, train=False)
    got = TD.NYUData(NYU_REF, resize=res, train=False)
    for i in (0, 5):
        _assert_item(got[i], ref[i])


@pytest.mark.parametrize("name", ["box", "f2d", "casual"])
def test_canon_items_match_jax_under_cv2(name):
    """The Canon sets' 512x768 captures at 256x384: the l/r views by
    INTER_CUBIC, the depth by INTER_NEAREST."""
    cls, sub = {"box": ("CanonDepthSet", "box"), "f2d": ("CanonFlat2DepthSet", "flat"),
                "casual": ("CanonCasualSet", "casual")}[name]
    ref = getattr(JD, cls)(os.path.join(SAMPLES, sub), resize=(256, 384))
    got = getattr(TD, cls)(os.path.join(SAMPLES, sub), resize=(256, 384))
    for i in range(min(len(ref), 2)):
        _assert_item(got[i], ref[i])


def test_the_resize_engine_is_part_of_the_item_cache_key():
    """A process that switches the resize engine gets each engine's own
    Canon items back, not the items the other engine cached."""
    root = os.path.join(SAMPLES, "flat")
    ds = TD.CanonFlat2DepthSet(root, resize=(256, 384))
    box = TD.CanonDepthSet(os.path.join(SAMPLES, "box"), resize=(256, 384))
    cv = [box[0], ds[0]]
    TD.set_resize_engine("pil")
    pil = [box[0], ds[0]]
    TD.set_resize_engine("cv2")
    again = [box[0], ds[0]]
    for a, b, c in zip(cv, pil, again):
        assert not np.array_equal(a[0], b[0])
        for x, y in zip(a, c):
            np.testing.assert_array_equal(x, y)


def test_an_unknown_resize_engine_raises(monkeypatch):
    with pytest.raises(ValueError, match="resize engine"):
        TD.set_resize_engine("lanczos")
    monkeypatch.setattr(TD, "_RESIZE_ENGINE", "area")
    ds = TD.CanonFlatSet(os.path.join(SAMPLES, "flat"), resize=(256, 384))
    with pytest.raises(ValueError, match="SDIRT_RESIZE_ENGINE"):
        ds[0]
