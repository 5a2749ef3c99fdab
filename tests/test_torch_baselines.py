"""The port's baseline DP-PSF models (psfnet/baselines.py) and their lookup
tables (psfnet/related_psf.py, with the numpy copies of the OpenCV calls in
dfdp/cvops.py) against the JAX package on the CPU.

Tolerances: the LUTs bit-equal; the four pred_* models within 1e-6 on the
same inputs, on both lenses.
"""

import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdirt_tpu.psfnet import baselines as jax_baselines
from sdirt_tpu.psfnet import related_psf as jax_related
from sdirt_tpu.psfnet.surrogate import PSFNetLens as JPSFNetLens
from sdirt_tpu_torch.dfdp import cvops
from sdirt_tpu_torch.psfnet import baselines, related_psf
from sdirt_tpu_torch.psfnet.surrogate import PSFNetLens

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = ("pred_coc", "pred_dpdnet", "pred_modeling", "pred_learn2reduce")


@pytest.fixture(scope="module", params=("rf50mm", "rf35mm"))
def lenses(request):
    path = os.path.join(ROOT, "lenses", request.param, "lens_web.json")
    return (PSFNetLens(path, kernel_size=21, sensor_res=(512, 768), device="cpu"),
            JPSFNetLens(path, kernel_size=21, sensor_res=(512, 768)))


@pytest.mark.parametrize("ks", [11, 21, 35])
@pytest.mark.parametrize("lut", ["rect_lut", "disk_lut", "l2r_lut"])
def test_luts_bit_equal(lut, ks):
    np.testing.assert_array_equal(getattr(related_psf, lut)(ks),
                                  getattr(jax_related, lut)(ks))


@pytest.mark.parametrize("k", [3, 7, 21, 41, 69])
def test_cv_calls_match_opencv(k):
    """The filled circle bit-equal to cv2.circle, the Gaussian blur within
    1e-12 of cv2.GaussianBlur (float64, explicit sigma)."""
    ref = np.zeros((k, k))
    cv2.circle(ref, (k // 2, k // 2), k // 2, (1, 1, 1), -1)
    got = np.zeros((k, k))
    cvops.circle_filled(got, k // 2, k // 2, k // 2, 1.0)
    np.testing.assert_array_equal(got, ref)
    rng = np.random.default_rng(k)
    img = rng.uniform(0, 1, (k + 8, k + 8))
    kg = round(k / 3) + 1
    kg += kg % 2 == 0
    sigma = 0.3 * ((kg - 1) * 0.5 - 1) + 0.8
    np.testing.assert_allclose(cvops.gaussian_blur(img, kg, sigma),
                               cv2.GaussianBlur(img, (kg, kg), sigma), rtol=0, atol=1e-12)


@pytest.mark.parametrize("model", MODELS)
def test_baselines_match_jax(lenses, model):
    """A 16 x 24 depth map spanning the working range (one row a fine sweep
    near the focus, where the CoC changes sign) through both packages."""
    lens, jlens = lenses
    rng = np.random.default_rng(0)
    inp = np.concatenate([rng.uniform(-1, 1, (16, 24, 2)),
                          rng.uniform(0, 1, (16, 24, 1))], -1).astype(np.float32)
    foc_z = float((jlens.foc_d[0] - jlens.d_min) / (jlens.d_max - jlens.d_min))
    inp[0, :, 2] = np.linspace(foc_z - 0.01, foc_z + 0.01, 24)
    ref = np.asarray(getattr(jax_baselines, model)(jlens, jnp.asarray(inp)))
    got = getattr(baselines, model)(lens, torch.from_numpy(inp))
    assert got.shape == ref.shape == (16, 24, 2, 21, 21)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    depth = inp[..., 2] * (jlens.d_max - jlens.d_min) + jlens.d_min
    ref_d = np.asarray(getattr(jax_baselines, model)(jlens, jnp.asarray(
        np.concatenate([inp[..., :2], depth[..., None]], -1)), is_z=False))
    got_d = getattr(baselines, model)(lens, torch.from_numpy(
        np.concatenate([inp[..., :2], depth[..., None]], -1)), is_z=False)
    np.testing.assert_allclose(got_d.numpy(), ref_d, rtol=0, atol=1e-6)
