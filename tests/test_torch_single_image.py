"""The port's single-image render (render/perpixel.py: psf_map_conv,
render_single_image) against the JAX package on the CPU. The JAX render
draws its pupil samples from a key; the test draws the same samples with the
JAX sampler (one key per wavelength, split into the chief and the main
bundle, as compute_psf_rgb and dp_psf split it) and hands them to the port.

The render is held against the JAX package run op by op
(``jax.disable_jit()``): its jitted run rounds the f32 trace otherwise and
is itself 1.1e-4 to 1.3e-4 (max) from its op-by-op run at this size, where
the port is within 6.1e-5 of the op-by-op run.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdirt_tpu.core.constants import GEO_SPP
from sdirt_tpu.dp import psf as jax_psf
from sdirt_tpu.dp.psf import lens_scalars as jax_lens_scalars
from sdirt_tpu.optics.lens import Lens as JLens
from sdirt_tpu.optics.sampling import sample_disk as jax_sample_disk
from sdirt_tpu.render.perpixel import psf_map_conv as jax_psf_map_conv
from sdirt_tpu.render.perpixel import render_single_image as jax_render_single_image
from sdirt_tpu_torch.optics.lens import Lens
from sdirt_tpu_torch.render.perpixel import psf_map_conv, render_single_image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RF50 = os.path.join(ROOT, "lenses", "rf50mm", "lens_web.json")
SPP = 256
GRID = 3
DEPTH = -3000.0


def jax_pupils(jlens, key, spp, spp_chief=GEO_SPP):
    """The (pupil_main, pupil_chief) pairs, in mm, that the JAX
    compute_psf_rgb draws from ``key`` for each wavelength."""
    pupilr = jax_lens_scalars(jlens)["pupilr"]
    pairs = []
    for k in jax.random.split(key, 3):
        k_chief, k_main = jax.random.split(k)
        pairs.append((np.asarray(jax_sample_disk(k_main, (spp,), pupilr)),
                      np.asarray(jax_sample_disk(k_chief, (spp_chief,), pupilr * 0.25))))
    return pairs


@pytest.fixture(scope="module")
def lenses():
    return (Lens(RF50, sensor_res=(512, 768), device="cpu"),
            JLens(RF50, sensor_res=(512, 768)))


@pytest.mark.parametrize("ks", [5, 7])
@pytest.mark.parametrize("hw", [(37, 53), (48, 72)])
def test_psf_map_conv_matches_jax(ks, hw):
    """Seeded image and PSF map at grid 3, ragged and even sizes."""
    rng = np.random.default_rng(ks * 100 + hw[0])
    img = rng.uniform(0, 1, (2, *hw, 3)).astype(np.float32)
    psf_map = rng.uniform(0, 1, (3, GRID * ks, GRID * ks)).astype(np.float32)
    ref = np.asarray(jax_psf_map_conv(jnp.asarray(img), jnp.asarray(psf_map), GRID))
    got = psf_map_conv(torch.from_numpy(img), torch.from_numpy(psf_map), GRID).numpy()
    assert got.shape == ref.shape == (2, *hw, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_psf_map_conv_needs_an_odd_kernel():
    with pytest.raises(AssertionError, match="odd"):
        psf_map_conv(torch.zeros(1, 8, 8, 3), torch.zeros(3, GRID * 4, GRID * 4), GRID)


def test_render_single_image_matches_jax(lenses, monkeypatch):
    """psf_grid 3, psf_ks 10 (bumped to 11), 256 rays per point and
    wavelength, a 48x72 uint8 image, on the JAX sampler's own draws."""
    lens, jlens = lenses
    img = np.random.default_rng(3).integers(0, 256, (48, 72, 3), dtype=np.uint8)
    monkeypatch.setattr(jax_psf, "compute_psf_rgb",
                        functools.partial(jax_psf.compute_psf_rgb, spp=SPP))
    key = jax.random.PRNGKey(5)
    with jax.disable_jit():
        ref = jax_render_single_image(jlens, img, DEPTH, psf_grid=GRID, psf_ks=10,
                                      key=key)
    got = render_single_image(lens, img, DEPTH, psf_grid=GRID, psf_ks=10,
                              pupils=jax_pupils(jlens, key, SPP))
    assert got.shape == ref.shape == (48, 72, 3) and got.dtype == torch.float32
    assert got.device == lens.device
    diff = np.abs(got.numpy() - ref)
    assert diff.max() <= 1e-4, diff.max()
    # the render is blurred, not a copy of the input
    assert np.abs(ref - img / 255.0).max() > 0.05


def test_render_single_image_noise_from_the_generator(lenses):
    """The noise is drawn from the generator after the PSFs: one seed gives
    one render, another seed another; without noise the generator only
    draws the pupils."""
    lens, _ = lenses
    img = np.random.default_rng(4).uniform(0, 1, (24, 36, 3)).astype(np.float32)
    kw = dict(psf_grid=2, psf_ks=7)

    def run(seed, noise):
        return render_single_image(lens, img, DEPTH, noise=noise,
                                   generator=torch.Generator().manual_seed(seed), **kw)

    a, b, c = run(1, 0.05), run(1, 0.05), run(2, 0.05)
    assert torch.equal(a, b) and not torch.equal(a, c)
    clean = run(1, 0.0)
    assert float((a - clean).abs().max()) > 0.01
    assert float(a.min()) >= 0.0 and float(a.max()) <= 1.0


def test_render_single_image_bumps_an_even_kernel(lenses, monkeypatch):
    """An even psf_ks is traced one larger; an odd one as given."""
    from sdirt_tpu_torch.dp import psf as port_psf

    lens, _ = lenses
    seen = []
    real = port_psf.compute_psf_rgb

    def spy(*a, **kw):
        seen.append(kw["ks"])
        return real(*a, **kw)

    monkeypatch.setattr(port_psf, "compute_psf_rgb", spy)
    img = np.zeros((16, 24, 3), np.float32)
    for ks in (6, 5):
        render_single_image(lens, img, DEPTH, psf_grid=1, psf_ks=ks)
    assert seen == [7, 5]
