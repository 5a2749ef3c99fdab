"""The PyTorch port's weight-free perceptual distance
(sdirt_tpu_torch/dfdp/perceptual.py: MS-SSIM + GMSD) against the JAX
package's (sdirt_tpu/dfdp/perceptual.py) on the CPU, on seeded images and on
a real flat capture, and the flat score's columns in the port's
test_dp_images.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdirt_tpu.dfdp import perceptual as jax_perc
from sdirt_tpu_torch.dfdp import perceptual

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(2)


def _pair(seed, shape, sigma=0.05):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, sigma, shape), 0, 1).astype(np.float32)
    return a, b


CASES = [((1, 3, 64, 96), lv) for lv in (1, 2, 3)] + \
        [((1, 3, 128, 192), lv) for lv in (1, 2, 3, 4)] + [((2, 1, 64, 96), 3)]


@pytest.mark.parametrize("shape,levels", CASES,
                         ids=[f"{'x'.join(map(str, s))}-L{lv}" for s, lv in CASES])
def test_perceptual_distance_matches_jax(shape, levels):
    a, b = _pair(sum(shape) + levels, shape)
    ref = float(jax_perc.perceptual_distance(jnp.asarray(a), jnp.asarray(b), levels))
    got = perceptual.perceptual_distance(torch.from_numpy(a), torch.from_numpy(b),
                                         levels)
    # measured at most 5.9e-6 (the f32 means are summed in another order)
    assert abs(float(got) - ref) <= 1e-5


@pytest.mark.parametrize("shape", [(1, 3, 64, 96), (3, 128, 192), (1, 3, 512, 768)])
def test_batch_perceptual_matches_jax(shape):
    a, b = _pair(len(shape), shape)
    ref = jax_perc.batch_perceptual(a, b)
    got = perceptual.batch_perceptual(a, b)
    assert isinstance(got, float)
    # measured at most 1.9e-7
    assert abs(got - ref) <= 1e-5
    assert perceptual.batch_perceptual(torch.from_numpy(a), b) == got


@pytest.mark.parametrize("part", ["ms_ssim", "gmsd"])
def test_parts_match_jax(part):
    a, b = _pair(11, (1, 3, 96, 128))
    kw = {"levels": 4} if part == "ms_ssim" else {}
    ref = float(getattr(jax_perc, part)(jnp.asarray(a), jnp.asarray(b), **kw))
    got = float(getattr(perceptual, part)(torch.from_numpy(a), torch.from_numpy(b), **kw))
    # measured 1.2e-7 (ms_ssim, 4 scales) and 4e-9 (gmsd)
    assert abs(got - ref) <= 1e-5


def test_single_scale_mean_against_float64():
    """One scale on a 2 x 3 x 96 x 128 pair: the port's f32 score is within
    1e-6 of the same formula in float64, the JAX package's f32 score 1.3e-5
    away from it (its f32 mean over 6e4 values is summed in order)."""
    a, b = _pair(0, (2, 3, 96, 128))
    x, y = torch.from_numpy(a).double(), torch.from_numpy(b).double()
    win = torch.from_numpy(perceptual._gaussian_window()).double()
    lum, _ = perceptual._ssim_components(x, y, win, 0.01**2, 0.03**2)
    exact = 1.0 - float(lum.mean()) + float(perceptual.gmsd(x, y))
    got = float(perceptual.perceptual_distance(torch.from_numpy(a), torch.from_numpy(b), 1))
    ref = float(jax_perc.perceptual_distance(jnp.asarray(a), jnp.asarray(b), 1))
    assert abs(got - exact) <= 1e-6
    assert abs(ref - exact) > 5e-6


def test_identity_zero_and_monotone():
    a, _ = _pair(3, (1, 3, 64, 96))
    t = torch.from_numpy(a)
    assert abs(float(perceptual.perceptual_distance(t, t, 3))) < 1e-6
    scores = [perceptual.batch_perceptual(*_pair(3, (1, 3, 64, 96), s))
              for s in (0.01, 0.05, 0.2)]
    assert scores[0] < scores[1] < scores[2]


@pytest.mark.parametrize("hw,levels", [((512, 768), 5), ((64, 96), 3), ((20, 40), 1),
                                       ((44, 44), 3)])
def test_max_levels_matches_jax(hw, levels):
    assert perceptual.max_levels(*hw) == jax_perc.max_levels(*hw) == levels


def test_flat_scores_carry_the_perceptual_columns():
    """test_dp_images writes perc_l / perc_r, rounded to 5 places as the
    JAX app writes them, and equal to batch_perceptual of the render and
    the capture; FLAT_COLUMNS (res.csv) holds them."""
    from sdirt_tpu_torch import dfdp_net
    from sdirt_tpu_torch.dfdp import factory
    from sdirt_tpu_torch.utils.config import load_config

    assert dfdp_net.FLAT_COLUMNS[-2:] == ("perc_l", "perc_r")
    args = load_config(os.path.join(ROOT, "configs", "dfdp_by_sdirt_rf50mm.yml"))
    args["real_flat_sample"] = os.path.join(ROOT, "real_sample_set", "flat")
    ds = factory.get_flat_sample_set(args)
    crop = (slice(192, 256), slice(288, 384))
    f4, f20, depth = (np.ascontiguousarray(a[..., crop[0], crop[1]]) for a in ds[0])

    class Lens:
        """A stand-in lens: its render is a fixed blur of the input."""

        def render(self, img, depth, foc, variant=None):
            img = torch.as_tensor(img)
            blur = torch.nn.functional.avg_pool2d(img, 3, 1, 1, count_include_pad=False)
            return torch.cat([blur, blur], 1)

    rec = dfdp_net.test_dp_images(Lens(), [(f4, f20, depth)], "fused")[0]
    assert tuple(rec) == dfdp_net.FLAT_COLUMNS
    blur = Lens().render(f20[None, :3], None, None).numpy()[:, :3]
    assert rec["perc_l"] == round(perceptual.batch_perceptual(blur, f4[None, :3]), 5)
    # the unrounded scores are 3e-8 apart; the fifth place may differ
    assert abs(rec["perc_l"] - jax_perc.batch_perceptual(blur, f4[None, :3])) <= 1e-5
