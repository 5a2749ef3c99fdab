"""Fitted camera response (PyTorch counterpart of sdirt_tpu/render/camera.py).

A two-branch reciprocal fit (dark/bright regimes blended by x/100)
calibrated on the Canon R6M2; the PSF convolution runs in linear luminance
between degamma and gamma. Training renders add the structured DP noise
model: Gaussian noise modulated by horizontally opposite left/right ramps,
the DP vignetting signature. ``apply_dp_noise`` applies explicit draws;
``dp_noise`` draws them from a ``torch.Generator`` (the JAX package draws
them from split PRNG keys, which torch cannot reproduce).
"""

from __future__ import annotations

import torch

_A1, _B1, _C1 = 0.89129432, 0.27217316, -0.00246187
_A2, _B2, _C2 = 5.94018909e-01, 1.20060450e01, -5.24983855e-03


def fit_degamma(x):
    """255-scale pixel value -> linear luminance."""
    l1 = 1.0 / (1.0 / (_A1 * x + _B1) + _C1)
    l2 = 1.0 / (1.0 / (_A2 * x + _B2) + _C2)
    ratio = torch.clamp(x / 100.0, max=1.0)
    return l2 * ratio + l1 * (1.0 - ratio)


def degamma(img):
    """[0, 1] image -> linear luminance."""
    return fit_degamma(img * 255.0)


def fit_gamma(lum):
    """linear luminance -> 255-scale pixel value."""
    x1 = (1.0 / (1.0 / (lum + 1e-9) - _C1) - _B1) / _A1
    x2 = (1.0 / (1.0 / (lum + 1e-9) - _C2) - _B2) / _A2
    xmid = (x1 + x2) / 2.0
    ratio = torch.clamp(xmid / 100.0, max=1.0)
    return x2 * ratio + x1 * (1.0 - ratio)


def gamma(lum):
    """linear luminance -> [0, 1] image."""
    return fit_gamma(lum) / 255.0


def apply_dp_noise(render, noise_range, noise, r1, r2):
    """Add the DP noise for given draws.

    render: [N, 2C, H, W] (left channels then right); noise: a standard
    normal draw of the same shape; noise_range, r1, r2: scalars. The noise
    is noise * noise_range * weight, where the left views' weight ramps
    linearly from r1 to r2 across the width and the right views' weight is
    that ramp flipped in x.
    """
    n, c2, h, w = render.shape
    c = c2 // 2
    ramp = r1 + (r2 - r1) * torch.arange(w, dtype=render.dtype,
                                         device=render.device) / (w - 1)
    weight_l = ramp.expand(n, c, h, w)
    weight = torch.cat([weight_l, torch.flip(weight_l, dims=(-1,))], dim=1)
    return render + (noise * noise_range) * weight


def draw_dp_noise(generator: torch.Generator, shape, device=None):
    """The draws of one noise sample: (noise_range, noise, r1, r2), with
    noise_range ~ 0.05 U(0, 1), noise ~ N(0, 1) of ``shape``,
    r1 ~ U(0, 1/2) and r2 ~ U(1/2, 1)."""
    dev = generator.device if device is None else device
    u = torch.rand(3, generator=generator, device=dev)
    noise = torch.randn(tuple(shape), generator=generator, device=dev)
    return 0.05 * u[0], noise, u[1] / 2.0, u[2] / 2.0 + 0.5


def dp_noise(generator: torch.Generator, render):
    """render + DP noise drawn from ``generator`` (on the render's device)."""
    return apply_dp_noise(render, *draw_dp_noise(generator, render.shape,
                                                 render.device))
