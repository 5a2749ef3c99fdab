"""Fitted camera response (PyTorch counterpart of sdirt_tpu/render/camera.py).

A two-branch reciprocal fit (dark/bright regimes blended by x/100)
calibrated on the Canon R6M2; the PSF convolution runs in linear luminance
between degamma and gamma. The structured DP noise model (``dp_noise``) is
for training renders and comes with the training slice.
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
