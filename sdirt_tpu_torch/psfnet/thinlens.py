"""Thin-lens Gaussian-PSF renderer, no ray tracing (PyTorch counterpart of
sdirt_tpu/psfnet/thinlens.py).

Depth of field from the thin-lens circle of confusion: each pixel takes a
Gaussian disk of the CoC's size, the same kernel on both DP views, through
the plain per-pixel convolution (render/perpixel.py:local_dp_conv). The
JAX package has no Pallas kernel on this path, and neither has the port.
"""

from __future__ import annotations

import math

import torch

from ..core.constants import DMAX, DMIN
from ..render.perpixel import local_dp_conv
from ..utils.device import resolve_device


class ThinLens:
    """A thin lens of focal length ``foc_len`` (mm) at ``fnum``, with a
    sensor of ``sensor_size`` (mm) and ``sensor_res`` pixels."""

    n_views = 1

    def __init__(self, foc_len: float, fnum: float, kernel_size: int,
                 sensor_size, sensor_res, device="cuda"):
        self.device = resolve_device(device)
        self.d_max = DMAX
        self.d_min = DMIN
        self.kernel_size = kernel_size
        self.foc_len = foc_len
        self.fnum = fnum
        self.sensor_size = list(sensor_size)
        self.sensor_res = tuple(sensor_res)
        self.ps = self.sensor_size[0] / self.sensor_res[0]

    def coc(self, depth, foc_dist):
        """CoC diameter in pixels, at least 0.1; depth and foc_dist in mm
        (either sign), depth clipped to [d_min, d_max]."""
        depth = torch.clamp(torch.abs(depth), self.d_min, self.d_max)
        foc_dist = torch.abs(foc_dist)
        coc = (self.foc_len / self.fnum * torch.abs(depth - foc_dist) / depth
               * self.foc_len / (foc_dist - self.foc_len))
        return torch.clamp(coc / self.ps, min=0.1)

    def psf(self, depth, foc_dist):
        """[N, H, W] depth, [N, 1, 1] focus (mm) -> [N, H, W, ks, ks]: a
        Gaussian of sigma = CoC / 2 cut to the disk of that radius,
        sum-normalised (+ 1e-9)."""
        ks = self.kernel_size
        dev = depth.device
        x = torch.linspace(-ks / 2 + 0.5, ks / 2 - 0.5, ks, device=dev)
        y = torch.linspace(ks / 2 - 0.5, -ks / 2 + 0.5, ks, device=dev)
        r2 = x[None, :] ** 2 + y[:, None] ** 2                  # [ks, ks]
        radius = (self.coc(depth, foc_dist) / 2)[..., None, None]
        psf = torch.exp(-r2 / (2 * radius ** 2)) / (2 * math.pi * radius ** 2)
        psf = psf * (r2 < radius ** 2)
        return psf / (psf.sum((-1, -2), keepdim=True) + 1e-9)

    @torch.no_grad()
    def render(self, img, depth, foc_dist, variant: str | None = None,
               train: bool = False, generator=None):
        """img [N, C, H, W] in [0, 1], depth [N, 1, H, W] or [N, H, W] mm,
        foc_dist [N] mm -> [N, 2C, H, W] in [0, 1], the same kernel on both
        views. The image is convolved as it is (no gamma), and no noise is
        added; ``variant``, ``train`` and ``generator`` are taken for the
        PSFNetLens interface and do not change the render."""
        del variant, train, generator
        img = torch.as_tensor(img, dtype=torch.float32, device=self.device)
        depth = torch.as_tensor(depth, dtype=torch.float32, device=self.device)
        n, c, h, w = img.shape
        foc = torch.as_tensor(foc_dist, dtype=torch.float32,
                              device=self.device).reshape(n, 1, 1)
        psf = self.psf(depth.reshape(n, h, w), foc)
        psf2 = psf.unsqueeze(-3).expand(n, h, w, 2, *psf.shape[-2:])
        rl, rr = local_dp_conv(img.permute(0, 2, 3, 1), psf2, self.kernel_size)
        out = torch.cat([rl, rr], dim=-1).permute(0, 3, 1, 2)
        return torch.clamp(out, 0.0, 1.0)
