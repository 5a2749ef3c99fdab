"""Building blocks of the DfDP depth net (PyTorch counterpart of
sdirt_tpu/dfdp/models/layers.py).

Layouts are PyTorch's: NCHW, and NCDHW for the 3-D cost-volume blocks.
Sub-modules carry the Flax module names (``Conv_0``, ``BatchNorm_0``, ...)
so the carried-across weights map by name (utils/weights.py). BatchNorm runs
on its running statistics with eps 1e-5.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


def resize_linear_align_corners(x, out_sizes: Sequence[int],
                                dims: Sequence[int]):
    """Separable linear interpolation with align_corners=True sampling
    (out[i] reads input at i*(n-1)/(out-1)), axis by axis."""
    for dim, out in zip(dims, out_sizes):
        n = x.shape[dim]
        if out == n:
            continue
        scale = (n - 1) / (out - 1) if out > 1 else 0.0
        pos = torch.arange(out, device=x.device, dtype=torch.float32) * scale
        i0 = torch.floor(pos).long()
        i1 = torch.clamp(i0 + 1, max=n - 1)
        shape = [1] * x.dim()
        shape[dim] = out
        wt = (pos - i0).to(x.dtype).reshape(shape)
        x = (x.index_select(dim, i0) * (1 - wt)
             + x.index_select(dim, i1) * wt)
    return x


def resize_bilinear(x, out_hw, align_corners: bool):
    """[B, C, H, W] spatial resize. align_corners=False is the half-pixel
    convention with antialiasing on downscale, as jax.image.resize."""
    if align_corners:
        return resize_linear_align_corners(x, out_hw, (2, 3))
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                         align_corners=False, antialias=True)


class BasicConv(nn.Module):
    """Conv or x2 transposed conv (no bias), + BN, + ReLU; 2-D or 3-D."""

    def __init__(self, cin: int, features: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, dilation: int = 1,
                 is_3d: bool = False, deconv: bool = False, bn: bool = True,
                 relu: bool = True):
        super().__init__()
        if deconv:
            # Flax ConvTranspose(k4, s2, 'SAME') == torch k4/s2/p1: exact x2
            cls = nn.ConvTranspose3d if is_3d else nn.ConvTranspose2d
            self.ConvTranspose_0 = cls(cin, features, kernel_size, stride,
                                       padding=1, bias=False)
        else:
            cls = nn.Conv3d if is_3d else nn.Conv2d
            self.Conv_0 = cls(cin, features, kernel_size, stride,
                              padding=padding, dilation=dilation, bias=False)
        if bn:
            self.BatchNorm_0 = (nn.BatchNorm3d if is_3d
                                else nn.BatchNorm2d)(features, eps=1e-5)
        self.deconv, self.bn, self.relu = deconv, bn, relu

    def forward(self, x):
        x = self.ConvTranspose_0(x) if self.deconv else self.Conv_0(x)
        if self.bn:
            x = self.BatchNorm_0(x)
        return torch.relu(x) if self.relu else x


class ConvBN(nn.Module):
    """2-D conv (no bias) + BN, no activation."""

    def __init__(self, cin: int, features: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 0, dilation: int = 1):
        super().__init__()
        self.Conv_0 = nn.Conv2d(cin, features, kernel_size, stride,
                                padding=padding, dilation=dilation, bias=False)
        self.BatchNorm_0 = nn.BatchNorm2d(features, eps=1e-5)

    def forward(self, x):
        return self.BatchNorm_0(self.Conv_0(x))


class Conv2x(nn.Module):
    """Upsample-merge block: linear x2 (align_corners=True) -> conv ->
    concat skip -> conv. 3-D only (the 2-D form is off the serve path)."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.BasicConv_0 = BasicConv(cin, features, 3, 1, 1, is_3d=True)
        self.BasicConv_1 = BasicConv(2 * features, features, 3, 1, 1,
                                     is_3d=True)

    def forward(self, x, rem):
        out_sizes = [s * 2 for s in x.shape[2:5]]
        x = resize_linear_align_corners(x, out_sizes, (2, 3, 4))
        x = self.BasicConv_0(x)
        if x.shape != rem.shape:
            raise ValueError(f"Conv2x: {tuple(x.shape)} vs skip {tuple(rem.shape)}")
        return self.BasicConv_1(torch.cat([x, rem], dim=1))
