"""DDDNet: depth-from-dual-pixel stereo cost-volume network
(PyTorch counterpart of sdirt_tpu/dfdp/models/dddnet.py, YRStereonet3D).

Siamese dilated-conv feature tower (stride 4, two-scale SPP) -> signed-shift
DP cost volume (maxdisp 20, both directions) -> 3-D conv matching U-net ->
trilinear x4 upsample + softmin regression over d in [-10, 10). The network
regresses LOG depth. The deblur head (Mydeblur) comes with a later slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (BasicConv, Conv2x, ConvBN, resize_bilinear)


class Feature(nn.Module):
    """Siamese feature tower, stride 4, 32-channel output."""

    def __init__(self):
        super().__init__()
        self.BasicConv_0 = BasicConv(3, 32, 3, 1, 1)
        self.BasicConv_1 = BasicConv(32, 64, 3, 1, 1)
        self.BasicConv_2 = BasicConv(64, 64, 3, 2, 1)
        self.BasicConv_3 = BasicConv(64, 128, 3, 1, 4, dilation=4)
        self.BasicConv_4 = BasicConv(128, 128, 3, 1, 8, dilation=8)
        self.BasicConv_5 = BasicConv(128, 128, 3, 2, 1)
        self.ConvBN_0 = ConvBN(128, 32, 1, 1, 0)     # 32x32 pooling branch
        self.ConvBN_1 = ConvBN(128, 32, 1, 1, 0)     # 8x8 pooling branch
        self.BasicConv_6 = BasicConv(192, 96, 3, 1, 1)
        self.BasicConv_7 = BasicConv(96, 32, 1, 1, 0, bn=False, relu=False)

    def forward(self, x):
        for i in range(6):
            x = getattr(self, f"BasicConv_{i}")(x)
        h, w = x.shape[2:]

        def branch(conv_bn, pool):
            b = F.avg_pool2d(x, pool, stride=pool)
            b = torch.relu(conv_bn(b))
            return resize_bilinear(b, (h, w), align_corners=True)

        feat = torch.cat([branch(self.ConvBN_0, 32), branch(self.ConvBN_1, 8),
                          x], dim=1)
        return self.BasicConv_7(self.BasicConv_6(feat))


def dp_cost_volume(x, y, maxdisp: int = 20):
    """Signed-shift DP cost volume.

    x, y: [B, C, H, W] left/right features. Returns [B, 2C, D, H, W]; shift
    gap = i - D/2 spans both signs (DP disparity is signed around focus):
    for gap < 0 columns [0, W+gap) hold (x[:, :, :, :gap], y[..., -gap:]),
    for gap > 0 columns [gap, W) hold (x[..., gap:], y[..., :-gap]), the rest
    are zero.
    """
    b, c, h, w = x.shape
    vol = x.new_zeros((b, 2 * c, maxdisp, h, w))
    for i in range(maxdisp):
        gap = i - maxdisp // 2
        if gap < 0:
            vol[:, :c, i, :, :gap] = x[..., :gap]
            vol[:, c:, i, :, :gap] = y[..., -gap:]
        elif gap == 0:
            vol[:, :c, i] = x
            vol[:, c:, i] = y
        else:
            vol[:, :c, i, :, gap:] = x[..., gap:]
            vol[:, c:, i, :, gap:] = y[..., :-gap]
    return vol


class Matching(nn.Module):
    """3-D conv cost-aggregation U-net."""

    def __init__(self):
        super().__init__()
        self.BasicConv_0 = BasicConv(64, 32, 3, 1, 1, is_3d=True)
        self.BasicConv_1 = BasicConv(32, 48, 3, 2, 1, is_3d=True)
        self.BasicConv_2 = BasicConv(48, 64, 3, 1, 1, is_3d=True)
        self.BasicConv_3 = BasicConv(64, 64, 3, 2, 1, is_3d=True)
        self.BasicConv_4 = BasicConv(64, 64, 3, 1, 1, is_3d=True)
        self.Conv2x_0 = Conv2x(64, 64)
        self.BasicConv_5 = BasicConv(64, 64, 4, 2, 1, is_3d=True, deconv=True)
        self.BasicConv_6 = BasicConv(64, 1, 3, 1, 1, is_3d=True, bn=False,
                                     relu=False)

    def forward(self, cost):
        x = self.BasicConv_2(self.BasicConv_1(self.BasicConv_0(cost)))
        rem0 = x
        x = self.BasicConv_4(self.BasicConv_3(x))
        x = self.Conv2x_0(x, rem0)
        return self.BasicConv_6(self.BasicConv_5(x))


def softmin_disparity(x, maxdisp: int = 20):
    """[B, 1, D', H', W'] matching cost -> [B, 1, 4H', 4W'] disparity:
    trilinear resize (half-pixel) to [maxdisp, 4H', 4W'], softmin over D,
    expectation over d in [-maxdisp/2, maxdisp/2)."""
    _, _, _, h, w = x.shape
    x = F.interpolate(x, size=(maxdisp, h * 4, w * 4), mode="trilinear",
                      align_corners=False)[:, 0]
    p = torch.softmax(-x, dim=1)
    disp = torch.arange(-maxdisp // 2, maxdisp // 2, dtype=x.dtype,
                        device=x.device).reshape(1, -1, 1, 1)
    return torch.sum(p * disp, dim=1, keepdim=True)


class YRStereonet3D(nn.Module):
    """The DfDP depth network: left/right [B, 3, H, W] -> [B, 1, H, W]
    log depth."""

    def __init__(self, maxdisp: int = 20):
        super().__init__()
        self.maxdisp = maxdisp
        self.Feature_0 = Feature()
        self.Matching_0 = Matching()

    def forward(self, left, right):
        xl = self.Feature_0(left)
        yr = self.Feature_0(right)
        cost = self.Matching_0(dp_cost_volume(xl, yr, self.maxdisp))
        return softmin_disparity(cost, self.maxdisp)
