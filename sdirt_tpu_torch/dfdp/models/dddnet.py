"""DDDNet: depth-from-dual-pixel stereo cost-volume network
(PyTorch counterpart of sdirt_tpu/dfdp/models/dddnet.py, YRStereonet3D).

Siamese dilated-conv feature tower (stride 4, two-scale SPP) -> signed-shift
DP cost volume (maxdisp 20, both directions) -> 3-D conv matching U-net ->
trilinear x4 upsample + softmin regression over d in [-10, 10). The network
regresses LOG depth. V focus views enter the feature tower as one
3V-channel image per DP side. Mydeblur is the deblur head: a three-level
patch pyramid of encoders and decoders, fused by channel attention, that
refines the log depth and restores the all-in-focus image.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (BasicConv, CAMModule, Conv2x, ConvBlock, ConvBN,
                     resize_bilinear)


class Feature(nn.Module):
    """Siamese feature tower, stride 4, 32-channel output; ``cin`` input
    channels (3 per focus view)."""

    def __init__(self, cin: int = 3):
        super().__init__()
        self.BasicConv_0 = BasicConv(cin, 32, 3, 1, 1)
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
    """The DfDP depth network: left/right [B, 3V, H, W] (the left, and the
    right, channels of V focus views) -> [B, 1, H, W] log depth."""

    def __init__(self, maxdisp: int = 20, n_views: int = 1):
        super().__init__()
        self.maxdisp = maxdisp
        self.Feature_0 = Feature(3 * n_views)
        self.Matching_0 = Matching()

    def forward(self, left, right):
        xl = self.Feature_0(left)
        yr = self.Feature_0(right)
        cost = self.Matching_0(dp_cost_volume(xl, yr, self.maxdisp))
        return softmin_disparity(cost, self.maxdisp)


def _conv3(cin: int, cout: int, stride: int = 1):
    return nn.Conv2d(cin, cout, 3, stride, padding=1)


class _Residuals(nn.Module):
    """Residual pairs x + conv_a(relu(conv_b(x))), named as Flax names them:
    in ``Conv(a)(relu(Conv(b)(x)))`` the outer conv is built first, so it
    takes the lower index."""

    def _pair(self, x, first: int):
        outer = getattr(self, f"Conv_{first}")
        inner = getattr(self, f"Conv_{first + 1}")
        return outer(torch.relu(inner(x))) + x


class Encoder(_Residuals):
    """Deblur encoder: three conv stages (stride 1, 2, 2) with residual
    pairs, ``out_features`` channels at H/4 (ceil)."""

    def __init__(self, cin: int, out_features: int = 128):
        super().__init__()
        self.Conv_0 = _conv3(cin, 32)
        for i in (1, 2, 3, 4):
            setattr(self, f"Conv_{i}", _conv3(32, 32))
        self.Conv_5 = _conv3(32, 64, 2)
        for i in (6, 7, 8, 9):
            setattr(self, f"Conv_{i}", _conv3(64, 64))
        self.Conv_10 = _conv3(64, 128, 2)
        for i in (11, 12, 14):
            setattr(self, f"Conv_{i}", _conv3(128, 128))
        self.Conv_13 = _conv3(128, out_features)

    def forward(self, x):
        x = self.Conv_0(x)
        x = self._pair(self._pair(x, 1), 3)
        x = self.Conv_5(x)
        x = self._pair(self._pair(x, 6), 8)
        x = self.Conv_10(x)
        return self._pair(self._pair(x, 11), 13)


class Decoder(_Residuals):
    """Deblur decoder: residual pairs at 128, 64 and 32 channels with two x2
    transposed convolutions (k4, s2, with bias; Flax's SAME padding is
    torch's padding 1) between them, then a 3x3 conv to ``out_features``."""

    def __init__(self, out_features: int = 3):
        super().__init__()
        for i in (0, 1, 2, 3):
            setattr(self, f"Conv_{i}", _conv3(128, 128))
        self.ConvTranspose_0 = nn.ConvTranspose2d(128, 64, 4, 2, padding=1)
        for i in (4, 5, 6, 7):
            setattr(self, f"Conv_{i}", _conv3(64, 64))
        self.ConvTranspose_1 = nn.ConvTranspose2d(64, 32, 4, 2, padding=1)
        for i in (8, 9, 10, 11):
            setattr(self, f"Conv_{i}", _conv3(32, 32))
        self.Conv_12 = _conv3(32, out_features)

    def forward(self, x):
        x = self.ConvTranspose_0(self._pair(self._pair(x, 0), 2))
        x = self.ConvTranspose_1(self._pair(self._pair(x, 4), 6))
        return self.Conv_12(self._pair(self._pair(x, 8), 10))


class Mydeblur(nn.Module):
    """Multi-patch deblur and depth-refine head: the image (left, right and
    the estimated log depth, 7 channels) in halves and quarters through one
    encoder per pyramid level, decoded coarse to fine, fused with a channel
    attention over a stride-4 view of (left - right, depth). H and W must
    be multiples of 8 (each quarter patch lands on its encoder's H/4 grid).
    Returns (refined log depth [B, 1, H, W], all-in-focus image
    [B, 3, H, W])."""

    def __init__(self, feat: int = 128):
        super().__init__()
        self.Encoder_0 = Encoder(7, feat)     # level 1, the whole image
        self.Encoder_1 = Encoder(7, feat)     # level 2, halves
        self.Encoder_2 = Encoder(7, feat)     # level 3, quarters
        self.Decoder_0 = Decoder(7)           # level 3
        self.Decoder_1 = Decoder(7)           # level 2
        self.Decoder_2 = Decoder(3)           # the all-in-focus image
        self.Decoder_3 = Decoder(1)           # the refined depth
        self.ConvBlock_0 = ConvBlock(4, feat, 8, 4, 2)
        self.CAMModule_0 = CAMModule()

    def forward(self, left, right, disp):
        img = torch.cat([left, right, disp], dim=1)           # [B, 7, H, W]
        h, w = img.shape[2:]
        lv2 = [img[:, :, :h // 2], img[:, :, h // 2:]]
        lv3 = [lv2[0][..., :w // 2], lv2[0][..., w // 2:],
               lv2[1][..., :w // 2], lv2[1][..., w // 2:]]

        f3 = [self.Encoder_2(p) for p in lv3]
        f3_top = torch.cat([f3[0], f3[1]], dim=3)
        f3_bot = torch.cat([f3[2], f3[3]], dim=3)
        f3_merge = torch.cat([f3_top, f3_bot], dim=2)
        r3_top = self.Decoder_0(f3_top)
        r3_bot = self.Decoder_0(f3_bot)

        f2 = [self.Encoder_1(lv2[0] + r3_top), self.Encoder_1(lv2[1] + r3_bot)]
        f2_merge = torch.cat(f2, dim=2) + f3_merge
        r2_merge = self.Decoder_1(f2_merge)

        f1_merge = self.Encoder_0(img + r2_merge) + f2_merge
        feat = self.CAMModule_0(self.ConvBlock_0(
            torch.cat([left - right, disp], dim=1)))
        fused = f1_merge + feat
        return self.Decoder_3(fused), self.Decoder_2(fused)
