"""Frozen reference copy of DDDNet (YRStereonet3D), the DfDP depth net, in
plain PyTorch, with the benchmark's own loader for its ``.npz`` tree.

Siamese dilated-conv feature tower (stride 4, two-scale spatial pyramid
pooling) -> signed-shift DP cost volume (20 shifts, both signs) -> 3-D
conv matching U-net -> trilinear x4 upsample and softmin regression over
d in [-10, 10): the net regresses log depth. BatchNorm follows Flax
(momentum 0.9, epsilon 1e-5; batch moments in train mode, the running
average taken of the biased variance E[x^2] - E[x]^2). The modules carry
the Flax names so the tree's keys map onto them by path.

The training loss is the masked SmoothL1 (beta 1) of the predicted log
depth against log of the truth over pixels with depth > 1e-9.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

MAXDISP = 20


class BatchNorm(nn.Module):
    EPS, MOMENTUM = 1e-5, 0.9

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.EPS)
        dims = [0] + list(range(2, x.dim()))
        out = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                           self.EPS)
        with torch.no_grad():
            xs = x.detach().float()
            mean = xs.mean(dims)
            var = torch.clamp((xs * xs).mean(dims) - mean * mean, min=0.0)
            m = self.MOMENTUM
            self.running_mean.mul_(m).add_((1 - m) * mean)
            self.running_var.mul_(m).add_((1 - m) * var)
        return out


def resize_align_corners(x, out_sizes, dims):
    """Separable linear resize, align_corners=True sampling, axis by axis."""
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
        x = x.index_select(dim, i0) * (1 - wt) + x.index_select(dim, i1) * wt
    return x


class BasicConv(nn.Module):
    def __init__(self, cin, features, kernel_size=3, stride=1, padding=1,
                 dilation=1, is_3d=False, deconv=False, bn=True, relu=True):
        super().__init__()
        if deconv:
            cls = nn.ConvTranspose3d if is_3d else nn.ConvTranspose2d
            self.ConvTranspose_0 = cls(cin, features, kernel_size, stride,
                                       padding=1, bias=False)
        else:
            cls = nn.Conv3d if is_3d else nn.Conv2d
            self.Conv_0 = cls(cin, features, kernel_size, stride,
                              padding=padding, dilation=dilation, bias=False)
        if bn:
            self.BatchNorm_0 = BatchNorm(features)
        self.deconv, self.bn, self.relu = deconv, bn, relu

    def forward(self, x):
        x = self.ConvTranspose_0(x) if self.deconv else self.Conv_0(x)
        if self.bn:
            x = self.BatchNorm_0(x)
        return torch.relu(x) if self.relu else x


class ConvBN(nn.Module):
    def __init__(self, cin, features, kernel_size, stride, padding):
        super().__init__()
        self.Conv_0 = nn.Conv2d(cin, features, kernel_size, stride,
                                padding=padding, bias=False)
        self.BatchNorm_0 = BatchNorm(features)

    def forward(self, x):
        return self.BatchNorm_0(self.Conv_0(x))


class Conv2x(nn.Module):
    def __init__(self, cin, features):
        super().__init__()
        self.BasicConv_0 = BasicConv(cin, features, 3, 1, 1, is_3d=True)
        self.BasicConv_1 = BasicConv(2 * features, features, 3, 1, 1, is_3d=True)

    def forward(self, x, rem):
        x = resize_align_corners(x, [s * 2 for s in x.shape[2:5]], (2, 3, 4))
        return self.BasicConv_1(torch.cat([self.BasicConv_0(x), rem], dim=1))


class Feature(nn.Module):
    def __init__(self, cin=3):
        super().__init__()
        self.BasicConv_0 = BasicConv(cin, 32, 3, 1, 1)
        self.BasicConv_1 = BasicConv(32, 64, 3, 1, 1)
        self.BasicConv_2 = BasicConv(64, 64, 3, 2, 1)
        self.BasicConv_3 = BasicConv(64, 128, 3, 1, 4, dilation=4)
        self.BasicConv_4 = BasicConv(128, 128, 3, 1, 8, dilation=8)
        self.BasicConv_5 = BasicConv(128, 128, 3, 2, 1)
        self.ConvBN_0 = ConvBN(128, 32, 1, 1, 0)
        self.ConvBN_1 = ConvBN(128, 32, 1, 1, 0)
        self.BasicConv_6 = BasicConv(192, 96, 3, 1, 1)
        self.BasicConv_7 = BasicConv(96, 32, 1, 1, 0, bn=False, relu=False)

    def forward(self, x):
        for i in range(6):
            x = getattr(self, f"BasicConv_{i}")(x)
        h, w = x.shape[2:]

        def branch(conv_bn, pool):
            b = torch.relu(conv_bn(F.avg_pool2d(x, pool, stride=pool)))
            return resize_align_corners(b, (h, w), (2, 3))

        feat = torch.cat([branch(self.ConvBN_0, 32), branch(self.ConvBN_1, 8), x], 1)
        return self.BasicConv_7(self.BasicConv_6(feat))


def cost_volume(x, y, maxdisp=MAXDISP):
    """[B, 2C, D, H, W]: shift gap = i - D/2 of the left against the right
    features, zero where the shift leaves the image."""
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
    def __init__(self):
        super().__init__()
        self.BasicConv_0 = BasicConv(64, 32, 3, 1, 1, is_3d=True)
        self.BasicConv_1 = BasicConv(32, 48, 3, 2, 1, is_3d=True)
        self.BasicConv_2 = BasicConv(48, 64, 3, 1, 1, is_3d=True)
        self.BasicConv_3 = BasicConv(64, 64, 3, 2, 1, is_3d=True)
        self.BasicConv_4 = BasicConv(64, 64, 3, 1, 1, is_3d=True)
        self.Conv2x_0 = Conv2x(64, 64)
        self.BasicConv_5 = BasicConv(64, 64, 4, 2, 1, is_3d=True, deconv=True)
        self.BasicConv_6 = BasicConv(64, 1, 3, 1, 1, is_3d=True, bn=False, relu=False)

    def forward(self, cost):
        x = self.BasicConv_2(self.BasicConv_1(self.BasicConv_0(cost)))
        rem = x
        x = self.Conv2x_0(self.BasicConv_4(self.BasicConv_3(x)), rem)
        return self.BasicConv_6(self.BasicConv_5(x))


class YRStereonet3D(nn.Module):
    def __init__(self):
        super().__init__()
        self.Feature_0 = Feature(3)
        self.Matching_0 = Matching()

    def forward(self, left, right):
        cost = self.Matching_0(cost_volume(self.Feature_0(left),
                                           self.Feature_0(right)))
        _, _, _, h, w = cost.shape
        x = F.interpolate(cost, size=(MAXDISP, 4 * h, 4 * w), mode="trilinear",
                          align_corners=False)[:, 0]
        p = torch.softmax(-x, dim=1)
        disp = torch.arange(-MAXDISP // 2, MAXDISP // 2, dtype=x.dtype,
                            device=x.device).reshape(1, -1, 1, 1)
        return torch.sum(p * disp, dim=1, keepdim=True)


class DepthNet(nn.Module):
    """[B, 6, H, W] DP stack (left RGB, right RGB) -> [B, 1, H, W] log depth."""

    def __init__(self):
        super().__init__()
        self.dfdp_net = YRStereonet3D()

    def forward(self, stack):
        return self.dfdp_net(stack[:, :3], stack[:, 3:6])


_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean",
       "var": "running_var"}


def tree_to_state(tree: dict) -> dict[str, torch.Tensor]:
    """Flax tree keys and layouts -> this module's state dict."""
    out = {}
    for key, arr in tree.items():
        _, *path, leaf = key.split("/")
        module = path[-1]
        if leaf == "kernel":
            nd = arr.ndim - 2
            if module.startswith("ConvTranspose"):
                arr = np.flip(arr, axis=tuple(range(nd))).transpose(nd, nd + 1, *range(nd))
            else:
                arr = arr.transpose(nd + 1, nd, *range(nd))
            name = "weight"
        elif module.startswith("BatchNorm"):
            name = _BN[leaf]
        else:
            name = leaf
        out[".".join([*path, name])] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def build(tree: dict, device) -> DepthNet:
    """The depth net with the tree's weights, in train mode, on device."""
    net = DepthNet()
    net.load_state_dict(tree_to_state(tree), strict=True)
    return net.to(device).train()


def loss(log_pred, depth):
    """Masked SmoothL1 of the log depth over pixels with depth > 1e-9."""
    mask = depth > 1e-9
    target = torch.where(mask, torch.log(torch.where(mask, depth,
                                                     torch.ones_like(depth))), depth)
    d = torch.abs(log_pred - target)
    sl1 = torch.where(d < 1.0, 0.5 * d * d, d - 0.5)
    m = mask.float()
    return (sl1 * m).sum() / (m.sum() + 1e-9)
