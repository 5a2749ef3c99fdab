"""Building blocks of the DfDP depth net (PyTorch counterpart of
sdirt_tpu/dfdp/models/layers.py).

Layouts are PyTorch's: NCHW, and NCDHW for the 3-D cost-volume blocks.
Sub-modules carry the Flax module names (``Conv_0``, ``BatchNorm_0``, ...)
so the carried-across weights map by name (utils/weights.py). BatchNorm
(``BatchNorm``, eps 1e-5) runs on its running statistics in eval mode and
on the batch's in train mode, with Flax's running-average rule.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm(nn.Module):
    """Batch normalisation with Flax's semantics (nn.BatchNorm with
    momentum 0.9, epsilon 1e-5), over every axis but the channel axis 1.

    Train mode normalises with the batch mean and the biased batch variance
    and updates the running statistics once per forward as Flax does:
    ``ra = 0.9 ra + 0.1 stat``, with the variance taken as
    E[x^2] - E[x]^2 (Flax's fast variance), not the unbiased variance that
    torch.nn.BatchNorm*d keeps. Eval mode reads the running statistics.
    Parameters and buffers carry torch's names (weight, bias, running_mean,
    running_var), which utils/weights.py maps to Flax's scale, bias, mean,
    var.

    ``group`` (set by sync_batchnorm): a torch.distributed group over which
    train mode's batch moments are taken. The counts, the sums of x and
    then those of (x - mean)^2 are all_reduced with autograd, so each rank
    normalises with the moments of the whole batch and the gradient flows
    through them, as in the JAX data-parallel step, where XLA reduces the
    moments. The variance is taken about the mean (two passes), as
    F.batch_norm takes it: E[x^2] - E[x]^2 in f32 loses ~1e-4 of a loss to
    cancellation where a channel's mean is large against its spread.
    """

    EPS, MOMENTUM = 1e-5, 0.9

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.group = None

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.EPS)
        dims = [0] + list(range(2, x.dim()))
        if self.group is not None:
            return self._forward_synced(x, dims)
        out = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                           self.EPS)
        with torch.no_grad():
            xs = x.detach().to(torch.promote_types(x.dtype, torch.float32))
            mean = xs.mean(dims)
            var = torch.clamp((xs * xs).mean(dims) - mean * mean, min=0.0)
            self._update(mean, var)
        return out

    def _forward_synced(self, x, dims):
        from ...parallel.mesh import all_reduce_autograd as all_reduce

        xs = x.to(torch.promote_types(x.dtype, torch.float32))
        shape = [1, -1] + [1] * (x.dim() - 2)
        count = all_reduce(torch.tensor(float(x.numel() // x.shape[1]),
                                        dtype=xs.dtype, device=x.device),
                           group=self.group)
        mean = all_reduce(xs.sum(dims), group=self.group) / count
        xc = xs - mean.view(shape)
        var = all_reduce((xc * xc).sum(dims), group=self.group) / count
        with torch.no_grad():
            self._update(mean.detach(), var.detach())
        out = (xc * torch.rsqrt(var.view(shape) + self.EPS) * self.weight.view(shape)
               + self.bias.view(shape))
        return out.to(x.dtype)

    def _update(self, mean, var):
        m = self.MOMENTUM
        self.running_mean.mul_(m).add_((1 - m) * mean)
        self.running_var.mul_(m).add_((1 - m) * var)


def sync_batchnorm(net: nn.Module, group) -> nn.Module:
    """Take every BatchNorm's train-mode moments over ``group`` (None: this
    rank's batch alone)."""
    for m in net.modules():
        if isinstance(m, BatchNorm):
            m.group = group
    return net


def resize_linear_align_corners(x, out_sizes: Sequence[int],
                                dims: Sequence[int]):
    """Separable linear interpolation with align_corners=True sampling
    (out[i] reads input at i*(n-1)/(out-1)), axis by axis."""
    for dim, out in zip(dims, out_sizes):
        n = x.shape[dim]
        if out == n:
            continue
        scale = (n - 1) / (out - 1) if out > 1 else 0.0
        pos = torch.arange(out, device=x.device,
                           dtype=torch.promote_types(x.dtype, torch.float32)) * scale
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
            self.BatchNorm_0 = BatchNorm(features)
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
        self.BatchNorm_0 = BatchNorm(features)

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


class ResBlock(nn.Module):
    """Dilated residual block: (conv, BN, leaky ReLU 0.2) twice, the second
    added to the input before its activation."""

    def __init__(self, features: int, dilation: int = 1):
        super().__init__()
        pad = dilation
        self.Conv_0 = nn.Conv2d(features, features, 3, padding=pad,
                                dilation=dilation, bias=False)
        self.BatchNorm_0 = BatchNorm(features)
        self.Conv_1 = nn.Conv2d(features, features, 3, padding=pad,
                                dilation=dilation, bias=False)
        self.BatchNorm_1 = BatchNorm(features)

    def forward(self, x):
        out = F.leaky_relu(self.BatchNorm_0(self.Conv_0(x)), 0.2)
        out = self.BatchNorm_1(self.Conv_1(out))
        return F.leaky_relu(out + x, 0.2)


class CAMModule(nn.Module):
    """Channel attention: a softmax over each row of max(energy) - energy,
    with energy the [B, C, C] Gram matrix of the channels summed over the
    H*W pixels, mixes the channels; the result is scaled by the learnt
    ``gamma`` (0 at init) and added to the input. Computed in f32 (or the
    input's wider type) whatever the input's type: the sums run over the
    H*W pixels."""

    def __init__(self):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x):
        b, c, h, w = x.shape
        v = x.to(torch.promote_types(x.dtype, torch.float32)).reshape(b, c, h * w)
        energy = torch.bmm(v, v.transpose(1, 2))                  # [B, C, C]
        energy_new = energy.amax(-1, keepdim=True) - energy
        attention = torch.softmax(energy_new, dim=-1)
        out = torch.bmm(attention, v).reshape(b, c, h, w).to(x.dtype)
        return self.gamma * out + x


class ConvBlock(nn.Module):
    """Conv (with bias) + sigmoid, the JAX ConvBlock with the activation
    the deblur head uses."""

    def __init__(self, cin: int, features: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1):
        super().__init__()
        self.Conv_0 = nn.Conv2d(cin, features, kernel_size, stride,
                                padding=padding)

    def forward(self, x):
        return torch.sigmoid(self.Conv_0(x))
