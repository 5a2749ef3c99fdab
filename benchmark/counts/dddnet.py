"""Work of a DDDNet training step, counted from the convolution shapes of
the benchmark's reference copy of the net (reference/dddnet.py), traced on
the meta device at the batch's shape: no data, no weights.

A convolution's forward is 2 x (C_in / groups) x prod(kernel) x C_out per
output element; a transposed convolution's is the same per INPUT element.
The backward (input and weight gradients) is counted as twice the forward.
Elementwise work (BatchNorm, ReLU, the cost volume, the softmin) is not
counted: it is memory-bound and small in operations.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..reference.dddnet import DepthNet


def forward_flops(batch: int, h: int, w: int) -> int:
    """FLOPs of the net's convolutions in one forward on [batch, 6, h, w]."""
    with torch.device("meta"):
        net = DepthNet().eval()
    total = 0

    def hook(mod, inp, out):
        nonlocal total
        k = math.prod(mod.kernel_size)
        if isinstance(mod, (nn.ConvTranspose2d, nn.ConvTranspose3d)):
            elems = inp[0].numel() // inp[0].shape[1]
            total += 2 * mod.in_channels * k * mod.out_channels * elems
        else:
            elems = out.numel() // out.shape[1]
            total += 2 * mod.in_channels // mod.groups * k * mod.out_channels * elems

    convs = (nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d, nn.ConvTranspose3d)
    for m in net.modules():
        if isinstance(m, convs):
            m.register_forward_hook(hook)
    with torch.no_grad():
        net(torch.empty((batch, 6, h, w), device="meta"))
    return total


def train_step_flops(batch: int, h: int, w: int) -> int:
    """Forward plus a backward of twice its work."""
    return 3 * forward_flops(batch, h, w)
