"""Spatially varying per-pixel DP convolution, plain PyTorch
(counterpart of sdirt_tpu/render/perpixel.py:local_dp_conv).

The image is edge-padded and streamed tap by tap; image and PSF are rounded
to bf16 and their products summed in f32. The JAX scan writes the product
in bf16, but XLA computes it with excess precision (no bf16 rounding) on the
CPU where the reference numbers come from, and the fused kernel keeps it in
f32 too.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def edge_pad_nhwc(img, pad: int):
    """[N, H, W, C] -> [N, H+2pad, W+2pad, C], edge (replicate) padding."""
    out = F.pad(img.permute(0, 3, 1, 2), (pad, pad, pad, pad), mode="replicate")
    return out.permute(0, 2, 3, 1)


def local_dp_conv(img, psf, ks: int, mirror_right: bool = False):
    """Per-pixel DP convolution.

    img: [N, H, W, C] (linear luminance)
    psf: [N, H, W, 2, ks, ks] per-pixel left/right kernels
    Returns (render_l, render_r): [N, H, W, C] f32.

    out[v, y, x] = sum_{dy,dx} img_pad[y+dy, x+dx] * psf[y, x, v, ks-1-dy, ks-1-dx]
    (a true convolution). mirror_right=True takes a right kernel that was NOT
    x-mirrored (the raw x-negated query, as the fused kernel reads it) and
    folds the mirror into the tap index: k_r[dy, dx] = psf_r_raw[ks-1-dy, dx].
    """
    n, h, w, c = img.shape
    pad = (ks - 1) // 2
    img_p = edge_pad_nhwc(img, pad).to(torch.bfloat16).float()
    psf_b = psf.to(torch.bfloat16).float()
    acc_l = torch.zeros((n, h, w, c), dtype=torch.float32, device=img.device)
    acc_r = torch.zeros_like(acc_l)
    for dy in range(ks):
        for dx in range(ks):
            patch = img_p[:, dy:dy + h, dx:dx + w, :]
            k_l = psf_b[:, :, :, 0, ks - 1 - dy, ks - 1 - dx]
            rx = dx if mirror_right else ks - 1 - dx
            k_r = psf_b[:, :, :, 1, ks - 1 - dy, rx]
            acc_l += patch * k_l[..., None]
            acc_r += patch * k_r[..., None]
    return acc_l, acc_r


def uniform_psf_conv(img, psf, ks: int):
    """The same PSF at every pixel: a depthwise convolution with reflect
    padding. img: [N, H, W, C]; psf: [C, ks, ks]. Returns [N, H, W, C]."""
    pad = (ks - 1) // 2
    x = F.pad(img.permute(0, 3, 1, 2), (pad, pad, pad, pad), mode="reflect")
    kern = torch.flip(psf, dims=(-1, -2))[:, None].to(img.dtype)
    return F.conv2d(x, kern, groups=img.shape[-1]).permute(0, 2, 3, 1)
