"""Spatially varying PSF convolutions, plain PyTorch (counterpart of
sdirt_tpu/render/perpixel.py).

``local_dp_conv``: the per-pixel DP convolution. The image is edge-padded
and streamed tap by tap; image and PSF are rounded to bf16 and their
products summed in f32. The JAX scan writes the product in bf16, but XLA
computes it with excess precision (no bf16 rounding) on the CPU where the
reference numbers come from, and the fused kernel keeps it in f32 too.

``uniform_psf_conv`` and ``psf_map_conv``: one PSF for the whole image, or
one per image patch, as depthwise ``conv2d`` (the JAX code is a
``lax.conv_general_dilated`` outside any Pallas kernel).
``render_single_image`` renders one image through a patchwise map of
ray-traced RGB PSFs, with no surrogate.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.constants import GEO_SPP


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


def _reflect_pad_nchw(img, pad: int):
    """[N, H, W, C] -> reflect-padded [N, C, H+2pad, W+2pad]."""
    return F.pad(img.permute(0, 3, 1, 2), (pad, pad, pad, pad), mode="reflect")


def uniform_psf_conv(img, psf, ks: int):
    """The same PSF at every pixel: a depthwise convolution with reflect
    padding. img: [N, H, W, C]; psf: [C, ks, ks]. Returns [N, H, W, C]."""
    x = _reflect_pad_nchw(img, (ks - 1) // 2)
    kern = torch.flip(psf, dims=(-1, -2))[:, None].to(img.dtype)
    return F.conv2d(x, kern, groups=img.shape[-1]).permute(0, 2, 3, 1)


def psf_map_conv(img, psf_map, grid: int):
    """Patchwise PSF-map convolution: a different kernel for each of the
    grid x grid image patches, each patch convolved over its reflect-padded
    window so that no seam shows.

    img: [N, H, W, C]; psf_map: [C, grid*ks, grid*ks] with ks odd. Patch
    (i, j) covers rows i*H//grid .. (i+1)*H//grid and the columns alike.
    Returns [N, H, W, C].
    """
    _, hpsf, wpsf = psf_map.shape
    assert hpsf % grid == 0 and wpsf % grid == 0
    ks = hpsf // grid
    assert ks % 2 == 1, "PSF kernel size should be odd"
    n, h, w, c = img.shape
    pad = (ks - 1) // 2
    img_p = _reflect_pad_nchw(img, pad)
    psf_map = psf_map.to(img.dtype)
    rows = []
    for i in range(grid):
        cols = []
        for j in range(grid):
            psf = psf_map[:, i * ks:(i + 1) * ks, j * ks:(j + 1) * ks]
            kern = torch.flip(psf, dims=(-1, -2))[:, None]
            h0, w0 = i * h // grid, j * w // grid
            h1, w1 = (i + 1) * h // grid, (j + 1) * w // grid
            patch = img_p[:, :, h0:h1 + 2 * pad, w0:w1 + 2 * pad]
            cols.append(F.conv2d(patch, kern, groups=c))
        rows.append(torch.cat(cols, dim=3))
    return torch.cat(rows, dim=2).permute(0, 2, 3, 1)


def render_single_image(lens, img, depth: float, psf_grid: int = 21,
                        psf_ks: int = 44, noise: float = 0.0, generator=None,
                        pupils=None):
    """Render one image through the lens with a patchwise map of ray-traced
    RGB PSFs (``compute_psf_rgb`` over a ``point_source_grid`` at
    ``depth`` mm, through the per-surface trace), with no surrogate.

    img: [H, W, 3], uint8 (scaled to [0, 1]) or float, array or tensor.
    An even psf_ks is bumped by one (the conv needs an odd kernel). The PSFs
    trace GEO_SPP rays per point and wavelength drawn from ``generator``
    (seed 0 on the lens's device when None), or take ``pupils``, one
    (pupil_main, pupil_chief) pair per wavelength as ``compute_psf_rgb``
    takes them (the main bundle's length is then the ray count); each PSF
    is sum-normalised. Gaussian noise of std ``noise`` is drawn from the
    generator after the PSFs.
    Runs on the lens's device; returns the float32 [H, W, 3] render on it,
    clipped to [0, 1].
    """
    from ..dp.psf import compute_psf_rgb
    from ..optics.sampling import point_source_grid

    dev = lens.device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if isinstance(img, np.ndarray) and img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    elif isinstance(img, torch.Tensor) and img.dtype == torch.uint8:
        img = img.float() / 255.0
    img = torch.as_tensor(img, dtype=torch.float32, device=dev)
    if psf_ks % 2 == 0:
        psf_ks += 1

    pts = point_source_grid(depth=depth, grid=psf_grid).reshape(-1, 3)
    spp = GEO_SPP if pupils is None else len(pupils[0][0])
    psfs = compute_psf_rgb(lens, pts, generator, spp=spp, ks=psf_ks, pupils=pupils)
    psfs = psfs / (psfs.sum((-1, -2), keepdim=True) + 1e-9)
    psf_map = psfs.reshape(psf_grid, psf_grid, 3, psf_ks, psf_ks)
    psf_map = psf_map.permute(2, 0, 3, 1, 4).reshape(3, psf_grid * psf_ks,
                                                     psf_grid * psf_ks)
    out = psf_map_conv(img[None], psf_map, psf_grid)[0]
    if noise > 0:
        out = out + torch.randn(out.shape, generator=generator, device=dev) * noise
    return out.clamp(0, 1)
