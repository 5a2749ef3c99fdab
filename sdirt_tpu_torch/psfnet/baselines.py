"""Baseline DP-PSF models, the paper's comparison methods (counterpart of
sdirt_tpu/psfnet/baselines.py). Each maps per-pixel normalised depth to an
L/R kernel pair:
  * CoC: half-masked clipped Gaussian of the circle-of-confusion diameter;
  * DPDNet: rect LUT indexed by CoC radius bucket;
  * Modeling: disk-autocorrelation LUT;
  * Learn2Reduce: Butterworth LUT by CoC pixel diameter.

The LUT models are one gather over the precomputed LUT (related_psf.py).
``lens`` is a PSFNetLens (d_min, d_max, foc_d, foclen, fnum, kernel_size,
sensor_size, sensor_res); ``inp`` [..., 3] has the normalised depth last.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .related_psf import disk_lut, l2r_lut, rect_lut


def _coc_signed(z, lens, is_z=True):
    """Signed circle of confusion [mm] of normalised depth z."""
    depth = z * (lens.d_max - lens.d_min) + lens.d_min if is_z else z
    foc_dist = float(lens.foc_d[0])
    coc = (depth - foc_dist) * lens.foclen ** 2 / (
        -depth * lens.fnum * (-foc_dist - lens.foclen))
    return coc, depth, foc_dist


def _per_pixel(x, lens):
    """x / the pixel size, divided as a tensor (torch on the card turns a
    division by a Python number into a multiply by its rounded
    reciprocal)."""
    ps = lens.sensor_size[0] / lens.sensor_res[0]
    return x / torch.tensor(ps, dtype=x.dtype, device=x.device)


def pred_coc(lens, inp, is_z: bool = True):
    """Clipped-Gaussian CoC model with half masks: [..., 2, ks, ks],
    sum-normalised."""
    ks = lens.kernel_size
    inp = torch.as_tensor(inp)
    coc, depth, foc_dist = _coc_signed(inp[..., -1], lens, is_z)
    coc_pixel = torch.clamp(_per_pixel(torch.abs(coc), lens), min=0.1)
    radius = (coc_pixel / 2)[..., None, None]
    lin = torch.linspace(-ks / 2 + 0.5, ks / 2 - 0.5, ks, dtype=inp.dtype,
                         device=inp.device)
    gy, gx = torch.meshgrid(lin, lin, indexing="ij")
    r2 = gx ** 2 + gy ** 2
    psf = torch.exp(-r2 / (2 * radius ** 2)) * (r2 < radius ** 2)
    col = torch.arange(ks, device=inp.device)
    l_mask = (col >= ks // 2).to(psf.dtype)         # zero the left columns
    r_mask = (col < ks // 2 + 1).to(psf.dtype)      # zero the right columns
    near = (depth > foc_dist)[..., None, None]
    psf_l = psf * torch.where(near, l_mask, r_mask)
    psf_r = psf * torch.where(near, r_mask, l_mask)
    out = torch.stack([psf_l, psf_r], dim=-3)
    return out / (out.sum((-1, -2), keepdim=True) + 1e-6)


def _lut_pred(lens, inp, lut: np.ndarray, bucket_of, swap_lr_order: bool, is_z: bool):
    inp = torch.as_tensor(inp)
    coc, _, _ = _coc_signed(inp[..., -1], lens, is_z)
    idx = bucket_of(_per_pixel(torch.abs(coc), lens), lut.shape[0])
    kernels = torch.from_numpy(lut).to(inp.device)[idx]        # [..., 2, ks, ks]
    # negative CoC: the L/R kernels swap
    neg = (coc < 0)[..., None, None, None]
    kernels = torch.where(neg, kernels.flip(-3), kernels)
    if swap_lr_order:
        kernels = kernels.flip(-3)
    return kernels / (kernels.sum((-1, -2), keepdim=True) + 1e-6)


def _bucket(x, n):
    return torch.clamp(torch.floor(x), 0, n - 1).to(torch.int64)


def pred_dpdnet(lens, inp, is_z: bool = True):
    """Rect-kernel baseline; stacked (right, left), as the reference does."""

    def bucket(coc_px, n):
        r = torch.clamp(coc_px / 2.0, min=0.1)
        sqrt_pi = torch.sqrt(torch.tensor(math.pi, dtype=r.dtype, device=r.device))
        return _bucket(sqrt_pi * r / 2.0 / 0.5, n)

    return _lut_pred(lens, inp, rect_lut(lens.kernel_size), bucket,
                     swap_lr_order=True, is_z=is_z)


def pred_modeling(lens, inp, is_z: bool = True):
    """Disk-autocorrelation baseline."""

    def bucket(coc_px, n):
        return _bucket(torch.clamp(coc_px / 2.0, min=0.1) / 0.5, n)

    return _lut_pred(lens, inp, disk_lut(lens.kernel_size), bucket,
                     swap_lr_order=False, is_z=is_z)


def pred_learn2reduce(lens, inp, is_z: bool = True):
    """Butterworth baseline; stacked (right, left), as the reference does."""

    def bucket(coc_px, n):
        d = torch.clamp(coc_px, min=0.1)
        return _bucket((torch.floor(d / 2) * 2 + 1 - 1) / 2, n)

    return _lut_pred(lens, inp, l2r_lut(lens.kernel_size), bucket,
                     swap_lr_order=True, is_z=is_z)
