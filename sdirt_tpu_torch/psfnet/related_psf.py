"""Competitor DP-PSF kernel generators used as paper baselines (a copy of
sdirt_tpu/psfnet/related_psf.py: numpy lookup-table builders, each LUT built
once and cached):
  * rect kernels (DPDNet);
  * disk-autocorrelation kernels (Modeling);
  * Butterworth kernels (Learn2Reduce, ICCV'21), whose OpenCV calls
    (filled circle, zero border, Gaussian blur) are dfdp/cvops.py's numpy
    copies.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from ..dfdp import cvops


def _subgrid_area(ks: int, inside_fn, grid_size=1.0, sub=0.25) -> np.ndarray:
    """Area-of-intersection per pixel by subgrid point sampling (the
    reference's calculate_intersection_area pattern)."""
    xs = np.linspace(0, ks - 1, ks)
    centers = np.arange(0, grid_size, sub) + sub / 2
    # all subsample coordinates for every pixel
    px = xs[:, None, None, None] + centers[None, :, None, None]
    py = xs[None, None, :, None] + centers[None, None, None, :]
    px = np.broadcast_to(px, (ks, len(centers), ks, len(centers)))
    py = np.broadcast_to(py, (ks, len(centers), ks, len(centers)))
    mask = inside_fn(px, py)
    areas = mask.sum((1, 3)).astype(np.float64) * sub**2
    s = areas.sum()
    if s > 0:
        areas /= s
    return areas


def ker_rect(radius: float, ks: int):
    """Half-rect DP kernel (DPDNet baseline): left = lower half of a
    2r x 2r square around the kernel center."""
    c = ks / 2.0

    def inside(x, y):
        return (x >= c - radius) & (x <= c + radius) & (y >= c - radius) & (y <= c)

    k = _subgrid_area(ks, inside)
    return k, np.flip(k)


def ker_disk(radius: float, ks: int):
    """Disk-autocorrelation DP kernel (Modeling baseline): accumulate
    products of the disk with x-shifted copies of itself."""
    c = ks / 2.0
    r = abs(radius)

    def inside(x, y):
        return (x - c) ** 2 + (y - c) ** 2 <= r**2

    circ = _subgrid_area(ks, inside)
    disk = np.zeros_like(circ)
    for i in np.arange(0, 2 * r + 2):
        shifted = np.zeros_like(circ)
        s = int(np.sign(radius) * i)
        if s == 0:
            shifted = circ
        elif s > 0:
            shifted[:, s:] = circ[:, :-s] if s < ks else 0
        else:
            shifted[:, :s] = circ[:, -s:] if -s < ks else 0
        disk += circ * shifted
    tot = disk.sum()
    if tot > 0:
        disk = 0.5 * disk / tot
    return disk, np.flip(disk)


def _butterworth_high(ks: int, cutoff: float, order: float) -> np.ndarray:
    x = np.arange(ks, dtype=float)
    y = x[:, None]
    x0 = y0 = ks // 2
    term = (((x - x0) ** 2 + (y - y0) ** 2) / cutoff**2) ** order
    return term / (1 + term)


def bw_kernel_generator(k_size: int, order: float, cut_off_factor: float,
                        beta: float, smooth_strength: float):
    """Butterworth-shaped DP kernels (Learn2Reduce baseline). Returns
    (center, left, right), each sum-normalized."""
    circle = np.zeros((k_size, k_size))
    cvops.circle_filled(circle, k_size // 2, k_size // 2, k_size // 2, 1.0)

    k_gauss = round(k_size / smooth_strength) + 1
    if k_gauss % 2 == 0:
        k_gauss += 1
    sigma = 0.3 * ((k_gauss - 1) * 0.5 - 1) + 0.8
    pad = k_gauss // 2

    decay = np.arange(0, k_size + 2 * pad, dtype=float)[None, :]
    decay = np.ones((k_size + 2 * pad, 1)) @ decay
    decay = (decay - decay.min()) / (decay.max() - decay.min())

    cutoff = (k_size - 1) / cut_off_factor
    kb = _butterworth_high(k_size, cutoff, order)
    kb = (1.0 - beta) / (kb.max() - kb.min()) * (kb - kb.min()) + beta
    kc = circle * kb
    kc_pad = np.pad(kc, pad)
    blur_c = cvops.gaussian_blur(kc_pad, k_gauss, sigma)
    blur_l = blur_c * decay
    blur_r = np.flip(blur_l)
    return (blur_c / blur_c.sum(), blur_l / blur_l.sum(), blur_r / blur_r.sum())


@lru_cache(maxsize=8)
def rect_lut(ks: int, radius_step: float = 0.5) -> np.ndarray:
    """[n_buckets, 2, ks, ks] LUT over radii arange(step, ks, step)."""
    rads = np.arange(radius_step, ks, radius_step)
    return np.stack([np.stack(ker_rect(r, ks)) for r in rads]).astype(np.float32)


@lru_cache(maxsize=8)
def disk_lut(ks: int, radius_step: float = 0.5) -> np.ndarray:
    rads = np.arange(radius_step, ks, radius_step)
    return np.stack([np.stack(ker_disk(r, ks)) for r in rads]).astype(np.float32)


@lru_cache(maxsize=8)
def l2r_lut(ks: int) -> np.ndarray:
    """[n_diam, 2, ks, ks] LUT over odd CoC pixel diameters 1..2ks-1
    (reference psfnet.py:501-513 with the delta kernel at diameter 1)."""
    kernels = []
    for d in range(1, 2 * ks + 1, 2):
        if d == 1:
            k = np.zeros((ks, ks), np.float32)
            k[ks // 2, ks // 2] = 1.0
            kernels.append(np.stack([k, k]))
        else:
            order, cut_off_factor, beta, smooth = 3, 2.5, 0.2, 3
            _, kl, kr = bw_kernel_generator(d, order, cut_off_factor, beta, smooth)
            kernels.append(np.stack([_psf_crop(kl, ks), _psf_crop(kr, ks)]))
    return np.stack(kernels).astype(np.float32)


def _psf_crop(kernel: np.ndarray, psf_size: int) -> np.ndarray:
    """Center-crop or pad a kernel to psf_size, renormalized
    (reference psfnet.py:486-499)."""
    psf = np.zeros((psf_size, psf_size))
    kc, pc = kernel.shape[0] // 2, psf_size // 2
    lo, hi = abs(kc - pc), abs(kc + pc) + 1
    if kc >= pc:
        psf = kernel[lo:hi, lo:hi].copy()
    else:
        psf[lo:hi, lo:hi] = kernel
    psf /= psf.sum()
    return psf
