"""Depth and image-quality metrics, host-side numpy (copied from
sdirt_tpu/dfdp/metrics.py; formulas kept literal). PSNR and SSIM use
skimage's conventions on uint8-rounded images."""

from __future__ import annotations

import numpy as np

# ================================
# Depth metrics over a validity mask
# ================================


def mask_abs_rel(est_depth, gt_depth, mask):
    return np.mean(np.abs(gt_depth[mask] - est_depth[mask]) / gt_depth[mask])


def mask_sq_rel(est_depth, gt_depth, mask):
    return np.mean(np.power(gt_depth[mask] - est_depth[mask], 2) / gt_depth[mask])


def mask_mse(est_depth, gt_depth, mask):
    return np.mean(np.power(gt_depth[mask] - est_depth[mask], 2))


def mask_mae(est_depth, gt_depth, mask):
    return np.mean(np.abs(gt_depth[mask] - est_depth[mask]))


def mask_rmse(est_depth, gt_depth, mask):
    return np.sqrt(np.mean(np.power(est_depth[mask] - gt_depth[mask], 2)))


def mask_rmse_log(est_depth, gt_depth, mask):
    gt, est = np.log(gt_depth[mask]), np.log(est_depth[mask])
    return np.sqrt(np.mean(np.power(gt - est, 2)))


def mask_accuracy_k(est_depth, gt_depth, k, mask):
    a = est_depth[mask] / (gt_depth[mask] + 1e-6)
    b = gt_depth[mask] / (est_depth[mask] + 1e-6)
    thresh = np.maximum(a, b)
    return np.sum(np.where(thresh < 1.25**k, 1, 0)) / np.sum(mask)


# ================================
# Image metrics (uint8 rounding: mul(255).add(0.5).clamp.uint8)
# ================================

def _to_uint8(img01):
    return np.clip(img01 * 255.0 + 0.5, 0, 255).astype(np.uint8)


def psnr_uint8(clean, noisy):
    m = np.mean((clean.astype(np.float64) - noisy.astype(np.float64)) ** 2)
    if m == 0:
        return np.inf
    return 10 * np.log10(255.0**2 / m)


def ssim_uint8(a, b, channel_axis=0):
    """SSIM with skimage defaults: 7x7 uniform window, K1=.01, K2=.03,
    L=255, per-channel mean."""
    from scipy.ndimage import uniform_filter

    a = np.moveaxis(a.astype(np.float64), channel_axis, 0)
    b = np.moveaxis(b.astype(np.float64), channel_axis, 0)
    c1, c2 = (0.01 * 255) ** 2, (0.03 * 255) ** 2
    win = 7
    pad = win // 2
    vals = []
    for ca, cb in zip(a, b):
        mu_a = uniform_filter(ca, win)
        mu_b = uniform_filter(cb, win)
        saa = uniform_filter(ca * ca, win) - mu_a**2
        sbb = uniform_filter(cb * cb, win) - mu_b**2
        sab = uniform_filter(ca * cb, win) - mu_a * mu_b
        # skimage uses the unbiased (n/(n-1)) covariance normalisation
        np_ = win**2
        cov_norm = np_ / (np_ - 1)
        saa, sbb, sab = saa * cov_norm, sbb * cov_norm, sab * cov_norm
        s = ((2 * mu_a * mu_b + c1) * (2 * sab + c2)) / (
            (mu_a**2 + mu_b**2 + c1) * (saa + sbb + c2))
        vals.append(s[pad:-pad, pad:-pad].mean())
    return float(np.mean(vals))


def batch_PSNR(img, img_clean):
    """img/img_clean: [B, C, H, W] float in [0, 1] (numpy)."""
    a = _to_uint8(np.asarray(img))
    b = _to_uint8(np.asarray(img_clean))
    vals = [psnr_uint8(b[i], a[i]) for i in range(a.shape[0])]
    return round(float(np.mean(vals)), 4)


def batch_SSIM(img, img_clean):
    a = _to_uint8(np.asarray(img))
    b = _to_uint8(np.asarray(img_clean))
    vals = [ssim_uint8(b[i], a[i], channel_axis=0) for i in range(a.shape[0])]
    return round(float(np.mean(vals)), 4)


mask_psnr = batch_PSNR
mask_ssim = batch_SSIM
