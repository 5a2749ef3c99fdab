"""Weight-free perceptual image distance: MS-SSIM + GMSD
(PyTorch counterpart of sdirt_tpu/dfdp/perceptual.py).

The third flat-capture score beside PSNR and SSIM: (1 - MS-SSIM) (Wang et
al. 2003) plus the gradient-magnitude similarity deviation (Xue et al.
2014), two classical full-reference metrics with no learned parameters, in
place of LPIPS's VGG weights. Images are [N, C, H, W] float in [0, 1]; the
distance is 0 for identical images and grows with degradation (not on the
LPIPS scale). Everything is differentiable torch.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# MS-SSIM per-scale weights (Wang 2003, table 1)
_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)
_PREWITT = np.array([[1, 0, -1], [1, 0, -1], [1, 0, -1]], np.float32) / 3.0


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size) - (size - 1) / 2.0
    g = np.exp(-(x**2) / (2 * sigma**2))
    w = np.outer(g, g)
    return (w / w.sum()).astype(np.float32)


def _filter2(img, win):
    """Depthwise valid-mode 2-D correlation of [N, C, H, W] with one window."""
    c = img.shape[1]
    return F.conv2d(img, win.expand(c, 1, *win.shape[-2:]), groups=c)


def _ssim_components(x, y, win, c1, c2):
    mu_x, mu_y = _filter2(x, win), _filter2(y, win)
    mu_xx, mu_yy, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sigma_x = _filter2(x * x, win) - mu_xx
    sigma_y = _filter2(y * y, win) - mu_yy
    sigma_xy = _filter2(x * y, win) - mu_xy
    lum = (2 * mu_xy + c1) / (mu_xx + mu_yy + c1)
    cs = (2 * sigma_xy + c2) / (sigma_x + sigma_y + c2)
    return lum, cs


def _downsample2(img):
    """2x average pool, cut to an even size first."""
    h, w = img.shape[-2:]
    img = img[:, :, : h - h % 2, : w - w % 2]
    return 0.25 * (img[:, :, ::2, ::2] + img[:, :, 1::2, ::2]
                   + img[:, :, ::2, 1::2] + img[:, :, 1::2, 1::2])


def ms_ssim(img, img_clean, levels: int = 5):
    """Multi-scale SSIM over ``levels`` dyadic scales; a scalar in (0, 1]."""
    x, y = img.float(), img_clean.float()
    win = torch.from_numpy(_gaussian_window()).to(x.device)
    c1, c2 = 0.01**2, 0.03**2
    weights = torch.tensor(_MSSSIM_WEIGHTS[:levels], device=x.device)
    weights = weights / weights.sum()
    vals = []
    for lvl in range(levels):
        lum, cs = _ssim_components(x, y, win, c1, c2)
        vals.append((lum if lvl == levels - 1 else cs).mean())
        if lvl < levels - 1:
            x, y = _downsample2(x), _downsample2(y)
    # clamped so the fractional-power mean stays real on adversarial pairs
    vals = torch.clamp(torch.stack(vals), min=1e-6)
    return torch.prod(vals ** weights)


def _grad_mag(img):
    """Prewitt gradient magnitude of a [N, 1, H, W] luminance image."""
    kx = torch.from_numpy(_PREWITT).to(img.device)[None, None]
    gx, gy = F.conv2d(img, kx), F.conv2d(img, kx.transpose(-1, -2))
    return torch.sqrt(gx * gx + gy * gy + 1e-12)


def _luminance(img):
    if img.shape[1] == 3:
        w = torch.tensor([0.299, 0.587, 0.114], device=img.device)
        return torch.einsum("nchw,c->nhw", img, w)[:, None]
    return img.mean(dim=1, keepdim=True)


def gmsd(img, img_clean):
    """Gradient-magnitude similarity deviation; 0 for identical images."""
    c = 0.0026  # Xue 2014's c = 170 rescaled from [0, 255] to [0, 1]
    g1 = _grad_mag(_luminance(img.float()))
    g2 = _grad_mag(_luminance(img_clean.float()))
    gms = (2 * g1 * g2 + c) / (g1 * g1 + g2 * g2 + c)
    return torch.std(gms, correction=0)


def perceptual_distance(img, img_clean, levels: int = 5):
    """(1 - MS-SSIM) + GMSD: 0 iff the images match."""
    return (1.0 - ms_ssim(img, img_clean, levels)) + gmsd(img, img_clean)


def max_levels(h: int, w: int) -> int:
    """The most dyadic scales (up to 5) that keep the 11x11 window valid."""
    lv = 1
    while lv < 5 and min(h, w) // 2**lv >= 11:
        lv += 1
    return lv


def batch_perceptual(img, img_clean) -> float:
    """Batch mean as a float, from arrays or tensors, [C, H, W] or
    [N, C, H, W] (on the device of ``img`` when it is a tensor)."""
    img = torch.as_tensor(img, dtype=torch.float32)
    img_clean = torch.as_tensor(img_clean, dtype=torch.float32,
                                device=img.device)
    if img.dim() == 3:
        img, img_clean = img[None], img_clean[None]
    lv = max_levels(img.shape[-2], img.shape[-1])
    return float(perceptual_distance(img, img_clean, lv))
