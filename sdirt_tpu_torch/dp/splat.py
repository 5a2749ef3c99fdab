"""Dual-pixel PSF accumulation (PyTorch counterpart of sdirt_tpu/dp/splat.py).

Each traced ray lands on the sensor with an incidence slope x_tan; a
microlens of height h and focal length f sits over a split photodiode whose
halves are separated by a gap half-width w inside a pixel of active radius
r. The ray's energy splits between the left and right sub-pixels in closed
form (circular segment areas of the microlens-refracted footprint), and the
ray is deposited bilinearly onto a ks x ks PSF grid.

The bilinear deposit factors into row and column one-hot weights, so the
accumulation over rays is a batched matrix product (``splat_matmul``); a
scatter-add version (``splat_scatter``) cross-checks it. The products run in
full f32: callers on the card keep TF32 off
(``torch.backends.cuda.matmul.allow_tf32 = False``), as the JAX code asks
for ``Precision.HIGHEST``.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class DPParams:
    """Microlens / dual-pixel geometry."""

    h: float = 0.78      # microlens height above the photodiode plane
    f: float = 1.44      # microlens focal length
    w: float = 0.3       # half-width of the sub-pixel gap
    r: float = 0.5       # active pixel radius (units of pixel pitch)
    direct: str = "l"    # which sub-pixel is "left" in the output ordering


def _seg(u):
    """Antiderivative of 2 sin^2: the integral of 2*sqrt(r^2-x^2) with
    x = r*cos(u) is r^2 (u - sin(2u)/2)."""
    return u - 0.5 * torch.sin(2.0 * u)


def dp_split_weights(x_tan: torch.Tensor, p: DPParams = DPParams()):
    """Closed-form left/right energy split per ray from its incidence slope.

    Returns (w_l, w_r) shaped like x_tan. Two regimes: the active radius
    inside the pixel (r <= 0.5) or sticking out of it (r > 0.5).
    """
    h, f, w, r = p.h, p.f, p.w, p.r

    if r <= 0.5:
        # footprint edges after refraction by the microlens
        xr = torch.clamp(w - (f * x_tan - w) * h / (f - h), -r, r)
        xm = torch.clamp(-(f * x_tan) * h / (f - h), -r, r)
        xl = torch.clamp(-w - (f * x_tan + w) * h / (f - h), -r, r)
        ur, um, ul = torch.arccos(xr / r), torch.arccos(xm / r), torch.arccos(xl / r)
        sr_ml = r * r * (_seg(um) - _seg(ur))
        sl_ml = r * r * (_seg(ul) - _seg(um))

        # margin region (rays missing the microlens, straight projection)
        xr2 = torch.clamp(w - h * x_tan, -0.5, 0.5)
        xm2 = torch.clamp(-h * x_tan, -0.5, 0.5)
        xl2 = torch.clamp(-w - h * x_tan, -0.5, 0.5)
        uri = torch.arccos(torch.clamp(xr2, -r, r) / r)
        umi = torch.arccos(torch.clamp(xm2, -r, r) / r)
        uli = torch.arccos(torch.clamp(xl2, -r, r) / r)
        sr_mg = (xr2 - xm2) - r * r * (_seg(umi) - _seg(uri))
        sl_mg = (xm2 - xl2) - r * r * (_seg(uli) - _seg(umi))
    else:
        # the circle sticks out of the pixel: subtract the part of each
        # circular segment beyond |y| = 0.5 (chord at u in [tr, tl])
        tr = math.asin(0.5 / r)
        tl = math.pi - tr

        def seg_minus_overflow(xa, xb):
            ua, ub = torch.arccos(xa / r), torch.arccos(xb / r)
            s = r * r * (_seg(ub) - _seg(ua))
            ua_e = torch.clamp(ua, tr, tl)
            ub_e = torch.clamp(ub, tr, tl)
            xa_e, xb_e = torch.cos(ua_e) * r, torch.cos(ub_e) * r
            s_e = r * r * (_seg(ub_e) - _seg(ua_e)) - (xa_e - xb_e)
            return s - s_e

        xr = torch.clamp(w - (f * x_tan - w) * h / (f - h), -0.5, 0.5)
        xm = torch.clamp(-(f * x_tan) * h / (f - h), -0.5, 0.5)
        xl = torch.clamp(-w - (f * x_tan + w) * h / (f - h), -0.5, 0.5)
        sr_ml = seg_minus_overflow(xr, xm)
        sl_ml = seg_minus_overflow(xm, xl)

        xr2 = torch.clamp(w - h * x_tan, -0.5, 0.5)
        xm2 = torch.clamp(-h * x_tan, -0.5, 0.5)
        xl2 = torch.clamp(-w - h * x_tan, -0.5, 0.5)
        sr_mg = (xr2 - xm2) - seg_minus_overflow(xr2, xm2)
        sl_mg = (xm2 - xl2) - seg_minus_overflow(xm2, xl2)

    w_r = sr_ml + sr_mg
    w_l = sl_ml + sl_mg
    return (w_l, w_r) if p.direct == "l" else (w_r, w_l)


def _bilinear_onehots(points, ks: int, ps):
    """Row / column bilinear one-hot factors [..., ks] of each ray.

    points: [..., 2] PSF-centred sensor offsets. The row index comes from
    y, the column from x, normalised by the (ks-1)-pixel span.
    """
    half = (ks / 2 - 0.5) * ps
    row_f = (half - points[..., 1]) / (2 * half) * (ks - 1)
    col_f = (points[..., 0] + half) / (2 * half) * (ks - 1)
    iy = torch.floor(row_f)[..., None]
    ix = torch.floor(col_f)[..., None]
    wy = row_f[..., None] - iy
    wx = col_f[..., None] - ix
    kk = torch.arange(ks, dtype=points.dtype, device=points.device)
    ohy = (kk == iy) * (1 - wy) + (kk == iy + 1) * wy
    ohx = (kk == ix) * (1 - wx) + (kk == ix + 1) * wx
    return ohy, ohx


def splat_matmul(points, weights, ks: int, ps, chunk: int = 4096):
    """Accumulate rays into PSF grids with batched matrix products.

    points: [spp, N, 2] PSF-centred offsets (already masked / zeroed);
    weights: [V, spp, N] per-ray deposit weights (V views). Returns
    [V, N, ks, ks]: psf[v, n] = sum over rays of (w * ohy)^T ohx, in chunks
    of ``chunk`` rays summed in order.
    """
    spp, n, _ = points.shape
    v = weights.shape[0]
    acc = torch.zeros((v, n, ks, ks), dtype=torch.float32, device=points.device)
    for s0 in range(0, spp, chunk):
        ohy, ohx = _bilinear_onehots(points[s0:s0 + chunk], ks, ps)
        wts = weights[:, s0:s0 + chunk]
        # [V, c, N] x [c, N, ks] x [c, N, ks] -> [V, N, ks, ks]
        a = (wts[..., None] * ohy[None]).permute(2, 0, 3, 1)      # [N, V, ks, c]
        acc += torch.matmul(a, ohx.permute(1, 0, 2)[:, None]).permute(1, 0, 2, 3)
    return acc


def splat_scatter(points, weights, ks: int, ps):
    """Scatter-add version of splat_matmul, to cross-check it; rays whose
    taps fall outside the grid are dropped."""
    half = (ks / 2 - 0.5) * ps
    row_f = (half - points[..., 1]) / (2 * half) * (ks - 1)
    col_f = (points[..., 0] + half) / (2 * half) * (ks - 1)
    iy = torch.floor(row_f).to(torch.int64)
    ix = torch.floor(col_f).to(torch.int64)
    wy = row_f - iy
    wx = col_f - ix
    spp, n = row_f.shape
    v = weights.shape[0]
    nn = torch.arange(n, device=points.device).expand(spp, n)
    grid = torch.zeros((v, n * ks * ks), dtype=torch.float32, device=points.device)
    for dy, dx, wgt in ((0, 0, (1 - wy) * (1 - wx)), (0, 1, (1 - wy) * wx),
                        (1, 0, wy * (1 - wx)), (1, 1, wy * wx)):
        yy, xx = iy + dy, ix + dx
        ok = (yy >= 0) & (yy < ks) & (xx >= 0) & (xx < ks)
        idx = ((nn * ks + yy) * ks + xx)[ok]
        grid.index_add_(1, idx, (weights * wgt[None])[:, ok])
    return grid.reshape(v, n, ks, ks)


def forward_integral(o_sensor, d_sensor, ra, ks: int, ps, pointc_ref=None,
                     dp_params: DPParams = DPParams(), chunk: int = 4096):
    """Monte-Carlo DP PSF accumulation for a batch of point sources.

    o_sensor / d_sensor: [spp, N, 3] ray state at the sensor plane; ra:
    [spp, N] validity; pointc_ref: [N, 2] PSF centres (e.g. chief ray), or
    None for the ray centroid. Returns (psf_l, psf_r): [N, ks, ks] each.
    """
    points = -o_sensor[..., :2]
    if pointc_ref is None:
        denom = ra.sum(0)[..., None] + 1e-9
        pointc = (points * ra[..., None]).sum(0) / denom
    else:
        pointc = torch.as_tensor(pointc_ref, dtype=torch.float32, device=points.device)
    shifted = points - pointc[None]

    half = (ks / 2 - 0.5) * ps
    inside = ((torch.abs(shifted[..., 0]) < (half - 0.01 * ps))
              & (torch.abs(shifted[..., 1]) < (half - 0.01 * ps)))
    ra_m = ra * inside.to(ra.dtype)
    shifted = shifted * ra_m[..., None]

    x_tan = (-d_sensor[..., 0]) / d_sensor[..., 2]
    w_l, w_r = dp_split_weights(x_tan, dp_params)
    weights = torch.stack([w_l * ra_m, w_r * ra_m], dim=0)
    psf = splat_matmul(shifted, weights, ks, ps, chunk=chunk)
    return psf[0], psf[1]
