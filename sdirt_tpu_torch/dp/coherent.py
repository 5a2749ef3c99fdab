"""Coherent (interference-aware) PSF accumulation (counterpart of
sdirt_tpu/dp/coherent.py).

The complex deposit sum w e^{i phi} is carried as two real accumulations,
w cos(phi) and w sin(phi), through the same one-hot matmul splat the DP
integrator uses (dp/splat.py:splat_matmul with the views Re, Im and the
plain ray energy); the intensity is re^2 + im^2. The phase is rays.phi,
which the coherent trace reduces per surface (core/rays.py): the dropped
common path is a global phase and cancels in |A|^2.

Usage: trace with ``trace_rays(..., coherent=True, n_in=lens.n_in_array(...),
wvln=...)``, propagate to the sensor with ``propagate_to(d_sensor,
wvln=...)``, then call ``coherent_psf(out.o, out.ra, out.phi, ...)``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..optics.surfaces import trace_rays
from .splat import splat_matmul


def coherent_psf_pair(o_sensor, ra, phi, ks: int, ps, pointc_ref=None,
                      chunk: int = 4096):
    """Coherent and incoherent intensity PSFs from the same traced rays.

    o_sensor [spp, N, 3] positions at the sensor plane [mm]; ra [spp, N];
    phi [spp, N] the reduced phase of the coherent trace (never the phase
    of the total f32 OPL); pointc_ref [N, 2] PSF centres, None for the
    energy centroid. Returns (coherent, incoherent) [N, ks, ks], both
    unnormalised.
    """
    # ps as an f32 0-d tensor, as dp_psf's lens scalars carry it
    ps = torch.as_tensor(ps, dtype=torch.float32)
    points = -o_sensor[..., :2]                  # the sensor flip
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
    amp = torch.stack([ra_m * torch.cos(phi), ra_m * torch.sin(phi), ra_m], dim=0)
    grids = splat_matmul(shifted, amp, ks, ps, chunk=chunk)
    return grids[0] ** 2 + grids[1] ** 2, grids[2]


def coherent_psf(o_sensor, ra, phi, ks: int, ps, pointc_ref=None, chunk: int = 4096):
    """The coherent intensity PSF only (coherent_psf_pair)."""
    return coherent_psf_pair(o_sensor, ra, phi, ks, ps, pointc_ref=pointc_ref,
                             chunk=chunk)[0]


@torch.no_grad()
def coherent_psf_grid(lens, depth: float, grid: int = 3, ks: int = 21,
                      M: int = 256, wvln: float = 0.589, ps=None):
    """A grid x grid field of coherent and incoherent PSFs at the object
    depth ``depth`` (mm, negative), traced with phase from an M x M
    regular pupil quadrature (random pupil samples of a phase that turns
    many times across the pupil give speckle; M must keep the phase step
    between neighbours under ~pi). ps: the analysis pixel pitch [mm], the
    sensor pixel by default (f/4 rings live at the few-micron scale).

    Returns (coherent, incoherent) [grid, grid, ks, ks], each PSF
    max-normalised.
    """
    ps = lens.pixel_size if ps is None else ps
    x_half = 0.85 * abs(depth) * np.tan(lens.hfov)
    lin = np.linspace(-x_half, x_half, grid) if grid > 1 else np.zeros(1)
    xx, yy = np.meshgrid(lin, lin * lens.sensor_size[0] / lens.sensor_size[1])
    points = np.stack([xx.ravel(), yy.ravel(),
                       np.full(grid * grid, depth)], -1).astype(np.float32)
    rays = lens.sample_from_points_grid(points, M=M)
    eta, skip = lens.eta_arrays(wvln, True)
    out = trace_rays(rays, lens.stack, eta, skip, n_in=lens.n_in_array(wvln, True),
                     coherent=True, wvln=wvln).propagate_to(lens.d_sensor, wvln=wvln)
    coh, inc = coherent_psf_pair(out.o, out.ra, out.phi, ks, ps)
    coh = coh / (coh.amax(dim=(-1, -2), keepdim=True) + 1e-12)
    inc = inc / (inc.amax(dim=(-1, -2), keepdim=True) + 1e-12)
    return coh.reshape(grid, grid, ks, ks), inc.reshape(grid, grid, ks, ks)
