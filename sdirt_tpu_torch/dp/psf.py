"""End-to-end dual-pixel PSF computation (PyTorch counterpart of
sdirt_tpu/dp/psf.py): point sources -> pupil samples -> trace -> chief-ray
centre -> DP split -> splat -> max-normalised L/R PSFs.

``dp_psf`` traces with the differentiable per-surface trace
(optics/surfaces.py), or, given the lens's static description, with the
specialised value-only trace; ``dp_psf_fused`` with K1 (dp/fused_trace.py),
the trace the fit uses. Both draw the chief bundle first and then the main one
from a ``torch.Generator``, or take the pupil samples explicitly
(``pupil_chief`` on the shrunken pupil, ``pupil_main`` on the full one,
[n, 2] mm): the JAX code splits one key into the two, which no torch
generator repeats, so the tests hand both packages the same samples.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..core.constants import GEO_SPP, WAVE_RGB
from ..optics.sampling import sample_from_points
from ..optics.surfaces import trace_rays, trace_rays_specialized
from .splat import DPParams, dp_split_weights, forward_integral, splat_matmul


def object_points(points_norm, scalars):
    """Perspective projection of normalised points to object space [mm];
    x spans the sensor width, y its height."""
    depth = points_norm[:, 2]
    scale = -depth * torch.tan(scalars["hfov"]) / scalars["r_last"]
    return torch.stack([points_norm[:, 0] * scale * scalars["sensor_w"] / 2,
                        points_norm[:, 1] * scale * scalars["sensor_h"] / 2,
                        depth], dim=-1)


def _max_norm(p):
    return p / (p.amax(dim=(-1, -2), keepdim=True) + 1e-6)


def dp_psf(stack, eta, skip, points_norm, generator, scalars, *, spp: int,
           ks: int, spp_chief: int = GEO_SPP, center: bool = True,
           dp_params: DPParams = DPParams(), chunk: int = 2048,
           pupil_main=None, pupil_chief=None, static_desc=None):
    """DP PSFs of normalised point sources through the per-surface trace,
    or the specialised one when ``static_desc`` (Lens.static_desc()) is
    given.

    points_norm: [N, 3], x, y in [-1, 1] (sensor-normalised) and z = depth
    in mm (negative). scalars: lens_scalars(lens). Returns (psf_l, psf_r)
    [N, ks, ks], each max-normalised.
    """
    points_norm = torch.as_tensor(points_norm, dtype=torch.float32)
    point_obj = object_points(points_norm, scalars)
    pupilz, pupilr = scalars["pupilz"], scalars["pupilr"]
    d_sensor = scalars["d_sensor"]

    def trace(r):
        if static_desc is not None:
            return trace_rays_specialized(r, static_desc, eta).propagate_to(d_sensor)
        return trace_rays(r, stack, eta, skip).propagate_to(d_sensor)

    if center:
        # chief-ray centre: the shrunken pupil (x0.25), centroid of survivors
        chief = trace(sample_from_points(point_obj, spp_chief, pupilz,
                                         pupilr * 0.25, generator, pupil_chief))
        denom = chief.ra.sum(0)[..., None] + 1e-9
        pointc = -((chief.o * chief.ra[..., None]).sum(0) / denom)[..., :2]
    else:
        pointc = torch.stack([points_norm[:, 0] * scalars["sensor_w"] / 2,
                              points_norm[:, 1] * scalars["sensor_h"] / 2], dim=-1)
    rays = trace(sample_from_points(point_obj, spp, pupilz, pupilr, generator,
                                    pupil_main))
    psf_l, psf_r = forward_integral(rays.o, rays.d, rays.ra, ks=ks,
                                    ps=scalars["ps"], pointc_ref=pointc,
                                    dp_params=dp_params, chunk=chunk)
    return _max_norm(psf_l), _max_norm(psf_r)


def dp_psf_fused(points_norm, generator, scalars, plan, *, spp: int, ks: int,
                 spp_chief: int = GEO_SPP, center: bool = True,
                 dp_params: DPParams = DPParams(), chunk: int = 2048,
                 pupil_main=None, pupil_chief=None, trace=None, rays_group=None):
    """dp_psf with both traces (chief and main bundle) through K1.

    plan: fused_trace.make_fused_plan(lens) (surfaces + per-surface eta).
    trace: K1's wrapper by default; the check on the card passes the plain
    version (fused_trace.fused_trace_sensor_ref) to compare the two.
    rays_group: a torch.distributed group over which the main bundle's rays
    are split (parallel/steps.py). Every rank draws the same spp pupil
    samples and traces its contiguous share of them; the raw splat grids
    are summed over the group before the max-normalisation, so every rank
    returns the PSFs of all spp rays. The chief bundle is traced whole on
    every rank, as the JAX package leaves it unsharded.
    """
    from .fused_trace import fused_trace_sensor

    trace = fused_trace_sensor if trace is None else trace

    points_norm = torch.as_tensor(points_norm, dtype=torch.float32)
    point_obj = object_points(points_norm, scalars)
    pupilz, pupilr = scalars["pupilz"], scalars["pupilr"]
    d_sensor, ps = scalars["d_sensor"], scalars["ps"]

    if center:
        chief = sample_from_points(point_obj, spp_chief, pupilz, pupilr * 0.25,
                                   generator, pupil_chief)
        cpx, cpy, _, cra = trace(chief, d_sensor, plan)
        denom = cra.sum(0) + 1e-9
        # px / py are already the flipped sensor coordinates, so the
        # weighted mean is dp_psf's pointc (= -centroid of o)
        pointc = torch.stack([(cpx * cra).sum(0) / denom,
                              (cpy * cra).sum(0) / denom], dim=-1)
    else:
        pointc = torch.stack([points_norm[:, 0] * scalars["sensor_w"] / 2,
                              points_norm[:, 1] * scalars["sensor_h"] / 2], dim=-1)

    rays = sample_from_points(point_obj, spp, pupilz, pupilr, generator, pupil_main)
    if rays_group is not None:
        n, r = dist.get_world_size(rays_group), dist.get_rank(rays_group)
        if spp % n:
            raise ValueError(f"{spp} rays do not split over {n} rays ranks")
        share = spp // n
        rays = rays.replace(o=rays.o[r * share:(r + 1) * share],
                            d=rays.d[r * share:(r + 1) * share],
                            ra=rays.ra[r * share:(r + 1) * share])
    px, py, x_tan, ra = trace(rays, d_sensor, plan)

    # forward_integral's body on the pre-flipped outputs
    shifted = torch.stack([px, py], dim=-1) - pointc[None]
    half = (ks / 2 - 0.5) * ps
    inside = ((torch.abs(shifted[..., 0]) < (half - 0.01 * ps))
              & (torch.abs(shifted[..., 1]) < (half - 0.01 * ps)))
    ra_m = ra * inside.to(ra.dtype)
    shifted = shifted * ra_m[..., None]
    w_l, w_r = dp_split_weights(x_tan, dp_params)
    weights = torch.stack([w_l * ra_m, w_r * ra_m], dim=0)
    psf = splat_matmul(shifted, weights, ks, ps, chunk=chunk)
    if rays_group is not None:
        dist.all_reduce(psf, group=rays_group)
    return _max_norm(psf[0]), _max_norm(psf[1])


def lens_scalars(lens) -> dict:
    """The lens scalars dp_psf reads, as f32 0-d tensors on the CPU (torch
    combines them with tensors on any device)."""
    pupilz, pupilr = lens.entrance_pupil()
    values = {"pupilz": pupilz, "pupilr": pupilr, "d_sensor": lens.d_sensor,
              "ps": lens.pixel_size, "hfov": lens.hfov, "r_last": lens.r_last,
              "sensor_h": lens.sensor_size[0], "sensor_w": lens.sensor_size[1]}
    return {k: torch.tensor(v, dtype=torch.float32) for k, v in values.items()}


def compute_psf(lens, points_norm, generator=None, spp: int = GEO_SPP,
                ks: int = 31, wvln: float = 0.589, center: bool = True,
                dp_params: DPParams = DPParams(), both: bool = False,
                pupils=(None, None)):
    """PSFs of one lens at one wavelength through the per-surface trace:
    the LEFT PSF [N, ks, ks], or the (L, R) pair when both=True. pupils:
    (pupil_main, pupil_chief) as dp_psf takes them, drawn from
    ``generator`` where None."""
    if generator is None:
        generator = torch.Generator(device=lens.device).manual_seed(0)
    eta, skip = lens.eta_arrays(wvln, True)
    points = torch.as_tensor(points_norm, dtype=torch.float32, device=lens.device)
    psf_l, psf_r = dp_psf(lens.stack, eta, skip, points, generator,
                          lens_scalars(lens), spp=spp, ks=ks, center=center,
                          dp_params=dp_params, pupil_main=pupils[0],
                          pupil_chief=pupils[1])
    return (psf_l, psf_r) if both else psf_l


def compute_psf_rgb(lens, points_norm, generator=None, spp: int = GEO_SPP,
                    ks: int = 31, center: bool = True,
                    dp_params: DPParams = DPParams(), pupils=None):
    """RGB PSF stack [N, 3, ks, ks], one wavelength after another from one
    generator; pupils: one (pupil_main, pupil_chief) pair per wavelength
    (WAVE_RGB order), or None to draw them all."""
    if generator is None:
        generator = torch.Generator(device=lens.device).manual_seed(0)
    pupils = [(None, None)] * len(WAVE_RGB) if pupils is None else pupils
    psfs = [compute_psf(lens, points_norm, generator, spp=spp, ks=ks, wvln=w,
                        center=center, dp_params=dp_params, pupils=pp)
            for w, pp in zip(WAVE_RGB, pupils)]
    return torch.stack(psfs, dim=-3)
