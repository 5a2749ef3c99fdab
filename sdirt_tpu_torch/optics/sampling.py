"""Ray-bundle generators (counterpart of sdirt_tpu/optics/sampling.py).

Randomness comes from a ``torch.Generator``; the numbers are drawn on the
generator's device and moved to the target device. torch and ``jax.random``
give different numbers from the same seed, so every sampler also takes its
samples explicitly (the pupil points ``xy`` [n, 2], or the uniform draws
themselves), which is how the tests feed both packages the same rays.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.rays import Rays


def _f32(x, device):
    """A float32 tensor on ``device`` from a tensor or an array (copied)."""
    if torch.is_tensor(x):
        return x.to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(x), dtype=torch.float32, device=device)


def _rand(generator, shape, device):
    return torch.rand(shape, generator=generator,
                      device=generator.device).to(device)


def sample_disk(generator, shape, radius, device="cpu"):
    """Uniform samples on a disk of the given radius, shape [..., 2]:
    angle first, then radius, from one generator."""
    theta = _rand(generator, shape, device) * 2.0 * math.pi
    r = torch.sqrt(_rand(generator, shape, device) * radius ** 2)
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)


def sample_from_points(points, spp: int, pupilz, pupilr, generator=None,
                       xy=None) -> Rays:
    """spp rays per point source through the entrance pupil disk.

    points: [N, 3] object positions [mm]. xy: [spp, 2] pupil points [mm]
    (drawn from ``generator`` on the disk of radius pupilr when None).
    Returns rays of shape [spp, N]; each pupil point is shared by all the
    points.
    """
    points = torch.as_tensor(points, dtype=torch.float32)
    dev = points.device
    if xy is None:
        xy = sample_disk(generator, (spp,), pupilr, dev)
    xy = torch.as_tensor(xy, dtype=torch.float32, device=dev)
    if xy.shape != (spp, 2):
        raise ValueError(f"pupil samples must be [{spp}, 2], got {tuple(xy.shape)}")
    o = points[None].expand(spp, *points.shape)
    z = torch.full((spp, 1), float(pupilz), dtype=torch.float32, device=dev)
    o2 = torch.cat([xy, z], dim=-1)
    return Rays.create(o, o2[:, None, :] - o)


def sample_from_points_grid(points, M: int, pupilz: float, pupilr: float) -> Rays:
    """M x M Cartesian pupil-grid quadrature rays per point source, [M*M, N].

    A regular grid integrates the pupil field properly, as COHERENT
    integration needs (random samples of a fast-varying phase give
    speckle). Samples outside the pupil disk are invalidated through ra.
    """
    points = torch.as_tensor(points, dtype=torch.float32)
    dev = points.device
    lin = (torch.arange(M, dtype=torch.float32, device=dev) + 0.5) / M * 2.0 - 1.0
    gy, gx = torch.meshgrid(lin * pupilr, lin * pupilr, indexing="ij")
    xy2 = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)
    inside = (xy2 ** 2).sum(-1) <= pupilr ** 2
    o = points[None].expand(M * M, *points.shape)
    z = torch.full((M * M, 1), float(pupilz), dtype=torch.float32, device=dev)
    rays = Rays.create(o, torch.cat([xy2, z], dim=-1)[:, None, :] - o)
    return rays.replace(ra=rays.ra * inside[:, None].to(rays.ra.dtype))


def stratified_shape(res, spp: int, num_angle: int = 8):
    """The shape of each of the two uniform draws of
    sample_pupil_stratified: (num_angle, spp // num_angle, H, W) when the
    samples are stratified, else (spp, H, W) (plain disk samples)."""
    H, W = res
    if spp % num_angle != 0 or spp >= 10000:
        return (spp, H, W)
    return (num_angle, spp // num_angle, H, W)


def sample_pupil_stratified(res, spp: int, pupilr: float, pupilz: float,
                            num_angle: int = 8, generator=None, draws=None,
                            device="cpu") -> torch.Tensor:
    """Points on the pupil, [spp, H, W, 3], stratified in (angle, r^2)
    sectors when spp divides into num_angle sectors (and spp < 10000),
    else uniform on the disk.

    draws: the two uniform arrays (angle, r^2), each of stratified_shape;
    drawn from ``generator`` (angle first) when None.
    """
    shape = stratified_shape(res, spp, num_angle)
    if draws is None:
        draws = (_rand(generator, shape, device), _rand(generator, shape, device))
    ua, ur = (_f32(u, device) for u in draws)
    if ua.shape != shape or ur.shape != shape:
        raise ValueError(f"pupil draws must be {shape}, got {tuple(ua.shape)}, "
                         f"{tuple(ur.shape)}")
    if len(shape) == 3:
        theta = ua * 2.0 * math.pi
        r = torch.sqrt(ur * pupilr ** 2)
        xy = torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)
    else:
        num_r2 = shape[1]
        dth = ua * 2 * math.pi / num_angle
        dr2 = ur * pupilr ** 2 / num_r2
        i = torch.arange(num_angle, dtype=torch.float32, device=device)[:, None, None, None]
        j = torch.arange(num_r2, dtype=torch.float32, device=device)[None, :, None, None]
        theta = dth + i * 2 * math.pi / num_angle
        r = torch.sqrt(dr2 + j * pupilr ** 2 / num_r2)
        xy = torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)
        xy = xy.reshape(spp, *res, 2)
    z = torch.full((*xy.shape[:-1], 1), float(pupilz), dtype=torch.float32,
                   device=device)
    return torch.cat([xy, z], dim=-1)


def sample_parallel(fov_deg: float, M: int, pupilz: float, pupilr: float,
                    sampling: str = "grid", forward: bool = True, z=None,
                    generator=None, xy=None, device="cpu") -> Rays:
    """Parallel rays over the pupil at an incidence angle, [M, M]: a grid,
    or ``"radial"`` disk samples (``xy`` [M, M, 2], drawn from
    ``generator`` when None); moved to the plane z when given."""
    fov = np.radians(fov_deg)
    if sampling == "grid":
        x, y = np.meshgrid(np.linspace(-pupilr, pupilr, M),
                           np.linspace(pupilr, -pupilr, M), indexing="xy")
        x = torch.tensor(x, dtype=torch.float32, device=device)
        y = torch.tensor(y, dtype=torch.float32, device=device)
    elif sampling == "radial":
        if xy is None:
            xy = sample_disk(generator, (M, M), pupilr, device)
        xy = _f32(xy, device)
        x, y = xy[..., 0], xy[..., 1]
    else:
        raise ValueError(f"Sampling method not implemented: {sampling}")
    o = torch.stack([x, y, torch.full_like(x, pupilz)], dim=-1)
    sgn = 1.0 if forward else -1.0
    d = torch.stack([torch.full_like(x, np.sin(fov)), torch.zeros_like(x),
                     torch.full_like(x, sgn * np.cos(fov))], dim=-1)
    rays = Rays.create(o, d)
    return rays if z is None else rays.propagate_to(z)


def sample_point_source_2d(depth: float, view: float = 0.0, M: int = 9,
                           pupil=(0.0, 1.0), start_z: float = -0.1,
                           device="cpu") -> Rays:
    """2D point-source fan aimed at the pupil, moved to start_z."""
    pupilz, pupilr = pupil
    x2 = np.linspace(-pupilr, pupilr, M) * 0.99
    o2 = np.stack([x2, np.zeros(M), np.full(M, pupilz)], axis=-1)
    o1 = np.zeros_like(o2)
    o1[:, 2] = depth
    o1[:, 0] = depth * np.tan(view / 57.3)
    rays = Rays.create(o1.astype(np.float32), (o2 - o1).astype(np.float32),
                       device=device)
    return rays.propagate_to(start_z)


def sample_sensor(sensor_res, sensor_size, d_sensor: float, spp: int,
                  pupilz: float, pupilr: float, generator=None, draws=None,
                  device="cpu") -> Rays:
    """Backward rays from every sensor pixel (its bottom-right corner)
    through the exit pupil, [spp, H, W]; the pupil points as in
    sample_pupil_stratified."""
    H, W = sensor_res
    xs = torch.linspace(-sensor_size[1] / 2, sensor_size[1] / 2, W + 1,
                        device=device)[1:]
    ys = torch.linspace(sensor_size[0] / 2, -sensor_size[0] / 2, H + 1,
                        device=device)[1:]
    y1, x1 = torch.meshgrid(ys, xs, indexing="ij")
    o1 = torch.stack([x1, y1, torch.full_like(x1, d_sensor)], dim=-1)
    o2 = sample_pupil_stratified((H, W), spp, pupilr, pupilz, generator=generator,
                                 draws=draws, device=device)
    o1 = o1[None].expand(o2.shape)
    return Rays.create(o1, o2 - o1)


def surface_sample(n: int, radius: float, z: float, generator=None, xy=None,
                   device="cpu") -> torch.Tensor:
    """Uniform points on a surface's vertex plane, [n, 3]."""
    if xy is None:
        xy = sample_disk(generator, (n,), radius, device)
    xy = torch.as_tensor(xy, dtype=torch.float32, device=device)
    return torch.cat([xy, torch.full((n, 1), z, dtype=torch.float32,
                                     device=device)], dim=-1)


def sample_parallel_2d(R=None, view: float = 0.0, M: int = 15, z: float = 0.0,
                       forward: bool = True, pupil=None, device="cpu") -> Rays:
    """2D fan of parallel rays for paraxial calculations; pupil: optional
    (pupilz, pupilr)."""
    view_rad = view / 57.3
    if pupil is not None:
        pupilz, pupilr = pupil
        x2 = np.linspace(-pupilr, pupilr, M) * 0.99
        o2 = np.stack([x2, np.zeros(M), np.full(M, pupilz)], axis=-1)
        d = np.stack([np.full(M, np.sin(view_rad)), np.zeros(M),
                      np.full(M, np.cos(view_rad))], -1)
        o = o2 - d * ((o2[:, 2:3] + 0.1) / d[:, 2:3]) if pupilz > 0 else o2
        return Rays.create(o.astype(np.float32), d.astype(np.float32), device=device)
    x = np.linspace(-R, R, M)
    o = np.stack([x, np.zeros(M), np.full(M, z)], axis=-1)
    dz = np.cos(view_rad) if forward else -np.cos(view_rad)
    d = np.stack([np.full(M, np.sin(view_rad)), np.zeros(M), np.full(M, dz)], axis=-1)
    return Rays.create(o.astype(np.float32), d.astype(np.float32), device=device)


def point_source_grid(depth: float, grid: int = 9, center: bool = False) -> np.ndarray:
    """Normalised [-1, 1]^2 point grid at a depth, [grid, grid, 3]."""
    if grid == 1:
        x = y = np.array([[0.0]])
    elif center:
        hb = 1 / 2 / (grid - 1)
        x, y = np.meshgrid(np.linspace(-1 + hb, 1 - hb, grid),
                           np.linspace(1 - hb, -1 + hb, grid), indexing="xy")
    else:
        x, y = np.meshgrid(np.linspace(-0.98, 0.98, grid),
                           np.linspace(0.98, -0.98, grid), indexing="xy")
    z = np.full_like(x, depth)
    return np.stack([x, y, z], axis=-1).astype(np.float32)
