"""Ray-bundle generators (counterpart of sdirt_tpu/optics/sampling.py).

Randomness comes from a ``torch.Generator``; the numbers are drawn on the
generator's device and moved to the target device. torch and ``jax.random``
give different numbers from the same seed, so every sampler also takes its
samples explicitly (the pupil points ``xy`` [n, 2]), which is how the tests
feed both packages the same rays.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.rays import Rays


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
