"""Ray bundles as a small dataclass of tensors (counterpart of
sdirt_tpu/core/rays.py, incoherent part only).

A bundle is immutable: every transform returns a new one. ``o`` [..., 3]
positions [mm], ``d`` [..., 3] unit directions, ``ra`` [...] validity
(1 live / 0 dead).
"""

from __future__ import annotations

import dataclasses

import torch


def normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalise along the last axis."""
    n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return v / torch.clamp(n, min=eps)


@dataclasses.dataclass(frozen=True)
class Rays:
    o: torch.Tensor
    d: torch.Tensor
    ra: torch.Tensor

    @staticmethod
    def create(o, d, ra=None, device=None) -> "Rays":
        o = torch.as_tensor(o, dtype=torch.float32, device=device)
        d = normalize(torch.as_tensor(d, dtype=torch.float32, device=o.device))
        if ra is None:
            ra = torch.ones(o.shape[:-1], dtype=torch.float32, device=o.device)
        else:
            ra = torch.as_tensor(ra, dtype=torch.float32, device=o.device)
        return Rays(o=o, d=d, ra=ra)

    def propagate_to(self, z) -> "Rays":
        """Move every ray to the plane at depth z."""
        t = (z - self.o[..., 2]) / self.d[..., 2]
        return dataclasses.replace(self, o=self.o + self.d * t[..., None])

    def replace(self, **kw) -> "Rays":
        return dataclasses.replace(self, **kw)
