"""Ray bundles as a small dataclass of tensors (counterpart of
sdirt_tpu/core/rays.py).

A bundle is immutable: every transform returns a new one. ``o`` [..., 3]
positions [mm], ``d`` [..., 3] unit directions, ``ra`` [...] validity
(1 live / 0 dead). A coherent bundle also carries ``opl`` [...], the optical
path length [mm], and ``phi`` [...], the phase reduced per surface (each
step adds mod(n k (t - min t), 2 pi), the minimum over the ray axis 0
detached: the common path is a global phase, and the total OPL's phase is
meaningless in f32 for far objects). An incoherent bundle has neither
(None), so the incoherent paths create and carry no phase tensor.
"""

from __future__ import annotations

import dataclasses
import math

import torch


def normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalise along the last axis."""
    n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return v / torch.clamp(n, min=eps)


def reduced_phase(t: torch.Tensor, n, wvln: float) -> torch.Tensor:
    """The phase n k (t - min t) of one propagation step, reduced mod 2 pi;
    k = 2 pi / (wvln [um] * 1e-3) per mm, the minimum over the ray axis 0
    detached."""
    k_wave = 2.0 * math.pi / (wvln * 1e-3)
    return torch.remainder(n * k_wave * (t - t.detach().amin(dim=0)),
                           2.0 * math.pi)


@dataclasses.dataclass(frozen=True)
class Rays:
    o: torch.Tensor
    d: torch.Tensor
    ra: torch.Tensor
    opl: torch.Tensor | None = None
    phi: torch.Tensor | None = None

    @staticmethod
    def create(o, d, ra=None, device=None) -> "Rays":
        """An incoherent bundle; the coherent trace (optics/surfaces.py,
        coherent=True) adds the zero opl and phase it starts from."""
        o = torch.as_tensor(o, dtype=torch.float32, device=device)
        d = normalize(torch.as_tensor(d, dtype=torch.float32, device=o.device))
        if ra is None:
            ra = torch.ones(o.shape[:-1], dtype=torch.float32, device=o.device)
        else:
            ra = torch.as_tensor(ra, dtype=torch.float32, device=o.device)
        return Rays(o=o, d=d, ra=ra)

    @property
    def coherent(self) -> bool:
        return self.phi is not None

    def propagate_to(self, z, n: float = 1.0, wvln=None) -> "Rays":
        """Move every ray to the plane at depth z. With ``wvln`` (microns)
        set, a coherent bundle also accumulates its opl and reduced phase
        in the medium of index n."""
        t = (z - self.o[..., 2]) / self.d[..., 2]
        new = dataclasses.replace(self, o=self.o + self.d * t[..., None])
        if wvln is None:
            return new
        if not self.coherent:
            raise ValueError("propagate_to(wvln=...) needs a coherent bundle "
                             "(one traced with coherent=True)")
        return dataclasses.replace(new, opl=self.opl + n * t,
                                   phi=self.phi + reduced_phase(t, n, wvln))

    def project_to(self, z) -> torch.Tensor:
        """(x, y) intersection with the plane z, [..., 2]."""
        t = (z - self.o[..., 2]) / self.d[..., 2]
        return self.o[..., 0:2] + self.d[..., 0:2] * t[..., None]

    def replace(self, **kw) -> "Rays":
        return dataclasses.replace(self, **kw)
