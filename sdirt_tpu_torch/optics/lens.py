"""The Lens: a multi-surface optical system with its geometry calculations
(PyTorch counterpart of sdirt_tpu/optics/lens.py).

Loading, aperture finding, sensor set-up, the paraxial pupils, FoV and focal
length, refocus. The per-ray work (``trace``) is torch on the lens's device;
the small solves (paraxial matrices, least-squares focus, trimmed means)
stay in numpy on the host, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.constants import DEFAULT_WAVE, GEO_SPP
from ..core.rays import Rays
from ..utils.device import resolve_device
from . import sampling
from .surfaces import KIND_STOP, static_surface_desc, trace_rays


class Lens:
    """A lens system mounted at the origin; surfaces along +z, sensor at
    z = d_sensor, objects at negative z."""

    def __init__(self, filename: str | None = None, sensor_res=(1024, 1024),
                 device="cuda"):
        self.device = resolve_device(device)
        self.lens_name = filename
        self.sensor_res = tuple(sensor_res)
        self._pupil_cache = {}
        self._eta_cache = {}
        if filename is not None:
            self.load_file(filename, sensor_res)

    # ------------------------------------------------------------------
    # Loading / setup
    # ------------------------------------------------------------------
    def load_file(self, filename: str, sensor_res):
        from ..io.lens_json import read_lens_json

        if not filename.endswith(".json"):
            raise ValueError("Only .json lens files are supported.")
        stack, materials, r_last, d_sensor, _ = read_lens_json(filename, self.device)
        self.stack = stack
        self.materials = materials
        self.r_last = r_last
        self.d_sensor = d_sensor
        self.find_aperture()
        self.prepare_sensor(sensor_res)
        self.post_computation()

    def prepare_sensor(self, sensor_res=(512, 512), sensor_size=(24.0, 36.0)):
        """Full-frame 24x36 mm sensor by default."""
        if isinstance(sensor_res, int):
            sensor_res = (sensor_res, sensor_res)
        self.sensor_res = tuple(sensor_res)
        H, W = self.sensor_res
        if sensor_size is None:
            s = 2 * self.r_last / np.sqrt(H ** 2 + W ** 2)
            self.sensor_size = [s * H, s * W]
        else:
            self.sensor_size = list(sensor_size)
            self.r_last = float(np.sqrt(sensor_size[0] ** 2 + sensor_size[1] ** 2) / 2)
        assert self.sensor_size[0] / self.sensor_size[1] == H / W, "Pixel is not square."
        self.pixel_size = self.sensor_size[0] / H

    def post_computation(self):
        """Compute hfov, foclen, fnum."""
        self.find_aperture()
        self._pupil_cache = {}
        self.hfov = self.calc_fov()
        self.foclen = self.calc_efl()
        _, pupilr = self.entrance_pupil()
        self.fnum = self.foclen / pupilr / 2

    def find_aperture(self):
        """First surface with air on both sides."""
        self.aper_idx = None
        for i in range(self.stack.num_surfaces - 1):
            if self.materials[i].is_air and self.materials[i + 1].is_air:
                self.aper_idx = i
                return

    # ------------------------------------------------------------------
    # Refraction ratios
    # ------------------------------------------------------------------
    def eta_arrays(self, wvln: float = DEFAULT_WAVE, forward: bool = True):
        """(eta [S], skip [S]) f32 on the lens's device: the refraction
        ratio of each surface in the given direction, and 1 for stops in
        air (c == 0 and eta == 1), which do not refract. Depends on the
        materials and on which curvatures are zero, which no lens operation
        changes."""
        key = (float(wvln), bool(forward))
        if key not in self._eta_cache:
            n = np.array([m.ior(wvln) for m in self.materials], np.float32)
            n1, n2 = n[:-1], n[1:]
            eta = n1 / n2 if forward else n2 / n1
            c = self.stack.c.detach().cpu().numpy()
            skip = ((c == 0.0) & (eta == 1.0)).astype(np.float32)
            self._eta_cache[key] = (torch.from_numpy(eta).to(self.device),
                                    torch.from_numpy(skip).to(self.device))
        return self._eta_cache[key]

    def static_desc(self) -> tuple:
        """Hashable static surface description (surfaces.static_surface_desc);
        the skip flag is structural, so the wavelength does not matter."""
        _, skip = self.eta_arrays(DEFAULT_WAVE, True)
        return static_surface_desc(self.stack, skip)

    # ------------------------------------------------------------------
    # Tracing
    # ------------------------------------------------------------------
    def trace(self, rays: Rays, wvln: float = DEFAULT_WAVE, forward: bool = True) -> Rays:
        """Trace rays through all surfaces (backward: in reverse order)."""
        eta, skip = self.eta_arrays(wvln, forward)
        return trace_rays(rays, self.stack, eta, skip, forward=forward)

    def trace2sensor(self, rays: Rays, wvln: float = DEFAULT_WAVE) -> Rays:
        """Forward trace, then propagate to the sensor plane."""
        return self.trace(rays, wvln=wvln, forward=True).propagate_to(self.d_sensor)

    # ------------------------------------------------------------------
    # Pupils (paraxial)
    # ------------------------------------------------------------------
    def entrance_pupil(self, entrance: bool = True, shrink_pupil: bool = False):
        if entrance not in self._pupil_cache:
            self._pupil_cache[entrance] = self._calc_pupil_paraxial(entrance)
        pupilz, pupilr = self._pupil_cache[entrance]
        if shrink_pupil:
            pupilr = pupilr * 0.25
        return pupilz, pupilr

    def exit_pupil(self, shrink_pupil: bool = False):
        return self.entrance_pupil(entrance=False, shrink_pupil=shrink_pupil)

    def _calc_pupil_paraxial(self, entrance: bool, wvln: float = DEFAULT_WAVE):
        """Image the aperture stop through the preceding / following
        surfaces with an exact 2x2 paraxial ray-transfer matrix.

        State (y, omega) with reduced angle omega = n*u; refraction at vertex
        curvature kappa is [[1,0],[-phi,1]] with power phi = kappa*(n2-n1);
        translation tau in medium n is [[1,tau/n],[0,1]].
        """
        n_surf = self.stack.num_surfaces
        d_np = self.stack.d.detach().cpu().numpy().astype(np.float64)
        r_np = self.stack.r.detach().cpu().numpy()
        if self.aper_idx is None:
            if entrance:
                return float(d_np[0]), float(r_np[0])
            return float(d_np[-1]), float(r_np[-1])

        aper_r = float(r_np[self.aper_idx])
        n = np.array([m.ior(wvln) for m in self.materials], np.float64)
        c = self.stack.c.detach().cpu().numpy().astype(np.float64)
        ai0 = self.stack.ai.detach().cpu().numpy().astype(np.float64)[:, 0]
        kinds = self.stack.kind.cpu().numpy()
        # vertex curvature of the even asphere: sag = kappa r^2/2 + O(r^4)
        kappa = np.where(kinds == KIND_STOP, 0.0, c + 2.0 * ai0)

        def refract_m(i):
            return np.array([[1.0, 0.0], [-kappa[i] * (n[i + 1] - n[i]), 1.0]])

        def translate_m(tau, n_med):
            return np.array([[1.0, tau / n_med], [0.0, 1.0]])

        M = np.eye(2)
        if entrance:
            # (y, omega) at the surface-0 vertex plane -> stop plane
            for i in range(self.aper_idx):
                M = refract_m(i) @ M
                M = translate_m(d_np[i + 1] - d_np[i], n[i + 1]) @ M
            A, B = M[0]
            return float(d_np[0] + B / A), float(abs(aper_r / A))
        # stop plane -> last-surface vertex plane
        for i in range(self.aper_idx + 1, n_surf):
            M = translate_m(d_np[i] - d_np[i - 1], n[i]) @ M
            M = refract_m(i) @ M
        B, D = M[0, 1], M[1, 1]
        return float(d_np[-1] - B / D), float(abs(aper_r / D))

    # ------------------------------------------------------------------
    # FoV / focal length
    # ------------------------------------------------------------------
    def calc_fov(self) -> float:
        """Half-diagonal FoV by backward edge-ray tracing."""
        m = 100
        pupilz, pupilr = self.exit_pupil(shrink_pupil=True)
        o1 = np.tile(np.array([self.r_last, 0.0, self.d_sensor], np.float32), (m, 1))
        x2 = np.linspace(-pupilr, pupilr, m)
        o2 = np.stack([x2, np.zeros(m), np.full(m, pupilz)], axis=-1).astype(np.float32)
        rays = self.trace(Rays.create(o1, o2 - o1, device=self.device), forward=False)
        ra = rays.ra.cpu().numpy()
        tan_fov = (rays.d[..., 0] / rays.d[..., 2]).cpu().numpy()
        denom = ra.sum()
        fov = np.arctan((tan_fov * ra).sum() / denom) if denom > 0 else np.nan
        if np.isnan(fov):
            return 0.5
        return float(fov)

    def calc_efl(self) -> float:
        return float(self.r_last / np.tan(self.hfov))

    def calc_principal(self, wvln=DEFAULT_WAVE):
        """Front / back principal plane positions."""
        m = 32
        r0 = float(self.stack.r[0])
        out_planes = []
        for forward in (False, True):
            rays_in = sampling.sample_parallel_2d(
                R=r0, M=m, z=0.0 if forward else self.d_sensor, forward=forward,
                device=self.device)
            out = self.trace(rays_in, wvln=wvln, forward=forward)
            ra = out.ra.cpu().numpy()
            # invalidated rays carry d_x == 0; they are excluded by ra below
            d0 = np.where(ra > 0, out.d[..., 0].cpu().numpy(), 1.0)
            t = (out.o[..., 0].cpu().numpy() - rays_in.o[..., 0].cpu().numpy()) / d0
            z = out.o[..., 2].cpu().numpy() - out.d[..., 2].cpu().numpy() * t
            out_planes.append(float(np.nanmean(z[ra > 0])))
        return tuple(out_planes)

    # ------------------------------------------------------------------
    # Refocus
    # ------------------------------------------------------------------
    def _focus_samples(self, generator, xy):
        if generator is None and xy is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        r0 = float(self.stack.r[0])
        d0 = float(self.stack.d[0])
        return sampling.surface_sample(GEO_SPP, r0, d0, generator, xy, self.device)

    def refocus(self, depth: float, generator=None, xy=None):
        """Move the sensor to the least-squares focus of a point at `depth`,
        from GEO_SPP rays through points on the first surface (drawn from
        ``generator``, or the given xy [GEO_SPP, 2])."""
        o = self._focus_samples(generator, xy)
        d = o - torch.tensor([0.0, 0.0, depth], dtype=torch.float32, device=self.device)
        rays = self.trace(Rays.create(o, d))
        dx, dy, dz = (rays.d[..., i].cpu().numpy() for i in range(3))
        ox, oy, oz = (rays.o[..., i].cpu().numpy() for i in range(3))
        ra = rays.ra.cpu().numpy()
        t = (dx * ox + dy * oy) / (dx ** 2 + dy ** 2) * ra
        focus_d = (oz - dz * t)[ra > 0]
        focus_d = focus_d[~np.isnan(focus_d) & (focus_d > 0)]
        d_sensor_new = float(np.mean(focus_d))
        assert d_sensor_new > 0, "sensor position is negative."
        self.d_sensor = d_sensor_new
        self.post_computation()

    def calc_foc_dist(self, wvln=DEFAULT_WAVE, generator=None, xy=None):
        """Object-space focus distance by backward tracing from the sensor
        centre (negative z)."""
        o1 = torch.tensor([0.0, 0.0, self.d_sensor], dtype=torch.float32,
                          device=self.device).expand(GEO_SPP, 3)
        o2 = self._focus_samples(generator, xy) * torch.tensor(
            [0.2, 0.2, 1.0], dtype=torch.float32, device=self.device)
        rays = self.trace(Rays.create(o1, o2 - o1), wvln=wvln, forward=False)
        dx, dy, dz = (rays.d[..., i].cpu().numpy() for i in range(3))
        ox, oy, oz = (rays.o[..., i].cpu().numpy() for i in range(3))
        ra = rays.ra.cpu().numpy()
        t = (dx * ox + dy * oy) / (dx ** 2 + dy ** 2)
        focus_p = (oz - dz * t)[ra > 0]
        focus_p = focus_p[~np.isnan(focus_p) & (focus_p < 0)]
        return float(np.mean(focus_p))

    # ------------------------------------------------------------------
    # Aperture, IO
    # ------------------------------------------------------------------
    def set_aperture(self, fnum=None, foclen=None, aper_r=None):
        """Change the aperture radius."""
        if aper_r is None:
            if foclen is None:
                foclen = self.calc_efl()
            aper_r = foclen / fnum / 2
        r = self.stack.r.clone()
        r[self.aper_idx] = aper_r
        self.stack = self.stack.replace(r=r)
        self._pupil_cache = {}
        self.fnum = self.foclen / aper_r / 2

    def write_lens_json(self, path: str):
        from ..io.lens_json import write_lens_json
        write_lens_json(self, path)
