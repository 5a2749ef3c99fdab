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

from ..core.constants import DEFAULT_WAVE, EPSILON, GEO_SPP
from ..core.rays import Rays
from ..utils.device import resolve_device
from . import sampling
from .surfaces import KIND_STOP, SurfaceStack, static_surface_desc, trace_rays

# the module, for the method whose argument is named sampling
_sampling = sampling


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

    def load_external(self, stack, materials, r_last, d_sensor):
        """Take a surface stack, its materials, r_last and d_sensor as given
        (no sensor set-up, no post_computation)."""
        self.stack = stack
        self.materials = materials
        self.r_last = r_last
        self.d_sensor = d_sensor
        self._pupil_cache = {}
        self._eta_cache = {}

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

    def find_diff_surf(self) -> list:
        """The surfaces lens design may change: all but the aperture stop."""
        n = self.stack.num_surfaces
        if self.aper_idx is None:
            return list(range(n))
        return [i for i in range(n) if i != self.aper_idx]

    @property
    def surface_count(self) -> int:
        return self.stack.num_surfaces

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

    def n_in_array(self, wvln: float = DEFAULT_WAVE, forward: bool = True):
        """Per-surface index of the incidence medium [S] f32 on the lens's
        device (for coherent OPL accumulation)."""
        n = np.array([m.ior(wvln) for m in self.materials], np.float32)
        return torch.from_numpy(n[:-1] if forward else n[1:]).to(self.device)

    # ------------------------------------------------------------------
    # Tracing
    # ------------------------------------------------------------------
    def trace(self, rays: Rays, wvln: float = DEFAULT_WAVE, forward: bool = True,
              lens_range=None, record: bool = False):
        """Trace rays through all surfaces (backward: in reverse order), or
        through the surfaces of ``lens_range`` only. record=True returns
        (rays, o [S, ..., 3], ra [S, ...]) after every surface traced
        ((rays, None, None) for an empty range)."""
        stack = self.stack
        eta, skip = self.eta_arrays(wvln, forward)
        if lens_range is not None:
            idx = torch.as_tensor(list(lens_range), dtype=torch.int64,
                                  device=self.device)
            if idx.numel() == 0:
                return (rays, None, None) if record else rays
            stack = SurfaceStack(*(a[idx] for a in (stack.c, stack.k, stack.ai,
                                                    stack.d, stack.r, stack.kind)))
            eta, skip = eta[idx], skip[idx]
        return trace_rays(rays, stack, eta, skip, forward=forward, record=record)

    def trace2sensor(self, rays: Rays, wvln: float = DEFAULT_WAVE) -> Rays:
        """Forward trace, then propagate to the sensor plane."""
        return self.trace(rays, wvln=wvln, forward=True).propagate_to(self.d_sensor)

    def trace2obj(self, rays: Rays, depth: float, wvln: float = DEFAULT_WAVE) -> Rays:
        """Forward trace, then propagate to the plane z = depth."""
        return self.trace(rays, wvln=wvln, forward=True).propagate_to(depth)

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

    def calc_eqfl(self) -> float:
        """35 mm-equivalent focal length."""
        return float(21.63 / np.tan(self.hfov))

    def calc_bfl(self, wvln=DEFAULT_WAVE) -> float:
        """Back focal length: the sensor's distance from the back principal
        plane."""
        return float(self.d_sensor - self.calc_principal(wvln)[1])

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

    def calc_scale_pinhole(self, depth):
        """Pinhole magnification reciprocal at a depth."""
        return -depth * np.tan(self.hfov) / self.r_last

    def calc_magnification3(self, depth, generator=None, draws=None):
        """Ray-traced magnification from a 21 x 21 grid of point sources at
        ``depth`` (512 stratified pupil samples each, drawn from
        ``generator``, seed 42 by default, or the given ``draws``)."""
        m, spp = 21, 512
        if generator is None and draws is None:
            generator = torch.Generator(device=self.device).manual_seed(42)
        rays = self.sample_point_source(depth=depth, R=-depth * np.tan(self.hfov) * 0.5,
                                        M=m, spp=spp, generator=generator, draws=draws)
        o1 = np.flip(rays.o.cpu().numpy()[..., :2], (1, 2))
        rays = self.trace(rays)
        o2 = rays.project_to(self.d_sensor).cpu().numpy()
        ra = rays.ra.cpu().numpy()
        x2 = (o2[..., 0] * ra).sum(0) / (ra.sum(0) + EPSILON)
        x1 = o1[0, :, :, 0]
        mag_x = x1 / x2
        tmp = mag_x[: m // 2, : m // 2]
        mag = 1.0 / float(np.mean(tmp[~np.isnan(tmp)]))
        if mag == 0:
            return 1.0 / self.calc_scale_pinhole(depth)
        return mag

    def calc_scale_ray(self, depth, generator=None, draws=None):
        return 1.0 / self.calc_magnification3(depth, generator, draws)

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

    def refocus_inf(self):
        """Focus to infinity with an axial parallel beam."""
        r0 = float(self.stack.r[0])
        rays = self.trace(sampling.sample_parallel_2d(R=r0 * 0.5, M=GEO_SPP, z=0.0,
                                                      device=self.device))
        dx, dy, dz = (rays.d[..., i].cpu().numpy() for i in range(3))
        ox, oy, oz = (rays.o[..., i].cpu().numpy() for i in range(3))
        ra = rays.ra.cpu().numpy()
        t = (dx * ox + dy * oy) / (dx ** 2 + dy ** 2)
        focus_p = (oz - dz * t)[ra > 0]
        focus_p = focus_p[~np.isnan(focus_p) & (focus_p > 0)]
        d_sensor_new = float(np.mean(focus_p))
        assert d_sensor_new > 0, "sensor position is negative."
        self.d_sensor = d_sensor_new
        self.post_computation()

    # ------------------------------------------------------------------
    # Sampling helpers bound to this lens
    # ------------------------------------------------------------------
    def sample_from_points(self, points, spp: int = 256, shrink_pupil=False,
                           generator=None, xy=None) -> Rays:
        """spp rays per point through the entrance pupil, [spp, N]."""
        pupilz, pupilr = self.entrance_pupil(shrink_pupil=shrink_pupil)
        points = torch.as_tensor(points, dtype=torch.float32, device=self.device)
        return sampling.sample_from_points(points, spp, pupilz, pupilr, generator, xy)

    def sample_from_points_grid(self, points, M: int = 256) -> Rays:
        """Regular pupil-grid quadrature, [M*M, N] (coherent integration)."""
        pupilz, pupilr = self.entrance_pupil()
        points = torch.as_tensor(points, dtype=torch.float32, device=self.device)
        return sampling.sample_from_points_grid(points, M, pupilz, pupilr)

    def sample_point_source(self, depth=-10.0, R=None, M=11, spp=16,
                            generator=None, draws=None) -> Rays:
        """An M x M grid of point sources at ``depth`` spanning R (height)
        and R W / H (width), with stratified pupil-aimed rays, [spp, M, M]
        (sampling.sample_pupil_stratified's ``generator`` or ``draws``)."""
        if R is None:
            R = float(self.stack.r[0])
        Rw = R * self.sensor_res[1] / self.sensor_res[0]
        x, y = np.meshgrid(np.linspace(-1, 1, M), np.linspace(1, -1, M), indexing="xy")
        o = np.stack([x * Rw, y * R, np.full_like(x, depth)], axis=-1).astype(np.float32)
        o = torch.from_numpy(o).to(self.device)[None].expand(spp, M, M, 3)
        pupilz, pupilr = self.entrance_pupil()
        o2 = sampling.sample_pupil_stratified((M, M), spp, pupilr, pupilz,
                                              generator=generator, draws=draws,
                                              device=self.device)
        return Rays.create(o, o2 - o)

    def sample_parallel(self, fov_deg: float = 0.0, M: int = 15,
                        sampling: str = "grid", forward: bool = True,
                        generator=None, xy=None) -> Rays:
        """Parallel rays over the entrance pupil, moved back to the first
        surface's plane."""
        pupilz, pupilr = self.entrance_pupil()
        z0 = float(self.stack.d[0])
        return _sampling.sample_parallel(fov_deg, M, pupilz, pupilr, sampling=sampling,
                                         forward=forward, z=z0, generator=generator,
                                         xy=xy, device=self.device)

    def sample_sensor(self, spp: int = 64, generator=None, draws=None) -> Rays:
        """Backward rays from the sensor pixels through the exit pupil,
        [spp, H, W]."""
        pupilz, pupilr = self.exit_pupil()
        return sampling.sample_sensor(self.sensor_res, self.sensor_size, self.d_sensor,
                                      spp, pupilz, pupilr, generator=generator,
                                      draws=draws, device=self.device)

    # ------------------------------------------------------------------
    # Pruning
    # ------------------------------------------------------------------
    def prune_surf(self, outer=None):
        """Set each changeable surface's clear radius from where a 21-ray
        fan at the edge of the field crosses it (plus ``outer``, 5% of
        r_last by default), no wider than the next surface where the glass
        gets denser, than the conic's height or than r_last."""
        outer = self.r_last * 0.05 if outer is None else outer
        surface_range = self.find_diff_surf()
        r_np = self.stack.r.detach().cpu().numpy().copy()
        r_np[surface_range] = self.r_last
        self.stack = self.stack.replace(r=torch.from_numpy(r_np).to(self.device))

        view = self.hfov if self.hfov is not None else np.arctan(self.r_last / self.d_sensor)
        rays = sampling.sample_parallel_2d(view=float(np.rad2deg(view)), M=21,
                                           pupil=self.entrance_pupil(),
                                           device=self.device)
        _, os_, _ = self.trace(rays, record=True)
        os_ = os_.cpu().numpy()                       # [S, M, 3]
        for i in surface_range:
            hit = np.abs(os_[i, :, 0])
            if hit.size:
                r_np[i] = hit.max() + outer
        for i in surface_range[:-1]:
            if self.materials[i].n_d < self.materials[i + 1].n_d:
                r_np[i] = min(r_np[i], r_np[i + 1])
        c_np = self.stack.c.detach().cpu().numpy()
        k_np = self.stack.k.detach().cpu().numpy()
        for i in surface_range:
            if k_np[i] > -1 and c_np[i] != 0:
                max_h = np.sqrt(1 / (k_np[i] + 1) / c_np[i] ** 2) - 0.01
            else:
                max_h = 100.0
            r_np[i] = min(r_np[i], min(max_h, self.r_last))
        self.stack = self.stack.replace(r=torch.from_numpy(r_np).to(self.device))

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
