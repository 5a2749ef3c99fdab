"""Lens analysis (counterpart of sdirt_tpu/optics/analysis.py): the set-up
drawing with ray paths, PSF maps, spot diagrams, MTF curves, distortion
grids and RMS spot radii.

The JAX package draws these with matplotlib, which the machine with the
card does not have. Here each function returns what it computes and writes
it as ``<stem>.npz`` under the JAX package's file stem (``<stem>.png``
there). The image-like figures, the PSF map and the radial PSF strip, are
also written as PNG (utils/png.py). The line and scatter plots (set-up,
spots, MTF, distortion) are written as data only.

Sampling: every function that draws takes a ``torch.Generator`` (seed 0
by default, 42 for the magnification, as the JAX keys are), or the draws
themselves (``draws``: the two uniform arrays of
sampling.sample_pupil_stratified; ``pupils``: per-wavelength pupil points
of dp_psf), which is how the tests hand both packages the same samples.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.constants import DEFAULT_WAVE, EPSILON, GEO_SPP, WAVE_RGB
from ..utils.png import write_png
from . import sampling
from .surfaces import sag_r2


def _gen(lens, generator, seed=0):
    if generator is None:
        generator = torch.Generator(device=lens.device).manual_seed(seed)
    return generator


def _surface_profile(lens, i, n_pts=257):
    """(z, r) polyline of surface i for drawing."""
    c = float(lens.stack.c[i])
    k = float(lens.stack.k[i])
    ai = lens.stack.ai[i].detach().cpu()
    d = float(lens.stack.d[i])
    r_ap = float(lens.stack.r[i])
    r = np.linspace(-r_ap, r_ap, n_pts)
    r2 = torch.tensor(r * r, dtype=torch.float32)
    z = sag_r2(r2, c, k, ai).numpy() + d
    return z, r


def plot_setup2d(lens) -> list:
    """The lens drawing as polylines, each [n, 2] of (z, r): the surfaces,
    the aperture wedges, the element edges between glass surfaces and the
    sensor."""
    lines = []
    n = lens.stack.num_surfaces
    d_np = lens.stack.d.detach().cpu().numpy()
    r_np = lens.stack.r.detach().cpu().numpy()
    for i in range(n):
        if lens.materials[i].is_air and lens.materials[i + 1].is_air:
            d, R = d_np[i], r_np[i]
            wl, wh = 0.05 * R, 0.15 * R
            for sgn in (1, -1):
                lines.append(np.array([[d - wl, sgn * R], [d + wl, sgn * R]]))
                lines.append(np.array([[d, sgn * R], [d, sgn * (R + wh)]]))
        else:
            z, r = _surface_profile(lens, i)
            lines.append(np.stack([z, r], -1))
    prev = None
    for i in range(n):
        if lens.materials[i].is_air:
            prev = i
        else:
            z0, r0 = _surface_profile(lens, prev, 3)
            z1, r1 = _surface_profile(lens, i, 3)
            for sgn in (1, -1):
                lines.append(np.array([[z0[-1], sgn * np.abs(r0[-1])],
                                       [z1[-1], sgn * np.abs(r1[-1])]]))
            prev = i
    lines.append(np.array([[lens.d_sensor, -lens.r_last], [lens.d_sensor, lens.r_last]]))
    return [np.asarray(a, np.float64) for a in lines]


def plot_setup2d_with_trace(lens, filename, views=None, M=9, depth=None):
    """The lens drawing and ray fans at 3 field angles, one wavelength each
    (red, green, blue). Returns {"lines": polylines, "paths": [3] of
    [S + 2, M, 3] (start, every surface, sensor), "views", "title"};
    written to ``<filename>.npz``."""
    views = ([0, np.rad2deg(lens.hfov) * 0.707, np.rad2deg(lens.hfov) * 0.99]
             if views is None else views)
    lines = plot_setup2d(lens)
    paths = []
    for i, view in enumerate(views):
        pupil = lens.entrance_pupil()
        if depth is None:
            rays = sampling.sample_parallel_2d(view=view, M=M, pupil=pupil,
                                               device=lens.device)
        else:
            rays = sampling.sample_point_source_2d(depth=depth, view=view, M=M,
                                                   pupil=pupil, device=lens.device)
        out, os_, _ = lens.trace(rays, wvln=WAVE_RGB[2 - i], record=True)
        sensor = out.propagate_to(lens.d_sensor).o
        path = torch.cat([rays.o[None], os_, sensor[None]], 0)
        paths.append(path.detach().cpu().numpy())
    title = (f"FoV{round(2 * lens.hfov * 57.3, 1)}({int(lens.calc_eqfl())}mm EFL)"
             f"_F/{round(lens.fnum, 2)}_DIAG{round(lens.r_last * 2, 2)}mm"
             f"_FocLen{round(lens.foclen, 2)}mm")
    out = {"lines": lines, "paths": paths, "views": np.asarray(views, np.float64),
           "title": title}
    np.savez(f"{filename}.npz", views=out["views"], title=out["title"],
             **{f"line_{j:03d}": a for j, a in enumerate(lines)},
             **{f"path_{j}": a for j, a in enumerate(paths)})
    return out


def draw_psf_map(lens, grid=9, depth=None, ks=51, spp=GEO_SPP, save_name=None,
                 generator=None, pupils=None):
    """A grid x grid map of RGB PSFs at ``depth``, each cell max-normalised,
    [grid ks, grid ks, 3]; written to ``<name>_psf<d>mm_left.png`` (clipped
    to [0, 1]) and ``.npz``. pupils: per-wavelength (main, chief) pupil
    points as dp/psf.py:compute_psf_rgb takes them."""
    from ..dp.psf import compute_psf_rgb

    points = sampling.point_source_grid(depth=depth, grid=grid).reshape(-1, 3)
    with torch.no_grad():
        psfs = compute_psf_rgb(lens, points, generator=_gen(lens, generator), spp=spp,
                               ks=ks, pupils=pupils).cpu().numpy()
    psf_map = psfs.reshape(grid, grid, 3, ks, ks).transpose(0, 3, 1, 4, 2)
    psf_map = psf_map.reshape(grid * ks, grid * ks, 3).copy()
    for i in range(0, grid * ks, ks):
        for j in range(0, grid * ks, ks):
            cell = psf_map[i:i + ks, j:j + ks]
            psf_map[i:i + ks, j:j + ks] = cell / (cell.max() + 1e-9)
    stem = f"{save_name or './psf_map'}_psf{-int(depth)}mm_left"
    write_png(f"{stem}.png", np.clip(psf_map, 0, 1))
    np.savez(f"{stem}.npz", psf_map=psf_map)
    return psf_map


def _spots(rays, flip: bool = False):
    """Sensor positions (sign-flipped as the JAX diagram plots them) and
    their per-point centroids over the live rays (NaN where none lives)."""
    xy = -rays.o[..., :2].cpu().numpy()
    ra = rays.ra.cpu().numpy()
    if flip:
        xy, ra = np.flip(-xy, (1, 2)), np.flip(ra, (1, 2))
    cnt = ra.sum(0)
    with np.errstate(invalid="ignore", divide="ignore"):
        centroid = (xy * ra[..., None]).sum(0) / cnt[..., None]
    return xy, ra, centroid


def draw_spot_diagram(lens, M=7, depth=None, wvln=DEFAULT_WAVE, save_name=None,
                      generator=None, draws=None, mag_draws=None):
    """Spot diagrams of an M x M grid of points at ``depth``: {"xy" [1024,
    M, M, 2], "ra" [1024, M, M], "centroid" [M, M, 2]}; written to
    ``<name>_spot<d>mm.npz``."""
    mag = lens.calc_magnification3(depth, draws=mag_draws)
    with torch.no_grad():
        rays = lens.sample_point_source(depth=depth, R=lens.sensor_size[0] / 2 / mag,
                                        M=M, spp=1024, generator=_gen(lens, generator),
                                        draws=draws)
        rays = lens.trace2sensor(rays, wvln=wvln)
    xy, ra, centroid = _spots(rays)
    out = {"xy": xy, "ra": ra, "centroid": centroid}
    np.savez(f"{save_name or './spot'}_spot{-int(depth)}mm.npz", **out)
    return out


def psf2mtf(lens, psf):
    """Sagittal / tangential MTF from a PSF's centre row and column:
    (freq [cycles/mm], tangential, sagittal) at the positive frequencies."""
    psf = np.asarray(psf)
    cy, cx = psf.shape[0] // 2, psf.shape[1] // 2
    sag = np.abs(np.fft.fft(psf[cy, :]))
    tan = np.abs(np.fft.fft(psf[:, cx]))
    sag /= sag.max()
    tan /= tan.max()
    freq = np.fft.fftfreq(psf.shape[0], lens.pixel_size)
    pos = freq > 0
    return freq[pos], tan[pos], sag[pos]


def draw_mtf(lens, relative_fov=(0.0, 0.7, 1.0), save_name="./mtf.png",
             wvlns=DEFAULT_WAVE, depth=None, generator=None):
    """MTF curves at several field points (ks 129): {"freq", "tangential"
    [n_wvln, n_fov, n_freq], "sagittal", "fov_deg", "wvlns"}; written to
    ``<save_name without .png>.npz``."""
    from ..dp.psf import compute_psf

    wvlns = [wvlns] if isinstance(wvlns, float) else list(wvlns)
    gen = _gen(lens, generator)
    tan, sag = [], []
    for wvln in wvlns:
        tan.append([])
        sag.append([])
        for fov in relative_fov:
            point = np.array([[fov, fov, depth]], np.float32)
            with torch.no_grad():
                psf = compute_psf(lens, point, gen, spp=GEO_SPP, ks=129,
                                  wvln=wvln).cpu().numpy()[0]
            freq, mtf_tan, mtf_sag = psf2mtf(lens, psf)
            tan[-1].append(mtf_tan)
            sag[-1].append(mtf_sag)
    out = {"freq": freq, "tangential": np.array(tan), "sagittal": np.array(sag),
           "fov_deg": np.array([round(f * lens.hfov * 57.3, 1) for f in relative_fov]),
           "wvlns": np.array(wvlns)}
    stem = save_name[:-4] if save_name.endswith(".png") else save_name
    np.savez(f"{stem}.npz", **out)
    return out


def draw_distortion(lens, depth, M=16, save_name=None, generator=None, draws=None):
    """Pinhole grid positions against the traced centroids on the sensor,
    {"ref" [2, M, M] (x, y), "traced" [2, M, M]}; written to
    ``<name>_distortion<d>mm.npz``."""
    scale = lens.calc_scale_pinhole(depth)
    with torch.no_grad():
        rays = lens.sample_point_source(depth=depth, R=lens.sensor_size[0] / 2 * scale,
                                        M=M, spp=GEO_SPP, generator=_gen(lens, generator),
                                        draws=draws)
        o1 = rays.o[0].cpu().numpy()
        rays = lens.trace(rays)
        o2 = rays.project_to(lens.d_sensor).cpu().numpy()
        ra = rays.ra.cpu().numpy()
    x1, y1 = o1[..., 0] / scale, o1[..., 1] / scale
    with np.errstate(invalid="ignore", divide="ignore"):
        x2 = (o2[..., 0] * ra).sum(0) / ra.sum(0)
        y2 = (o2[..., 1] * ra).sum(0) / ra.sum(0)
    out = {"ref": np.stack([x1, y1]), "traced": np.stack([x2, y2])}
    np.savez(f"{save_name or './distortion'}_distortion{-int(depth)}mm.npz", **out)
    return out


def analysis_rms(lens, depth, ref=True, generator=None, draws=None, mag_draws=None):
    """RMS spot radii [mm] over RGB: (average, on-axis, off-axis), from a
    31 x 31 grid of points at ``depth`` spanning the sensor's height, each
    traced with GEO_SPP stratified pupil samples per wavelength (about the
    green reference centroid when ``ref``).

    draws: four (angle, r^2) draw pairs in the JAX key order (red, green,
    blue, then the green reference); mag_draws: calc_magnification3's."""
    H = 31
    scale = lens.calc_scale_ray(depth, draws=mag_draws)
    gen = _gen(lens, generator)
    draws = [None] * 4 if draws is None else draws

    def spot(i, wvln):
        rays = lens.sample_point_source(depth=depth, R=lens.sensor_size[0] / 2 * scale,
                                        M=H, spp=GEO_SPP, generator=gen, draws=draws[i])
        rays = lens.trace(rays, wvln=wvln)
        return rays.project_to(lens.d_sensor).cpu().numpy(), rays.ra.cpu().numpy()

    with torch.no_grad():
        if ref:
            p, ra = spot(3, DEFAULT_WAVE)
            p_center_ref = (p * ra[..., None]).sum(0) / (ra.sum(0)[..., None] + 1e-4)
        rms, rms_on, rms_off = [], [], []
        for i, wvln in enumerate(WAVE_RGB):
            o2, ra = spot(i, wvln)
            center = (o2 * ra[..., None]).sum(0) / (ra.sum(0)[..., None] + 1e-4)
            o2n = (o2 - (p_center_ref if ref else center)) * ra[..., None]
            rms.append(np.sqrt((o2n ** 2 * ra[..., None]).sum() / ra.sum()))
            c = H // 2 + 1
            rms_on.append(np.sqrt((o2n[:, c, c, :] ** 2 * ra[:, c, c, None]).sum()
                                  / ra[:, H // 2, H // 2].sum()))
            rms_off.append(np.sqrt((o2n[:, 0, 0, :] ** 2 * ra[:, 0, 0, None]).sum()
                                   / ra[:, 0, 0].sum()))
    return float(np.mean(rms)), float(np.mean(rms_on)), float(np.mean(rms_off))


def analysis(lens, save_name="./test", ks=None, depth=None, generator=None):
    """The standard bundle: set-up drawing, PSF map and RMS radii, printed
    as the JAX package prints them. Returns (avg, on-axis, off-axis) [mm]."""
    plot_setup2d_with_trace(lens, filename=save_name, depth=depth)
    draw_psf_map(lens, save_name=save_name, ks=ks or 51, depth=depth,
                 generator=generator)
    rms_avg, rms_on, rms_off = analysis_rms(lens, depth=depth, generator=generator)
    print(f"On-axis RMS radius: {round(rms_on * 1000, 3)}um, "
          f"Off-axis RMS radius: {round(rms_off * 1000, 3)}um, "
          f"Avg RMS spot size (radius): {round(rms_avg * 1000, 3)}um.")
    return rms_avg, rms_on, rms_off


def draw_psf_radial(lens, M=3, depth=None, ks=51, log_scale=False,
                    save_name="./psf_radial.png", generator=None):
    """RGB PSFs at M points along the field's diagonal, each
    max-normalised (log-scaled to [0, 1] with log_scale), [M, ks, ks, 3];
    written side by side to ``save_name`` (PNG) and as ``.npz``."""
    from ..dp.psf import compute_psf_rgb

    gen = _gen(lens, generator)
    strip = []
    for x in np.linspace(0, 1, M):
        pts = np.array([[x, x, depth]], np.float32)
        with torch.no_grad():
            psf = compute_psf_rgb(lens, pts, gen, spp=4096, ks=ks).cpu().numpy()[0]
        psf = psf / (psf.max() + 1e-9)
        if log_scale:
            psf = np.log(psf + EPSILON)
            psf = (psf - psf.min()) / (psf.max() - psf.min())
        strip.append(psf.transpose(1, 2, 0))
    strip = np.stack(strip)
    stem = save_name[:-4] if save_name.endswith(".png") else save_name
    write_png(f"{stem}.png", np.clip(np.concatenate(list(strip), axis=1), 0, 1))
    np.savez(f"{stem}.npz", psf=strip)
    return strip


def draw_spot_radial(lens, M=3, depth=None, save_name=None, generator=None,
                     draws=None, mag_draws=None):
    """Spot diagrams at M points along the field's diagonal (of a (2M-1)^2
    grid): {"xy" [1024, M, 2], "ra" [1024, M], "centroid" [M, 2]} (sensor
    positions as the JAX diagram plots them); written to
    ``<name>_spot<d>mm_radial.npz``."""
    mag = lens.calc_magnification3(depth, draws=mag_draws)
    with torch.no_grad():
        rays = lens.sample_point_source(depth=depth, R=lens.sensor_size[0] / 2 / mag,
                                        M=M * 2 - 1, spp=1024,
                                        generator=_gen(lens, generator), draws=draws)
        rays = lens.trace(rays).propagate_to(lens.d_sensor)
    xy, ra, centroid = _spots(rays, flip=True)
    ib = np.arange(M) + M - 1
    out = {"xy": xy[:, ib, ib], "ra": ra[:, ib, ib], "centroid": centroid[ib, ib]}
    np.savez(f"{save_name or './spot_radial'}_spot{-int(depth)}mm_radial.npz", **out)
    return out
