"""Coherent (interference-aware) imaging demo of the PyTorch port
(counterpart of ``apps/coherent_demo.py``): interference rings from rays.

  python -m sdirt_tpu_torch.coherent_demo [--device cuda] [--image] \\
      [--depths -1000 -1100 -1300 --ks 65 --ps 0.0015 --M 512 --out DIR]

A regular pupil-grid quadrature of rays is traced with phase through the
rf50mm refocused to 1 m, and the complex amplitudes are integrated on a
fine analysis grid (1.5 um pixels: interference at f/4 lives at the
few-micron scale, far below the 47 um sensor pixel, where it averages
away). Near focus the lens's spherical aberration folds the pupil-to-sensor
map, so the defocused blur disk carries concentric rings in the coherent
PSF and none in the incoherent one, from the same traced rays.

Outputs (to --out): ``psf_panel_<depth>.png`` (coherent | incoherent,
log10 display, grey) with ``.npz`` (both PSFs), ``profile_<depth>.npz``
(the azimuthally averaged profiles; the JAX app plots them), and with
``--image`` ``interference_image.png`` (coherent | incoherent | difference)
with ``.npz``. Prints a ring-contrast line per depth. The machine with the
card has no matplotlib: figures are grey PNGs or data.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .dp.coherent import coherent_psf_grid
from .optics.lens import Lens
from .render.perpixel import uniform_psf_conv
from .utils.device import resolve_device
from .utils.png import write_png


def radial_profile(psf: np.ndarray, nbins: int = 24):
    """Azimuthally averaged profile (averages out quadrature artefacts)."""
    ks = psf.shape[-1]
    yy, xx = np.mgrid[0:ks, 0:ks].astype(np.float32) - (ks - 1) / 2
    r = np.sqrt(yy ** 2 + xx ** 2).ravel()
    idx = np.minimum((r / r.max() * nbins).astype(int), nbins - 1)
    flat = psf.ravel()
    return np.bincount(idx, flat, nbins) / np.maximum(np.bincount(idx, None, nbins), 1)


def ring_contrast(prof: np.ndarray) -> float:
    """Detrended oscillation energy of the radial profile inside the blur
    disk: rings oscillate around the smooth trend; a geometric blur is
    monotone and scores ~0."""
    disk = prof > 0.05 * prof.max()
    p = prof[disk]
    if len(p) < 7:
        return 0.0
    k = 5
    trend = np.convolve(p, np.ones(k) / k, mode="valid")
    resid = p[k // 2:k // 2 + len(trend)] - trend
    return float(resid.std() / (p.mean() + 1e-12))


def _unit(a: np.ndarray) -> np.ndarray:
    lo, hi = float(a.min()), float(a.max())
    return (a - lo) / (hi - lo) if hi > lo else np.zeros_like(a)


def interference_image(lens, depths, ks, ps, M, h=256, w=320, seed=0):
    """A sparse emitter scene (points and one thin bar per depth layer on
    black, mutually incoherent layers) rendered with each depth's on-axis
    coherent and incoherent PSF from the same traced rays, composited
    additively, on the fine analysis grid. Returns (img_coh, img_inc,
    probes): [h, w] arrays and the (y, x, depth) of one isolated probe
    emitter per depth."""
    rng = np.random.default_rng(seed)
    img_coh = np.zeros((h, w), np.float32)
    img_inc = np.zeros((h, w), np.float32)
    probes = []
    margin = ks
    for li, depth in enumerate(depths):
        coh, inc = coherent_psf_grid(lens, depth, grid=1, ks=ks, M=M, ps=ps)
        coh = coh[0, 0].cpu().numpy()
        inc = inc[0, 0].cpu().numpy()
        coh /= coh.sum() + 1e-12          # energy-normalise for compositing
        inc /= inc.sum() + 1e-12
        layer = np.zeros((h, w), np.float32)
        for _ in range(14):               # random point emitters
            layer[rng.integers(margin, h - margin),
                  rng.integers(margin, w - margin)] = rng.uniform(0.5, 1.0)
        x0 = rng.integers(margin, w - margin)  # one thin vertical bar
        layer[rng.integers(margin, h // 2): rng.integers(h // 2 + 1, h - margin),
              x0] = 0.8
        # an isolated probe emitter in this depth's third of the image
        py = h // 2
        px = int((li + 0.5) / len(depths) * (w - 2 * margin)) + margin
        layer[py - ks: py + ks, px - ks: px + ks] = 0.0
        layer[py, px] = 1.0
        probes.append((py, px, depth))
        lay4 = torch.from_numpy(layer)[None, :, :, None].to(lens.device)
        with torch.no_grad():
            for img, psf in ((img_coh, coh), (img_inc, inc)):
                img += uniform_psf_conv(lay4, torch.from_numpy(psf)[None].to(lens.device),
                                        ks)[0, :, :, 0].cpu().numpy()
    return img_coh, img_inc, probes


def run_image_mode(lens, args) -> dict:
    img_coh, img_inc, probes = interference_image(lens, args.depths, args.ks,
                                                  args.ps, args.M)
    vmax = max(img_coh.max(), img_inc.max())
    panel = np.concatenate([np.power(img_coh / vmax, 0.4), np.power(img_inc / vmax, 0.4),
                            _unit(img_coh - img_inc)], axis=1)
    path = f"{args.out}/interference_image.png"
    write_png(path, panel)
    np.savez(f"{args.out}/interference_image.npz", coherent=img_coh,
             incoherent=img_inc, probes=np.array(probes, np.float64))
    contrasts = []
    for py, px, depth in probes:
        r = args.ks // 2
        crop_c = img_coh[py - r: py + r + 1, px - r: px + r + 1]
        crop_i = img_inc[py - r: py + r + 1, px - r: px + r + 1]
        cc, ci = ring_contrast(radial_profile(crop_c)), ring_contrast(radial_profile(crop_i))
        contrasts.append((depth, cc, ci))
        print(f"probe @ depth {depth:9.1f} mm  in-image ring contrast: "
              f"coherent {cc:.3f} vs incoherent {ci:.3f}")
    print(f"Wrote {path}")
    return {"path": path, "probes": contrasts}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--lens", default="./lenses/rf50mm/lens_web.json")
    ap.add_argument("--depths", type=float, nargs="+",
                    default=(-1000.0, -1100.0, -1300.0))
    ap.add_argument("--ks", type=int, default=65, help="analysis window in fine pixels")
    ap.add_argument("--ps", type=float, default=0.0015,
                    help="analysis pixel pitch, mm (1.5 um default)")
    ap.add_argument("--M", type=int, default=512,
                    help="pupil quadrature grid (M*M rays per point)")
    ap.add_argument("--fnum", type=float, default=0.0,
                    help="optionally stop the lens down (0 keeps the native f/4)")
    ap.add_argument("--out", default="./results/coherent_demo_torch")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--image", action="store_true",
                    help="also render the multi-depth interference-imaging panel")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the demo; returns {"depths": {depth: {"coherent", "incoherent",
    "contrast": (coherent, incoherent), "profiles"}}, "image": ...}."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    os.makedirs(args.out, exist_ok=True)
    lens = Lens(args.lens, sensor_res=(512, 768), device=device)
    lens.refocus(-1000 + lens.d_sensor)   # 1 m focus, like the fit pipeline
    if args.fnum:
        lens.set_aperture(fnum=args.fnum)
    result = {"depths": {}, "image": run_image_mode(lens, args) if args.image else None}
    for depth in args.depths:
        coh, inc = coherent_psf_grid(lens, depth, grid=1, ks=args.ks, M=args.M, ps=args.ps)
        coh, inc = coh[0, 0].cpu().numpy(), inc[0, 0].cpu().numpy()
        tag = int(-depth)
        write_png(f"{args.out}/psf_panel_{tag}.png",
                  np.concatenate([_unit(np.log10(coh + 1e-4)),
                                  _unit(np.log10(inc + 1e-4))], axis=1))
        np.savez(f"{args.out}/psf_panel_{tag}.npz", coherent=coh, incoherent=inc)
        pc, pi = radial_profile(coh), radial_profile(inc)
        r_um = np.linspace(0, args.ps * 1e3 * args.ks / 2 * 1.414, len(pc))
        np.savez(f"{args.out}/profile_{tag}.npz", r_um=r_um, coherent=pc, incoherent=pi)
        contrast = (ring_contrast(pc), ring_contrast(pi))
        print(f"depth {depth:9.1f} mm  ring contrast: "
              f"coherent {contrast[0]:.3f} vs incoherent {contrast[1]:.3f}")
        result["depths"][depth] = {"coherent": coh, "incoherent": inc,
                                   "contrast": contrast, "profiles": (pc, pi)}
    print(f"Wrote panels to {args.out}")
    return result


if __name__ == "__main__":
    main()
